#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Build the CUDA kernels from ``conan_fgw_tpu_torch/csrc`` and print the
   build time, each kernel's registers and spills (a cfconv or K3 kernel
   that spills fails the run), and the card's name and power limit.
2. Kernel against plain version, on the card: K1 (cfconv forward), K2
   (cfconv backward: dx, dW1, db1, dW2, db2) and K3 (FGW couplings: T and
   the diverged flags) at the slice shape (G = S = 120 conformer graphs,
   N = 32, F = 128, 50 Gaussians) and at N = 64 with the 32-neighbour cap
   active; inputs are synthetic molecules and seeded tensors. K3 is also
   held on the barycenter's second outer iteration at N = 32 and 64 (dense
   C1, warm-started plans: its multi-iteration, freeze and rollback paths)
   and, alone, at N = 96 and N = 128, where it reads C1 and C2 through L2.
   A NaN planted
   in one solve's T0 must flag that solve as diverged, as the plain version
   does. Prints each one's max error against its tolerance, its time (CUDA
   events over eager back-to-back calls; for K3 also over CUDA-graph
   replays, ``graph_ms``, which leave out the wrapper's host time) and its
   bound, and K3's Sinkhorn iterations. K2 is launched twice on the same
   inputs and must give bit-identical results. Each kernel gets two bounds:
   its tensor-core products (K1/K2's filter MLP, K3's two N^3 products)
   over the TF32 tensor-core peak (the one in the result line), and
   everything over the f32 CUDA-core peak.
3. Training, the main path: ``fit`` on 48 synthetic molecules (K = 5
   conformers, B = 24, full width), stage 1 for 2 epochs, then stage 2 for
   2 epochs on the same model. Launch counts are zeroed just before and read
   just after; losses must be finite and every kernel must have run. Then
   three more stage-2 steps run under ``torch.profiler`` for the device
   time by kernel and the device's busy share.
4. Step parity: one stage-2 training step from identical weights through
   the kernels on the card and through the plain versions on the CPU.
5. The runner on the repo's ``data/sol250``: ``train/runner.py``'s
   ``main`` trains stage 1 (``config/schnet/sol250_5.yaml``) and then stage
   2 (``sol250_5_bc.yaml``), each for 2 epochs, on the card, with its
   checkpoints in a temporary directory. Launch counts are zeroed before
   each stage and read after it: K1 and K2 must grow in both, K3 in stage 2
   only, and no plain version may run. The stage-2 weights right after the
   warm start must equal stage 1's ``best`` file bit for bit; both stages
   must run steps in the N=32 and the N=64 bucket; every loss and
   ``test_rmse`` must be finite. A ``--resume`` run of stage 2 with 3
   epochs must start at epoch 2 and add one row, and ``predict.main`` on
   stage 2's ``best`` must give the test RMSE the runner reported, to 1e-6
   relative. Prints each stage's epoch times, steps per epoch, ms per step
   by bucket and ``fgw_diverged``.

Then it prints the per-kernel JSON line, the card line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

SEED = 0
B, K = 24, 5
CUTOFF, GAUSS, CAP, F = 10.0, 50, 32, 128
FGW_KW = dict(alpha=0.1, epsilon=0.1, pgd_iters=5, pgd_tol=1e-4, sinkhorn_iters=5,
              sinkhorn_thr=1e-2)
# published H100 SXM peaks: f32 on the CUDA cores, TF32 on the tensor cores
# (dense), HBM3 bandwidth
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
PEAK_BYTES = 3.35e12
# tolerances of the kernel checks
CFCONV_RTOL = 5e-4  # max |kernel - plain| / max |plain|, the TPU kernel's contract
FGW_ATOL = 2.5e-6   # plans, absolute; diverged flags exactly
# step parity (kernels on the card vs plain on the CPU): the loss and the
# global gradient norm to 1e-3 (the barycenter's bound); each parameter's
# gradient norm to 1e-2, with an absolute floor of 1e-6 of the global norm
# (the second GAT layer's attention vectors get gradients near 1e-8, where
# CPU and card round differently)
STEP_RTOL, PARAM_RTOL, PARAM_FLOOR = 1e-3, 1e-2, 1e-6

REPLACES = {
    "cfconv_fwd": "conan_fgw_tpu/ops/pallas/cfconv.py:223",
    "cfconv_bwd": "conan_fgw_tpu/ops/pallas/cfconv.py:146",
    "fgw_couplings": "conan_fgw_tpu/ops/pallas/fgw.py:362",
}
SOURCES = {
    "cfconv_fwd": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_bwd": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "fgw_couplings": "conan_fgw_tpu_torch/csrc/fgw.cu",
}


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds per call, by CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 10, replays: int = 5) -> float:
    """Mean milliseconds per call with the host out of the way: ``reps``
    calls captured in one CUDA graph, replayed ``replays`` times between
    CUDA events. ``fn`` must have been called before (warm-up)."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def bound(nbytes: float, flops: float, tc_flops: float = 0.0) -> tuple[float, str]:
    """Least ms for the work: the bytes over the memory rate against the
    operations, ``tc_flops`` of them over the TF32 tensor-core peak and the
    rest over the f32 CUDA-core peak."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, tc_flops / PEAK_TF32 + (flops - tc_flops) / PEAK_F32
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- phase 1
def phase_build():
    from conan_fgw_tpu_torch.ops.cuda import _build

    t0 = time.perf_counter()
    path, built_s = _build.build()
    _build.load_library()
    print(f"[build] {path.name}: nvcc {built_s:.1f} s, total {time.perf_counter() - t0:.1f} s")
    report = _build.BUILD_DIR / path.name.replace("libconan_kernels_", "ptxas_").replace(".so", ".txt")
    if report.exists():
        entry, spills = "", {}
        for line in report.read_text().splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print("[ptxas]", line.strip())
            if "Compiling entry" in line:
                entry = line.split("'")[1]
            elif "spill" in line and ("cfconv" in entry or "fgw_couplings_kernel" in entry):
                spills[entry] = sum(int(v) for v in re.findall(r"(\d+) bytes spill", line))
        print(f"[ptxas] spill bytes (stores + loads) by kernel: {spills}")
        require(any("fgw_couplings_kernel" in e for e in spills), "no ptxas report for K3")
        require(spills and not any(spills.values()), "a kernel spills registers")


# ---------------------------------------------------------------- phase 2
def packed_geometry(seed, n_mols, heavy, n_atoms, device):
    """Positions and masks of packed synthetic molecules: (B*K, N, 3), (B*K, N)."""
    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset

    recs = random_dataset(seed, n_mols, num_conformers=K, heavy_range=heavy, device=device)
    pb = pack_batch(recs, max_atoms=n_atoms, batch_size=n_mols).to(device)
    pos = pb.pos.reshape(-1, n_atoms, 3).contiguous()
    mask = pb.atom_mask.repeat_interleave(K, dim=0)
    return pos, mask


def count_edges(pos, mask, cap):
    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

    return int(radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, cap).sum())


def cfconv_params(G, N, gen, dev):
    """Seeded features, filter weights and cotangent: ``x, w1, b1, w2, b2, cot``."""
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cpu") * scale).to(dev)

    x = rnd(G, N, F)
    w1, b1 = rnd(GAUSS, F, scale=(6 / (GAUSS + F)) ** 0.5), rnd(F, scale=0.1)
    w2, b2 = rnd(F, F, scale=(3 / F) ** 0.5), rnd(F, scale=0.1)
    return x, w1, b1, w2, b2, rnd(G, N, F)


def check_cfconv(label, pos, mask, gen, rows):
    import torch

    from conan_fgw_tpu_torch.ops.cuda.cfconv import _cfconv_plain, cfconv_backward, cfconv_forward

    G, N, _ = pos.shape
    maskf = mask.to(torch.float32).contiguous()
    x, w1, b1, w2, b2, cot = cfconv_params(G, N, gen, pos.device)
    out_k = cfconv_forward(pos, maskf, x, w1, b1, w2, b2, CUTOFF, CAP)
    grads_k = cfconv_backward(pos, maskf, x, w1, b1, w2, b2, cot, CUTOFF, CAP)
    grads_again = cfconv_backward(pos, maskf, x, w1, b1, w2, b2, cot, CUTOFF, CAP)
    torch.cuda.synchronize()
    same = [n for n, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads_k, grads_again)
            if torch.equal(a, b)]
    print(f"[cfconv {label}] bwd twice on the same inputs: bit-identical {same}")
    require(len(same) == 5, f"cfconv {label} backward is not deterministic")
    leaves = [t.clone().requires_grad_(True) for t in (x, w1, b1, w2, b2)]
    out_p = _cfconv_plain(pos, maskf, *leaves, CUTOFF, GAUSS, CAP)
    grads_p = torch.autograd.grad(out_p, leaves, cot)
    torch.cuda.synchronize()

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    err_fwd = float((out_k - out_p.detach()).abs().max())
    rel_fwd = rel(out_k, out_p.detach())
    rels_bwd = {n: rel(a, b) for n, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads_k, grads_p)}
    err_bwd = max(float((a - b).abs().max()) for a, b in zip(grads_k, grads_p))
    print(f"[cfconv {label}] fwd max_abs_err {err_fwd:.3e} rel {rel_fwd:.3e} (tol {CFCONV_RTOL})")
    print(f"[cfconv {label}] bwd rel errors "
          + " ".join(f"{n} {v:.3e}" for n, v in rels_bwd.items()) + f" (tol {CFCONV_RTOL})")
    require(rel_fwd <= CFCONV_RTOL, f"cfconv {label} forward disagrees: {rel_fwd}")
    for n, v in rels_bwd.items():
        require(v <= CFCONV_RTOL, f"cfconv {label} backward {n} disagrees: {v}")

    edges = count_edges(pos, mask, CAP)
    fwd_ms = cuda_ms(lambda: cfconv_forward(pos, maskf, x, w1, b1, w2, b2, CUTOFF, CAP))
    bwd_ms = cuda_ms(lambda: cfconv_backward(pos, maskf, x, w1, b1, w2, b2, cot, CUTOFF, CAP))
    plain_fwd_ms = cuda_ms(lambda: _cfconv_plain(pos, maskf, x, w1, b1, w2, b2, CUTOFF, GAUSS, CAP))

    def plain_bwd():
        o = _cfconv_plain(pos, maskf, *leaves, CUTOFF, GAUSS, CAP)
        torch.autograd.grad(o, leaves, cot)

    plain_bwd_ms = cuda_ms(plain_bwd)
    w_bytes = 4 * (GAUSS * F + F * F + 2 * F)
    io_fwd = 4 * (G * N * 3 + G * N + 2 * G * N * F) + w_bytes
    io_bwd = 4 * (G * N * 3 + G * N + 3 * G * N * F) + 2 * w_bytes
    # the filter MLP's products (tensor cores in the kernels) and the rest
    mlp_fwd, mlp_bwd = edges * 2 * (GAUSS * F + F * F), edges * (4 * GAUSS * F + 6 * F * F)
    flops_fwd, flops_bwd = mlp_fwd + edges * 2 * F, mlp_bwd + edges * 4 * F
    print(f"[cfconv {label}] G={G} N={N} edges={edges}: fwd {fwd_ms:.4f} ms (plain {plain_fwd_ms:.4f}),"
          f" bwd {bwd_ms:.4f} ms (plain fwd+bwd {plain_bwd_ms:.4f})")
    for name, ms, plain_ms, err, io, flops, mlp in (
        ("cfconv_fwd", fwd_ms, plain_fwd_ms, err_fwd, io_fwd, flops_fwd, mlp_fwd),
        ("cfconv_bwd", bwd_ms, plain_bwd_ms, err_bwd, io_bwd, flops_bwd, mlp_bwd),
    ):
        tc, f32 = bound(io, flops, mlp), bound(io, flops)
        print(f"[cfconv {label}] {name}: bound {tc[0]:.5f} ms on the tensor cores"
              f" ({100 * tc[0] / ms:.1f}% reached), {f32[0]:.5f} ms in f32 on the CUDA cores"
              f" ({100 * f32[0] / ms:.1f}%); {flops / ms / 1e9:.1f} TFLOP/s")
        rows[name][label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=tc, bound_f32=f32)


def fgw_problem(pos, mask, gen):
    """K3's inputs at the barycenter's first outer iteration: ``(Ms, C1, C2,
    ps, qs, T0)`` over ``S = B*K`` solves, with the conformer graphs' 0/1
    neighbour structure as C2 and the first conformer's as C1, random
    features, uniform marginals and the product plan as T0. Also returns
    the features ``Ys (B, K, N, D)`` and structures ``Cs (B, K, N, N)``."""
    import torch

    from conan_fgw_tpu_torch.ops.fgw.barycenter import sqdist
    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

    dev = pos.device
    S, N, _ = pos.shape
    nbr = radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, CAP)
    Cs = nbr.transpose(-1, -2).to(torch.float32).reshape(-1, K, N, N)
    Ys = (torch.rand(S // K, K, N, F // 2, generator=gen) * 1.9 + 0.1).to(dev)
    p = torch.full((S // K, N), 1.0 / N, device=dev)
    Ms = sqdist(torch.zeros_like(Ys[:, 0])[:, None], Ys).reshape(S, N, N).contiguous()
    C1 = Cs[:, :1].expand(-1, K, N, N).reshape(S, N, N).contiguous()
    C2 = Cs.reshape(S, N, N).contiguous()
    ps = p[:, None].expand(-1, K, N).reshape(S, N).contiguous()
    qs = ps.clone()
    T0 = (ps[:, :, None] * qs[:, None, :]).contiguous()
    return (Ms, C1, C2, ps, qs, T0), Ys, Cs


def second_outer_inputs(args, Ys, Cs):
    """K3's inputs at the barycenter's second outer iteration: one plain
    coupling call on the first iteration's ``args``, then the feature and
    structure update of ``ops/fgw/barycenter.py`` (uniform weights and
    marginals): M from the updated features, the dense updated structure as
    C1, and the first iteration's plans as T0."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda.fgw import fgw_couplings_plain
    from conan_fgw_tpu_torch.ops.fgw.barycenter import sqdist

    _, _, C2, ps, qs, _ = args
    Bm, Km, N, _ = Cs.shape
    T, _ = fgw_couplings_plain(*args, **FGW_KW)
    T = T.reshape(Bm, Km, N, N)
    p = ps.reshape(Bm, Km, N)[:, 0]
    lambdas = torch.full((Bm, Km), 1.0 / Km, device=Ys.device)
    Y = (1.0 / p)[:, :, None] * torch.einsum("bk,bknm,bkmd->bnd", lambdas, T, Ys)
    Ms = sqdist(Y[:, None], Ys).reshape(-1, N, N).contiguous()
    C = torch.einsum("bk,bknm,bkmj,bklj->bnl", lambdas, T, Cs, T) / (p[:, :, None] * p[:, None, :])
    C1 = C[:, None].expand(Bm, Km, N, N).reshape(-1, N, N).contiguous()
    return Ms, C1, C2, ps, qs, T.reshape(-1, N, N).contiguous()


def fgw_bound(S, N, sk_run):
    """Least ms for ``S`` solves at ``N`` that ran ``sk_run`` Sinkhorn
    iterations in all, with the two products on the tensor cores (as the
    kernel runs them) and, second, all in f32 on the CUDA cores. Per solve
    and PGD step: two N^3 products (2 flops per FMA), then about 15
    operations per element for the gradient assembly, the first Sinkhorn
    iteration's marginal check and the candidate plan; per Sinkhorn
    iteration run, two log-sum-exp sweeps of 5 operations per element.
    Bytes: M, C1, C2, T0 and T, p and q, the two flags."""
    products = S * FGW_KW["pgd_iters"] * 4 * N**3
    flops = products + S * FGW_KW["pgd_iters"] * 15 * N * N + sk_run * 10 * N * N
    nbytes = 4 * (5 * S * N * N + 2 * S * N) + 2 * 4 * S
    return bound(nbytes, flops, products), bound(nbytes, flops)


def check_fgw(label, args, rows):
    """K3 against its plain version on one set of coupling inputs."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda.fgw import _launch, fgw_couplings_plain

    S, N, _ = args[0].shape
    T_k, div_k, sk_iters = _launch(*args, **FGW_KW)
    T_p, div_p = fgw_couplings_plain(*args, **FGW_KW)
    torch.cuda.synchronize()
    err = float((T_k - T_p).abs().max())
    flags_equal = bool(torch.equal(div_k, div_p))
    sk_run = int(sk_iters.sum())
    print(f"[fgw {label}] T max_abs_err {err:.3e} (tol {FGW_ATOL}); diverged kernel "
          f"{int(div_k.sum())} plain {int(div_p.sum())}; {sk_run} Sinkhorn iterations run of "
          f"{S * FGW_KW['pgd_iters'] * FGW_KW['sinkhorn_iters']} budgeted")
    require(err <= FGW_ATOL, f"fgw {label} plans disagree: {err}")
    require(flags_equal, f"fgw {label} diverged flags disagree")
    # eager calls leave the card waiting for the host between launches once
    # the kernel is shorter than the wrapper's host time: graph replays give
    # the kernel's own time beside the eager one
    ms = cuda_ms(lambda: _launch(*args, **FGW_KW))
    replay_ms = graph_ms(lambda: _launch(*args, **FGW_KW))
    plain_ms = cuda_ms(lambda: fgw_couplings_plain(*args, **FGW_KW), reps=3, warmup=1)
    tc, f32 = fgw_bound(S, N, sk_run)
    print(f"[fgw {label}] S={S} N={N}: kernel {ms:.4f} ms (eager calls; graph replays"
          f" {replay_ms:.4f} ms), plain {plain_ms:.4f} ms; bound {tc[0]:.5f} ms on the tensor"
          f" cores ({tc[1]}, {100 * tc[0] / ms:.1f}% reached, {100 * tc[0] / replay_ms:.1f}% of"
          f" the replays), {f32[0]:.5f} ms in f32 on the CUDA cores")
    rows["fgw_couplings"][label] = dict(max_abs_err=err, ms=ms, graph_ms=replay_ms, plain_ms=plain_ms,
                                        bound=tc, bound_f32=f32, sinkhorn_iters=sk_run)


def check_fgw_nan(args):
    """K3 against its plain version with a NaN (the bits 0x7fffffff, the
    card's own NaN) planted in solve 0's T0: the products must carry it, so
    that the solve rolls back and is flagged as diverged."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda.fgw import _launch, fgw_couplings_plain

    T0 = args[5].clone()
    T0.view(torch.int32)[0, 0, 0] = 0x7FFFFFFF
    args = (*args[:5], T0)
    T_k, div_k, _ = _launch(*args, **FGW_KW)
    T_p, div_p = fgw_couplings_plain(*args, **FGW_KW)
    torch.cuda.synchronize()
    same_nan = bool(torch.equal(T_k.isnan(), T_p.isnan()))
    err = float((T_k - T_p).nan_to_num(0.0).abs().max())
    print(f"[fgw N32-nan] NaN in solve 0's T0: diverged kernel {div_k.tolist()[:3]}"
          f" plain {div_p.tolist()[:3]} (first three); NaN positions equal {same_nan};"
          f" T max_abs_err elsewhere {err:.3e} (tol {FGW_ATOL})")
    require(int(div_p[0]) == 1, "the plain version does not flag the NaN solve")
    require(bool(torch.equal(div_k, div_p)), "fgw N32-nan diverged flags disagree")
    require(same_nan and err <= FGW_ATOL, "fgw N32-nan plans disagree")


# K3's checks: (label, heavy atoms per molecule, bucket). N=96 and N=128
# run K3 only; N=128 is the route that reads C1 and C2 through L2.
FGW_SHAPES = (("N32", (8, 13), 32), ("N64", (20, 26), 64), ("N96", (48, 54), 96),
              ("N128", (60, 66), 128))


def phase_kernels(device):
    import torch

    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

    rows = {name: {} for name in REPLACES}
    gen = torch.Generator().manual_seed(SEED)
    for label, heavy, n_atoms in FGW_SHAPES:
        pos, mask = packed_geometry(SEED + n_atoms, B, heavy, n_atoms, device)
        if n_atoms == 64:
            within = radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, None).sum(-1)
            require(bool((within > CAP).any()), "N=64 inputs never engage the neighbour cap")
        if n_atoms <= 64:
            check_cfconv(label, pos, mask, gen, rows)
        args, Ys, Cs = fgw_problem(pos, mask, gen)
        check_fgw(label, args, rows)
        if n_atoms == 32:
            check_fgw_nan(args)
        if n_atoms <= 64:
            check_fgw(f"{label}-outer2", second_outer_inputs(args, Ys, Cs), rows)
    return rows


# ---------------------------------------------------------------- phase 3
def phase_train(device, card):
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.train.loop import TrainSettings, fit

    train = random_dataset(SEED + 1, 2 * B, num_conformers=K, heavy_range=(8, 13), device=device)
    val = random_dataset(SEED + 2, B, num_conformers=K, heavy_range=(8, 13), device=device)
    model = ConanModel(seed=SEED, device=device)
    totals, stage_rows = {}, {}
    reset_launches()
    for stage, bary in ((1, False), (2, True)):
        before = dict(launches)
        settings = TrainSettings(num_epochs=2, batch_size=B, use_barycenter=bary, seed=SEED)
        res = fit(settings, train, val, model=model, device=device)
        model = res.model
        steps = sum(r["train_steps"] for r in res.history)
        grew = {k: launches[k] - before.get(k, 0) for k in REPLACES}
        for r in res.history:
            require(all(v == v and abs(v) != float("inf") for v in (r["train_loss"], r["val_loss"])),
                    f"stage {stage} epoch {r['epoch']} has a non-finite loss")
        require(grew["cfconv_fwd"] >= 3 * steps, f"stage {stage}: K1 launched {grew['cfconv_fwd']}")
        require(grew["cfconv_bwd"] >= 3 * steps, f"stage {stage}: K2 launched {grew['cfconv_bwd']}")
        if bary:
            require(grew["fgw_couplings"] >= 5 * steps, f"stage 2: K3 launched {grew['fgw_couplings']}")
        last = res.history[-1]  # the second epoch: kernels built, caches warm
        step_ms = 1e3 * last["train_s"] / last["train_steps"]
        gps = B * K * last["train_steps"] / last["train_s"]
        print(f"[train stage {stage}] {steps} steps, losses "
              + ", ".join(f"{r['train_loss']:.4f}/{r['val_loss']:.4f}" for r in res.history)
              + f"; epoch 2: {step_ms:.2f} ms/step, {gps:.1f} graphs/s on {card}; launches {grew}")
        stage_rows[stage] = dict(step_ms=step_ms, graphs_per_s=gps, steps=steps)
    totals = {k: launches[k] for k in REPLACES}
    print(f"[train] main-path launches {totals}")
    for k, v in totals.items():
        require(v > 0, f"kernel {k} was never launched on the main path")
    return model, totals, stage_rows


def profile_stage2(model, device):
    """Device time by kernel over three stage-2 training steps (after the
    main path's counts were read), and the device's busy share of the wall
    time. Prints "not measured" where the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.train.loop import TrainSettings, make_optimizer, train_step

    recs = random_dataset(SEED + 4, B, num_conformers=K, heavy_range=(8, 10), device=device)
    batch = pack_batch(recs, max_atoms=32, batch_size=B).to(device)
    settings = TrainSettings(batch_size=B, use_barycenter=True)
    opt = make_optimizer(model, settings)
    train_step(model, opt, batch, settings)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            train_step(model, opt, batch, settings)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side kernels and copies only: the CPU ops that launched them, and
    # annotated regions on the device's timeline (the optimizer's step), span
    # the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
              and not getattr(e, "is_user_annotation", False)]
    busy_us = sum(e.self_device_time_total for e in events)
    if not events:
        print("[profile] device time: not measured (the profiler saw no device activity)")
        return
    print(f"[profile] stage-2 step: wall {wall_us / 3e3:.3f} ms, device busy {busy_us / 3e3:.3f} ms"
          f" ({100 * busy_us / wall_us:.1f}% busy), {sum(e.count for e in events) // 3} kernels/step")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        print(f"[profile]   {e.self_device_time_total / 3e3:8.3f} ms/step  x{e.count // 3:<4d} {e.key[:70]}")


# ---------------------------------------------------------------- phase 4
def phase_parity(model, device):
    import torch

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.train.loop import masked_mse

    recs = random_dataset(SEED + 3, B, num_conformers=K, heavy_range=(8, 10), device=device)
    pb = pack_batch(recs, max_atoms=32, batch_size=B)
    results = {}
    for name, m, dev in (("kernel", model, device), ("plain", copy.deepcopy(model).to("cpu"), "cpu")):
        m.zero_grad(set_to_none=True)
        batch = pb.to(dev)
        pred, _ = m(batch, use_barycenter=True)
        loss = masked_mse(pred, batch)
        loss.backward()
        norms = {k: float(p.grad.norm()) for k, p in m.named_parameters() if p.grad is not None}
        results[name] = (float(loss.detach()), norms)
    (lk, nk), (lp, np_) = results["kernel"], results["plain"]
    gk = sum(v * v for v in nk.values()) ** 0.5
    gp = sum(v * v for v in np_.values()) ** 0.5
    rel = {k: abs(nk[k] - np_[k]) / max(np_[k], PARAM_FLOOR * gp) for k in np_}
    worst = max(rel.values())
    for k in sorted(rel, key=rel.get, reverse=True)[:5]:
        print(f"[parity] {k}: grad norm kernel {nk[k]:.6e} plain {np_[k]:.6e} rel {rel[k]:.3e}")
    print(f"[parity] loss kernel {lk:.6f} plain {lp:.6f}; grad norm kernel {gk:.6f} plain {gp:.6f};"
          f" worst parameter grad-norm rel err {worst:.3e} (tol {STEP_RTOL}, {PARAM_RTOL})")
    require(set(nk) == set(np_), "kernel and plain paths differ in which parameters get gradients")
    require(abs(lk - lp) <= STEP_RTOL * abs(lp), "stage-2 loss disagrees")
    require(abs(gk - gp) <= STEP_RTOL * gp, "stage-2 gradient norm disagrees")
    require(worst <= PARAM_RTOL, "a parameter's gradient norm disagrees")
    model.zero_grad(set_to_none=True)


# ---------------------------------------------------------------- phase 5
RUNNER_STAGES = (("conan_fgw_pre", "config/schnet/sol250_5.yaml"),
                 ("conan_fgw", "config/schnet/sol250_5_bc.yaml"))
RUNNER_EPOCHS = 2
PREDICT_RTOL = 1e-6


def config_copy(src: str, out_dir: Path, epochs: int) -> str:
    """A copy of the YAML config ``src`` with ``num_epochs: epochs``."""
    text, n = re.subn(r"(?m)^num_epochs: \d+$", f"num_epochs: {epochs}", Path(src).read_text())
    require(n == 1, f"{src}: no num_epochs line to set")
    path = out_dir / f"{Path(src).stem}_{epochs}ep.yaml"
    path.write_text(text)
    return str(path)


@contextlib.contextmanager
def runner_spies():
    """Count calls of the kernels' plain versions, and record the weights
    each checkpoint restore leaves in the model: ``(plain_calls, restores)``,
    ``restores`` a list of ``(directory, which, state_dict on the host)``."""
    from conan_fgw_tpu_torch.ops.cuda import cfconv as cfconv_mod
    from conan_fgw_tpu_torch.ops.cuda import fgw as fgw_mod
    from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer

    plain_calls, restores = collections.Counter(), []
    saved = [(cfconv_mod, "_cfconv_plain"), (fgw_mod, "fgw_couplings_plain"),
             (RunCheckpointer, "restore_params")]
    originals = [getattr(owner, name) for owner, name in saved]

    def counted(name, fn):
        def call(*args, **kwargs):
            plain_calls[name] += 1
            return fn(*args, **kwargs)
        return call

    def restore_params(self, model, which="best"):
        out = originals[2](self, model, which)
        restores.append((self.directory, which,
                         {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}))
        return out

    cfconv_mod._cfconv_plain = counted("cfconv", originals[0])
    fgw_mod.fgw_couplings_plain = counted("fgw", originals[1])
    RunCheckpointer.restore_params = restore_params
    try:
        yield plain_calls, restores
    finally:
        for (owner, name), fn in zip(saved, originals):
            setattr(owner, name, fn)


def run_main(main, argv):
    """``main(argv)`` with its printed output kept off this script's."""
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def runner_stage(label, stage, cfg, ctx, *extra, start=0):
    """One runner run with the launch counts zeroed before it; checks and
    prints it, returns ``(summary, history, launches)``. ``ctx`` holds the
    common arguments, the temporary directory, the plain-call counts, the
    device and the card line; ``start`` is the first epoch this run trains."""
    import numpy as np
    import torch

    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.train import runner

    common, tmp, plain_calls, device, card = ctx
    reset_launches()
    t0 = time.perf_counter()
    summary = run_main(runner.main, ["--config", cfg, "--stage", stage, *common, *extra])
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grew = {k: launches[k] for k in REPLACES}
    run_dir = tmp / "models" / "smoke" / "0" / f"run_{stage}:0"
    history = json.loads((run_dir / "last_state.meta.json").read_text())["loop"]["history"]
    steps = sum(r["train_steps"] for r in history)
    require(not plain_calls, f"runner {label}: plain versions ran: {dict(plain_calls)}")
    for r in history:
        require(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]),
                f"runner {label} epoch {r['epoch']} has a non-finite loss")
        require(r.get("steps_n32", 0) > 0 and r.get("steps_n64", 0) > 0,
                f"runner {label} epoch {r['epoch']} did not run both buckets: {r}")
    require(np.isfinite(summary["test_rmse"]["mean"]), f"runner {label}: test_rmse not finite")
    new_steps = sum(r["train_steps"] for r in history if r["epoch"] >= start)
    require(grew["cfconv_fwd"] >= 3 * new_steps, f"runner {label}: K1 launched {grew['cfconv_fwd']}")
    require(grew["cfconv_bwd"] >= 3 * new_steps, f"runner {label}: K2 launched {grew['cfconv_bwd']}")
    if stage == "conan_fgw":
        require(grew["fgw_couplings"] >= 5 * new_steps, f"runner {label}: K3 launched "
                f"{grew['fgw_couplings']}")
    else:
        require(grew["fgw_couplings"] == 0, f"runner {label}: K3 launched in stage 1")
    for r in history:
        n64 = r["steps_n64"] / r["train_steps"]
        print(f"[runner {label}] epoch {r['epoch']}: {r['epoch_time_s']:.3f} s, {r['train_steps']}"
              f" steps ({r['steps_n32']} at N=32, {r['steps_n64']} at N=64: {100 * n64:.1f}%),"
              f" {1e3 * r['train_s_n32'] / r['steps_n32']:.2f} ms/step at N=32,"
              f" {1e3 * r['train_s_n64'] / r['steps_n64']:.2f} ms/step at N=64,"
              f" fgw_diverged {r['fgw_diverged']}, train_loss {r['train_loss']:.5f},"
              f" val_mse {r['val_mse']:.5f}")
    print(f"[runner {label}] {steps} steps in all, {new_steps} in this run: {wall:.1f} s wall with"
          f" data and test on {card}; test_rmse {summary['test_rmse']['mean']:.6f}; launches {grew}")
    return summary, history, grew


def phase_runner(device, card):
    """Phase 5: the runner's two stages, a resume and predict on sol250."""
    import numpy as np

    from conan_fgw_tpu_torch.train import predict

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runner_") as name, \
            runner_spies() as (plain_calls, restores):
        tmp = Path(name)
        common = ["--data_root", ".", "--run_name", "smoke", "--run_id", "0",
                  "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                  "--metrics_dir", str(tmp / "metrics"), "--device", device]
        ctx = (common, tmp, plain_calls, device, card)
        cfgs, totals = {}, collections.Counter()
        for stage, src in RUNNER_STAGES:
            first_restore = len(restores)  # stage 1 restores its own best for its test
            cfgs[stage] = config_copy(src, tmp, RUNNER_EPOCHS)
            label = "stage 1" if stage == "conan_fgw_pre" else "stage 2"
            summary, history, grew = runner_stage(label, stage, cfgs[stage], ctx)
            totals.update(grew)
            last = history[-1]
            out[label] = dict(
                epoch_s=[r["epoch_time_s"] for r in history],
                steps=last["train_steps"], steps_n64=last["steps_n64"],
                ms_n32=1e3 * last["train_s_n32"] / last["steps_n32"],
                ms_n64=1e3 * last["train_s_n64"] / last["steps_n64"],
                fgw_diverged=[r["fgw_diverged"] for r in history],
                test_rmse=summary["test_rmse"]["mean"])

        pre_dir = tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0"
        warm = [s for d, which, s in restores[first_restore:]
                if Path(d) == pre_dir and which == "best"]
        require(len(warm) == 1, f"stage 2 restored stage 1's best {len(warm)} times")
        with np.load(pre_dir / "best.npz") as best:
            differ = [k for k, v in warm[0].items()
                      if not np.array_equal(best[k].view(np.uint32), v.numpy().view(np.uint32))]
            require(set(best.files) == set(warm[0]), "stage 1's best and the model differ in keys")
        print(f"[runner] warm start: {len(warm[0])} tensors equal stage 1's best bit for bit,"
              f" {len(differ)} differ")
        require(not differ, f"the warm start differs from stage 1's best in {differ[:3]}")

        metrics_csv = tmp / "metrics" / "smoke" / "0" / "run_conan_fgw:0" / "metrics.csv"
        before = metrics_csv.read_text().splitlines()
        resume_cfg = config_copy(RUNNER_STAGES[1][1], tmp, RUNNER_EPOCHS + 1)
        summary, history, _ = runner_stage("stage 2 resume", "conan_fgw", resume_cfg, ctx,
                                           "--resume", start=RUNNER_EPOCHS)
        after = metrics_csv.read_text().splitlines()
        require([r["epoch"] for r in history] == list(range(RUNNER_EPOCHS + 1)),
                f"resume history epochs {[r['epoch'] for r in history]}")
        require(after[: len(before)] == before and len(after) == len(before) + 1,
                f"resume: metrics.csv went from {len(before)} to {len(after)} rows, or its"
                " earlier rows changed")
        print(f"[runner] resume: started at epoch {RUNNER_EPOCHS}, metrics.csv {len(before)} ->"
              f" {len(after)} rows, the earlier ones unchanged")

        stage2_dir = tmp / "models" / "smoke" / "0" / "run_conan_fgw:0"
        reported = summary["test_rmse"]["mean"]
        rmse = run_main(predict.main, ["--config", resume_cfg, "--checkpoint", str(stage2_dir),
                                       "--data_root", ".", "--device", device,
                                       "--out", str(tmp / "preds.csv")])
        rel = abs(rmse - reported) / abs(reported)
        print(f"[runner] predict on stage 2's best: test RMSE {rmse!r}, the runner's {reported!r},"
              f" rel {rel:.3e} (tol {PREDICT_RTOL})")
        require(rel <= PREDICT_RTOL, "predict's test RMSE disagrees with the runner's")
        require(not plain_calls, f"plain versions ran: {dict(plain_calls)}")
    out["launches"] = dict(totals)
    return out


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import conan_fgw_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: run from the root of a checkout of the repository", file=sys.stderr)
        return 2
    from conan_fgw_tpu_torch.device import pin_full_f32

    pin_full_f32()
    t0 = time.perf_counter()
    device = "cuda"
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    phase_build()
    rows = phase_kernels(device)
    model, totals, stage_rows = phase_train(device, card)
    profile_stage2(model, device)
    phase_parity(model, device)
    stage_rows["runner"] = phase_runner(device, card)

    def extra(row):
        out = {"bound_f32_ms": row["bound_f32"][0]} if "bound_f32" in row else {}
        out.update({k: row[k] for k in ("graph_ms", "sinkhorn_iters") if k in row})
        return out

    kernels = []
    for name in REPLACES:
        r = rows[name]["N32"]
        bound_ms, bound_by = r["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": totals[name], "runner_launches": stage_rows["runner"]["launches"][name],
            "max_abs_err": max(rows[name][lab]["max_abs_err"] for lab in rows[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, **extra(r),
        })
        for lab, other in rows[name].items():
            if lab != "N32":
                kernels[-1][lab.lower()] = dict(
                    ms=other["ms"], plain_ms=other["plain_ms"], bound_ms=other["bound"][0],
                    **extra(other))
    print(f"[done] {time.perf_counter() - t0:.1f} s; stage 2 {stage_rows[2]['step_ms']:.2f} ms/step")
    print(json.dumps({"kernels": kernels, "train": stage_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
