#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. Build the CUDA kernels from ``conan_fgw_tpu_torch/csrc`` and print the
   build time, each kernel's registers and spills (a cfconv or K3 kernel
   that spills fails the run), and the card's name and power limit; build
   the native batch packer (``conan_fgw_tpu_torch/native/packer.cpp``).
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
   does. K3 is also held on zero-mass marginals (``bary_pad_mode: masked``)
   and on the deep budget of ``config/schnet/sol1k_5_bc_deep.yaml``
   (epsilon 0.05, 10 PGD x 10 Sinkhorn), both at N = 32. K1 and K2 are
   also held at the classification width (256 filters, 10 Gaussians; the
   kernels' second instantiation, counted as ``cfconv_fwd_f256`` and
   ``cfconv_bwd_f256``) on G = 90 graphs (sol1k_class's 18 molecules x 5
   conformers) at N = 32 and N = 64 with the cap active. Prints each one's max error against its tolerance, its time (CUDA
   events over eager back-to-back calls; for K3 also over CUDA-graph
   replays, ``graph_ms``, which leave out the wrapper's host time) and its
   bound, and K3's Sinkhorn iterations. K2 is launched twice on the same
   inputs and must give bit-identical results. Each kernel gets two bounds:
   its tensor-core products (K1/K2's filter MLP, K3's two N^3 products)
   over the TF32 tensor-core peak (the one in the result line), and
   everything over the f32 CUDA-core peak.
3. Training, the main path: ``fit`` on 48 synthetic molecules (K = 5
   conformers, B = 24, full width), stage 1 for 2 epochs, then stage 2 for
   2 epochs on the same model, its steps as CUDA graphs (``fit`` always
   steps through ``train/graphs.py``; each stage must capture a train and
   an eval graph). Launch counts are zeroed just before and read just
   after; losses must be finite and every kernel must have run. Then three
   more stage-2 steps run eagerly under ``torch.profiler`` for the device
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
   by bucket and ``fgw_diverged``. The steps run as CUDA graphs
   (``train/graphs.py``): each run must capture train and eval graphs, and
   the launch counts must be the eager path's (K2 three a train step;
   three K1 and five K3 a forward). Their batches come through the host
   pipeline: every one packed natively on the prefetch thread into a
   pinned slot and copied from it without waiting, none packed by numpy or
   copied from pageable memory.
6. The classification path on the repo's ``data/sol1k_class``: the
   runner's ``main`` trains stage 1 (``config/schnet/sol1k_class_5.yaml``)
   and then stage 2 (``sol1k_class_5_bc.yaml``), each for 2 epochs, at the
   full classification width (hidden 512, 256 filters, 10 Gaussians): the
   F=256 K1/K2 launches must grow in both stages and K3's in stage 2 only,
   no other width's kernel and no plain version may run, both buckets must
   run, the warm start must be bit-exact, losses finite, ``val_auroc`` and
   ``test_auroc`` in [0, 1], ``best`` at the epoch of the highest
   ``val_auroc``, and the AUROC of ``predict.main``'s probabilities must
   equal the runner's ``test_auroc`` to 1e-6. These steps run as CUDA
   graphs too, with phase 5's checks on captures and launch counts.
8. CUDA graphs at full width: the flagship regression model in stage 1 and
   stage 2 at N=32 and N=64 (B=24, K=5) and the classification model in
   stage 2 at N=32 (B=18). Each runs 20 synthetic batches eagerly and
   through ``StepGraphs`` from identical weights, with the lr halved by
   ``set_learning_rate`` after 10 steps: per-step losses and final weights
   must agree to 1e-5 relative (bit-identity is printed), the launch counts
   must be equal, and the eval graph's predictions must equal eager eval's
   to 1e-6. The eager steps take pre-packed batches, the graphed ones the
   host pipeline's (prefetch, native packing into pinned slots,
   non-blocking copies). Then 50 warmed steps a turn give ms per step and
   graphs/s by host clock ending in a synchronise, in turns eager,
   graphed, pipelined, serial and back: eager and graphed steps on
   pre-packed batches copied from pageable memory, pipelined ones through
   the host pipeline, serial ones packed by numpy on the main thread and
   copied from pageable memory (``fit(prefetch=False, native=False)``'s
   path). One more pipelined turn splits its host time per step: waiting
   on the prefetch queue, the copy, waiting for a slot's earlier copy, and
   the replay with the rest; and the prefetch thread's native packing per
   batch (its foreign call apart), beside numpy packing. A sixth case is
   stage 1 at N=32 with sol250's stage-1 batch of 96. Stage 2 also profiles three graphed steps: busy share,
   kernels per step, and the K1/K2/K3 executions the profiler sees, which
   must equal the launch counts.
9. The host pipeline: the native packer against the numpy one, byte for
   byte, over every batch of ``data/sol250`` (batches 96 and 24) and
   ``data/sol1k_class`` (18), every split and bucket, also into a reused
   pinned buffer; then sol250's stage 1 through ``fit`` for 2 epochs from
   the same seeded model, through the pipeline and with ``prefetch=False,
   native=False``: losses and weights must agree bit for bit.
10. The ViSNet and DimeNet paths (``config/visnet/sol250_5*``,
   ``config/dimenet/sol250_5*``; neither launches K1 or K2). K3 against its
   plain version at DimeNet's alpha 0.5 on a fixed structure (the first
   conformer's cutoff-5 graph as C1 at every outer iteration), at N = 32
   and N = 64, first and second outer iteration, within phase 2's gate.
   Then per backbone: three eager steps of the runner's model at each
   config's batch on sol250's molecules of each bucket, stage 1 and 2, for
   ms per step and the peak memory; the runner's ``main`` for both stages
   (2 epochs each) with phase 5's checks, except that K1 and K2 must not
   launch and K3 must launch five times a stage-2 forward, and the peak
   memory of each stage; ``predict.main`` on stage 2's ``best`` against the
   runner's test RMSE; one stage-2 step on the card against the CPU (phase
   4's gates) at the stage-2 config's batch; and phase 8's case for stage 2
   at N = 32 at that batch (24 for ViSNet, 16 for DimeNet), with its timed
   turns and the profile of three graphed steps.
7. Reproducibility: two fresh processes run the same seeded stage-1 and
   stage-2 steps on ``data/sol250``, and stage-2 steps of the seeded ViSNet
   and DimeNet models, eagerly and then through CUDA graphs fed by the host
   pipeline, and must give bit-identical batches, losses, gradients and weights; a
   third runs the eager steps under
   ``torch.use_deterministic_algorithms(True)`` (with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``) and must finish. It runs last.

Then it prints the per-kernel JSON line (every kernel, each width and
shape held), the card line and, last, ``{"ok": true, "device": {...}}``.

Launch counts under CUDA graphs: a kernel's wrapper counts once while a
graph is captured and does not run when the graph is replayed, so each
graph adds its capture's counts once per later replay
(``train/graphs.py::LaunchReplays``). The counts of phases 3, 5 and 6
(``launches``, ``runner_launches``, ``classification_launches``) are
derived so; phase 8 requires the profiler's count of kernel executions
over graphed steps to equal them.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import functools
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
# the deep budget of config/schnet/sol1k_5_bc_deep.yaml: epsilon 0.05, 10 PGD
# steps of 10 Sinkhorn iterations
FGW_DEEP_KW = dict(FGW_KW, epsilon=0.05, pgd_iters=10, sinkhorn_iters=10)
# the classification model's cfconv: 256 filters, 10 Gaussians, and
# sol1k_class's batch of 18 molecules of K = 5 conformers (G = 90 graphs)
F_CLS, GAUSS_CLS, B_CLS = 256, 10, 18
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
    "cfconv_fwd_f256": "conan_fgw_tpu/ops/pallas/cfconv.py:223",
    "cfconv_bwd_f256": "conan_fgw_tpu/ops/pallas/cfconv.py:146",
}
SOURCES = {
    "cfconv_fwd": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_bwd": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "fgw_couplings": "conan_fgw_tpu_torch/csrc/fgw.cu",
    "cfconv_fwd_f256": "conan_fgw_tpu_torch/csrc/cfconv.cu",
    "cfconv_bwd_f256": "conan_fgw_tpu_torch/csrc/cfconv.cu",
}
# the kernels of the regression path (phases 3 and 5) and of the
# classification path (phase 6)
REGRESSION = ("cfconv_fwd", "cfconv_bwd", "fgw_couplings")
CLASSIFICATION = ("cfconv_fwd_f256", "cfconv_bwd_f256", "fgw_couplings")


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
    from conan_fgw_tpu_torch.data import native

    t0 = time.perf_counter()
    packer = native.build()
    native.load_library()
    print(f"[build] {packer.name}: the native packer, g++ and load {time.perf_counter() - t0:.1f} s")
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


def cfconv_params(G, N, gen, dev, F=F, GAUSS=GAUSS):
    """Seeded features, filter weights and cotangent: ``x, w1, b1, w2, b2, cot``."""
    import torch

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device="cpu") * scale).to(dev)

    x = rnd(G, N, F)
    w1, b1 = rnd(GAUSS, F, scale=(6 / (GAUSS + F)) ** 0.5), rnd(F, scale=0.1)
    w2, b2 = rnd(F, F, scale=(3 / F) ** 0.5), rnd(F, scale=0.1)
    return x, w1, b1, w2, b2, rnd(G, N, F)


def check_cfconv(label, pos, mask, gen, rows, F=F, GAUSS=GAUSS):
    """K1 and K2 against the plain version at one shape; ``F``/``GAUSS``
    pick the width (the classification model's is 256 filters and 10
    Gaussians), whose rows go under its launch-count names."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda.cfconv import (
        _cfconv_plain,
        cfconv_backward,
        cfconv_forward,
        kernel_name,
    )

    G, N, _ = pos.shape
    maskf = mask.to(torch.float32).contiguous()
    x, w1, b1, w2, b2, cot = cfconv_params(G, N, gen, pos.device, F, GAUSS)
    out_k = cfconv_forward(pos, maskf, x, w1, b1, w2, b2, CUTOFF, CAP)
    grads_k = cfconv_backward(pos, maskf, x, w1, b1, w2, b2, cot, CUTOFF, CAP)
    grads_again = cfconv_backward(pos, maskf, x, w1, b1, w2, b2, cot, CUTOFF, CAP)
    torch.cuda.synchronize()
    same = [n for n, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads_k, grads_again)
            if torch.equal(a, b)]
    print(f"[cfconv {label} F{F}] bwd twice on the same inputs: bit-identical {same}")
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
    print(f"[cfconv {label} F{F}] fwd max_abs_err {err_fwd:.3e} rel {rel_fwd:.3e} (tol {CFCONV_RTOL})")
    print(f"[cfconv {label} F{F}] bwd rel errors "
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
    print(f"[cfconv {label} F{F}] G={G} N={N} F={F} Gs={GAUSS} edges={edges}: fwd {fwd_ms:.4f} ms"
          f" (plain {plain_fwd_ms:.4f}), bwd {bwd_ms:.4f} ms (plain fwd+bwd {plain_bwd_ms:.4f})")
    for name, ms, plain_ms, err, io, flops, mlp in (
        (kernel_name("cfconv_fwd", F), fwd_ms, plain_fwd_ms, err_fwd, io_fwd, flops_fwd, mlp_fwd),
        (kernel_name("cfconv_bwd", F), bwd_ms, plain_bwd_ms, err_bwd, io_bwd, flops_bwd, mlp_bwd),
    ):
        tc, f32 = bound(io, flops, mlp), bound(io, flops)
        print(f"[cfconv {label} F{F}] {name}: bound {tc[0]:.5f} ms on the tensor cores"
              f" ({100 * tc[0] / ms:.1f}% reached), {f32[0]:.5f} ms in f32 on the CUDA cores"
              f" ({100 * f32[0] / ms:.1f}%); {flops / ms / 1e9:.1f} TFLOP/s")
        rows[name][label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound=tc, bound_f32=f32)


def fgw_problem(pos, mask, gen, masked=False, cutoff=CUTOFF):
    """K3's inputs at the barycenter's first outer iteration: ``(Ms, C1, C2,
    ps, qs, T0)`` over ``S = B*K`` solves, with the conformer graphs' 0/1
    neighbour structure as C2 and the first conformer's as C1, random
    features, uniform marginals and the product plan as T0. ``masked``
    gives the marginals and features of ``bary_pad_mode: masked``
    (``models/heads.py``): mass 1/n on a molecule's n atoms and none on its
    padding rows, whose features are 0. Also returns the features ``Ys (B,
    K, N, D)`` and structures ``Cs (B, K, N, N)``."""
    import torch

    from conan_fgw_tpu_torch.ops.fgw.barycenter import sqdist
    from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

    dev = pos.device
    S, N, _ = pos.shape
    nbr = radius_graph_mask(pairwise_distances(pos), mask, cutoff, CAP)
    Cs = nbr.transpose(-1, -2).to(torch.float32).reshape(-1, K, N, N)
    Ys = (torch.rand(S // K, K, N, F // 2, generator=gen) * 1.9 + 0.1).to(dev)
    p = torch.full((S // K, N), 1.0 / N, device=dev)
    if masked:
        atoms = mask.reshape(-1, K, N)[:, 0].to(torch.float32)
        p = atoms / atoms.sum(-1, keepdim=True).clamp(min=1.0)
        Ys = Ys * atoms[:, None, :, None]
    Ms = sqdist(torch.zeros_like(Ys[:, 0])[:, None], Ys).reshape(S, N, N).contiguous()
    C1 = Cs[:, :1].expand(-1, K, N, N).reshape(S, N, N).contiguous()
    C2 = Cs.reshape(S, N, N).contiguous()
    ps = p[:, None].expand(-1, K, N).reshape(S, N).contiguous()
    qs = ps.clone()
    T0 = (ps[:, :, None] * qs[:, None, :]).contiguous()
    return (Ms, C1, C2, ps, qs, T0), Ys, Cs


def second_outer_inputs(args, Ys, Cs, kw=FGW_KW, fixed_structure=False):
    """K3's inputs at the barycenter's second outer iteration: one plain
    coupling call on the first iteration's ``args``, then the feature and
    structure update of ``ops/fgw/barycenter.py`` (uniform weights and
    marginals): M from the updated features, the dense updated structure as
    C1 (with ``fixed_structure``, the first iteration's C1 again), and the
    first iteration's plans as T0."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda.fgw import fgw_couplings_plain
    from conan_fgw_tpu_torch.ops.fgw.barycenter import sqdist

    _, _, C2, ps, qs, _ = args
    Bm, Km, N, _ = Cs.shape
    T, _ = fgw_couplings_plain(*args, **kw)
    T = T.reshape(Bm, Km, N, N)
    p = ps.reshape(Bm, Km, N)[:, 0]
    lambdas = torch.full((Bm, Km), 1.0 / Km, device=Ys.device)
    Y = (1.0 / p)[:, :, None] * torch.einsum("bk,bknm,bkmd->bnd", lambdas, T, Ys)
    Ms = sqdist(Y[:, None], Ys).reshape(-1, N, N).contiguous()
    if fixed_structure:
        C1 = args[1]
    else:
        C = torch.einsum("bk,bknm,bkmj,bklj->bnl", lambdas, T, Cs, T) / (p[:, :, None] * p[:, None, :])
        C1 = C[:, None].expand(Bm, Km, N, N).reshape(-1, N, N).contiguous()
    return Ms, C1, C2, ps, qs, T.reshape(-1, N, N).contiguous()


def fgw_bound(S, N, sk_run, kw=FGW_KW):
    """Least ms for ``S`` solves at ``N`` that ran ``sk_run`` Sinkhorn
    iterations in all, with the two products on the tensor cores (as the
    kernel runs them) and, second, all in f32 on the CUDA cores. Per solve
    and PGD step: two N^3 products (2 flops per FMA), then about 15
    operations per element for the gradient assembly, the first Sinkhorn
    iteration's marginal check and the candidate plan; per Sinkhorn
    iteration run, two log-sum-exp sweeps of 5 operations per element.
    Bytes: M, C1, C2, T0 and T, p and q, the two flags."""
    products = S * kw["pgd_iters"] * 4 * N**3
    flops = products + S * kw["pgd_iters"] * 15 * N * N + sk_run * 10 * N * N
    nbytes = 4 * (5 * S * N * N + 2 * S * N) + 2 * 4 * S
    return bound(nbytes, flops, products), bound(nbytes, flops)


def check_fgw(label, args, rows, kw=FGW_KW):
    """K3 against its plain version on one set of coupling inputs, with the
    solver budget ``kw``."""
    import torch

    from conan_fgw_tpu_torch.ops.cuda.fgw import _launch, fgw_couplings_plain

    S, N, _ = args[0].shape
    T_k, div_k, sk_iters = _launch(*args, **kw)
    T_p, div_p = fgw_couplings_plain(*args, **kw)
    torch.cuda.synchronize()
    err = float((T_k - T_p).abs().max())
    flags_equal = bool(torch.equal(div_k, div_p))
    sk_run = int(sk_iters.sum())
    print(f"[fgw {label}] T max_abs_err {err:.3e} (tol {FGW_ATOL}); diverged kernel "
          f"{int(div_k.sum())} plain {int(div_p.sum())}; {sk_run} Sinkhorn iterations run of "
          f"{S * kw['pgd_iters'] * kw['sinkhorn_iters']} budgeted")
    require(err <= FGW_ATOL, f"fgw {label} plans disagree: {err}")
    require(flags_equal, f"fgw {label} diverged flags disagree")
    # eager calls leave the card waiting for the host between launches once
    # the kernel is shorter than the wrapper's host time: graph replays give
    # the kernel's own time beside the eager one
    ms = cuda_ms(lambda: _launch(*args, **kw))
    replay_ms = graph_ms(lambda: _launch(*args, **kw))
    plain_ms = cuda_ms(lambda: fgw_couplings_plain(*args, **kw), reps=3, warmup=1)
    tc, f32 = fgw_bound(S, N, sk_run, kw)
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
        if n_atoms == 32:
            # the two inputs the runner accepts beyond the default: zero-mass
            # marginals (bary_pad_mode: masked) and the deep budget
            check_fgw(f"{label}-masked", fgw_problem(pos, mask, gen, masked=True)[0], rows)
            check_fgw(f"{label}-deep", args, rows, FGW_DEEP_KW)
    # the classification width at sol1k_class's batch, N=64 with the cap active
    for label, heavy, n_atoms in FGW_SHAPES[:2]:
        pos, mask = packed_geometry(SEED + 1000 + n_atoms, B_CLS, heavy, n_atoms, device)
        if n_atoms == 64:
            within = radius_graph_mask(pairwise_distances(pos), mask, CUTOFF, None).sum(-1)
            require(bool((within > CAP).any()), "N=64 inputs never engage the neighbour cap")
        check_cfconv(label, pos, mask, gen, rows, F_CLS, GAUSS_CLS)
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
        captured = sorted(k[0] for k, st in res.graphs.steps.items() if st.graph is not None)
        require(captured == ["eval", "train"], f"stage {stage}: CUDA graphs captured {captured}")
        grew = {k: launches[k] - before.get(k, 0) for k in REGRESSION}
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
              + f"; epoch 2 (graph replays): {step_ms:.2f} ms/step, {gps:.1f} graphs/s on {card};"
              f" launches {grew}")
        stage_rows[stage] = dict(step_ms=step_ms, graphs_per_s=gps, steps=steps)
    totals = {k: launches[k] for k in REGRESSION}
    print(f"[train] main-path launches {totals}")
    for k, v in totals.items():
        require(v > 0, f"kernel {k} was never launched on the main path")
    return model, totals, stage_rows


def profile_stage2(model, device):
    """Device time by kernel over three eager stage-2 training steps (after
    the main path's counts were read), and the device's busy share of the
    wall time. Prints "not measured" where the profiler saw no device time."""
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
    return profile_steps("[profile] stage-2 step", lambda: train_step(model, opt, batch, settings))


def profile_steps(label, step, steps: int = 3):
    """``steps`` calls of ``step`` under ``torch.profiler``: prints the wall
    and device busy time per step, kernels per step and the largest kernels;
    returns ``(busy share, kernels per step, {kernel name: executions})``,
    or None where the profiler saw no device time ("not measured")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
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
        print(f"{label}: device time not measured (the profiler saw no device activity)")
        return None
    per_step = sum(e.count for e in events) // steps
    print(f"{label}: wall {wall_us / steps / 1e3:.3f} ms, device busy"
          f" {busy_us / steps / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}% busy), {per_step}"
          " kernels/step")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:8]:
        print(f"{label}   {e.self_device_time_total / steps / 1e3:8.3f} ms/step"
              f"  x{e.count // steps:<4d} {e.key[:70]}")
    counts = collections.Counter()
    for e in events:
        counts[e.key] += e.count
    return busy_us / wall_us, per_step, counts


# ---------------------------------------------------------------- phase 4
def phase_parity(model, device, batch=B, label="parity"):
    import torch

    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.train.loop import masked_mse

    recs = random_dataset(SEED + 3, batch, num_conformers=K, heavy_range=(8, 10), device=device)
    pb = pack_batch(recs, max_atoms=32, batch_size=batch)
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
        print(f"[{label}] {k}: grad norm kernel {nk[k]:.6e} plain {np_[k]:.6e} rel {rel[k]:.3e}")
    print(f"[{label}] loss kernel {lk:.6f} plain {lp:.6f}; grad norm kernel {gk:.6f} plain {gp:.6f};"
          f" worst parameter grad-norm rel err {worst:.3e} (tol {STEP_RTOL}, {PARAM_RTOL})")
    require(set(nk) == set(np_), f"{label}: card and CPU differ in which parameters get gradients")
    require(abs(lk - lp) <= STEP_RTOL * abs(lp), f"{label}: stage-2 loss disagrees")
    require(abs(gk - gp) <= STEP_RTOL * gp, f"{label}: stage-2 gradient norm disagrees")
    require(worst <= PARAM_RTOL, f"{label}: a parameter's gradient norm disagrees")
    model.zero_grad(set_to_none=True)
    return dict(loss_rel=abs(lk - lp) / abs(lp), grad_norm_rel=abs(gk - gp) / gp, worst_param_rel=worst)


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
    """Count calls of the kernels' plain versions and CUDA-graph captures by
    kind, record the weights each checkpoint restore leaves in the model,
    and count the host pipeline's numpy packs, pageable copies and staged
    copies from pinned slots and the steps it feeds, train and eval
    (``train_forwards``, ``eval_forwards``): ``(plain_calls, restores,
    captures, host)``, ``restores`` a list of ``(directory, which,
    state_dict on the host)``."""
    from conan_fgw_tpu_torch.data import loader
    from conan_fgw_tpu_torch.ops.cuda import cfconv as cfconv_mod
    from conan_fgw_tpu_torch.ops.cuda import fgw as fgw_mod
    from conan_fgw_tpu_torch.train import graphs as graphs_mod
    from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer
    from conan_fgw_tpu_torch.train.graphs import StepGraphs

    plain_calls, restores, captures = collections.Counter(), [], collections.Counter()
    host = collections.Counter()
    saved = [(cfconv_mod, "_cfconv_plain"), (fgw_mod, "fgw_couplings_plain"),
             (RunCheckpointer, "restore_params"), (StepGraphs, "_capture"),
             (loader, "pack_batch"), (graphs_mod._Step, "load"), (graphs_mod.PinnedSlots, "stage"),
             (StepGraphs, "_run")]
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

    def capture(self, step, fn, kind):
        captures[kind] += 1
        return originals[3](self, step, fn, kind)

    def host_counted(name, fn):
        def call(*args, **kwargs):
            host[name] += 1
            return fn(*args, **kwargs)
        return call

    cfconv_mod._cfconv_plain = counted("cfconv", originals[0])
    fgw_mod.fgw_couplings_plain = counted("fgw", originals[1])
    RunCheckpointer.restore_params = restore_params
    StepGraphs._capture = capture
    loader.pack_batch = host_counted("numpy_pack", originals[4])
    graphs_mod._Step.load = host_counted("pageable_copy", originals[5])
    graphs_mod.PinnedSlots.stage = host_counted("staged_copy", originals[6])

    def run_counted(self, kind, pb):
        host[f"{kind}_forwards"] += 1
        return originals[7](self, kind, pb)

    StepGraphs._run = run_counted
    try:
        yield plain_calls, restores, captures, host
    finally:
        for (owner, name), fn in zip(saved, originals):
            setattr(owner, name, fn)


def run_main(main, argv):
    """``main(argv)`` with its printed output kept off this script's."""
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def runner_stage(label, stage, cfg, ctx, *extra, start=0, kernels=REGRESSION, metric="rmse"):
    """One runner run with the launch counts zeroed before it; checks and
    prints it, returns ``(summary, history, launches)``. ``ctx`` holds the
    common arguments, the temporary directory, the plain-call counts, the
    device and the card line; ``start`` is the first epoch this run trains;
    ``kernels`` names the path's K1, K2 and K3 counts, and ``metric`` its
    validation and test metric (``rmse``, or ``auroc`` for classification).
    The run must capture at least one train and one eval graph."""
    import numpy as np
    import torch

    from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
    from conan_fgw_tpu_torch.train import runner

    common, tmp, plain_calls, captures, host, device, card = ctx
    k1, k2, k3 = kernels  # K1 and K2 None: the path has no cfconv (ViSNet, DimeNet)
    reset_launches()
    captures.clear()
    host.clear()
    t0 = time.perf_counter()
    summary = run_main(runner.main, ["--config", cfg, "--stage", stage, *common, *extra])
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    grew = {k: launches[k] for k in REPLACES}
    run_dir = tmp / "models" / "smoke" / "0" / f"run_{stage}:0"
    history = json.loads((run_dir / "last_state.meta.json").read_text())["loop"]["history"]
    steps = sum(r["train_steps"] for r in history)
    val_key = "val_mse" if metric == "rmse" else f"val_{metric}"
    require(not plain_calls, f"runner {label}: plain versions ran: {dict(plain_calls)}")
    if device == "cuda":
        require(captures["train"] and captures["eval"],
                f"runner {label}: CUDA graphs captured {dict(captures)}")
        # every batch natively packed into a pinned slot and staged from it
        require(host["staged_copy"] > 0 and not host["numpy_pack"] and not host["pageable_copy"],
                f"runner {label}: host pipeline {dict(host)}")
    for r in history:
        require(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"]),
                f"runner {label} epoch {r['epoch']} has a non-finite loss")
        require(r.get("steps_n32", 0) > 0 and r.get("steps_n64", 0) > 0,
                f"runner {label} epoch {r['epoch']} did not run both buckets: {r}")
    require(np.isfinite(summary[f"test_{metric}"]["mean"]), f"runner {label}: test_{metric} not finite")
    new_steps = sum(r["train_steps"] for r in history if r["epoch"] >= start)
    others = [k for k in REPLACES if k not in kernels and grew[k]]
    require(not others, f"runner {label}: kernels of another width or path launched: {others}")
    if k1 is None:
        # ViSNet and DimeNet: no cfconv; five K3 a stage-2 forward, train or eval, eager
        # or graphed (a graph's capture stands for its first replay)
        require(host["train_forwards"] == new_steps,
                f"runner {label}: {host['train_forwards']} train forwards in {new_steps} steps")
        if stage == "conan_fgw":
            forwards = host["train_forwards"] + host["eval_forwards"]
            require(host["eval_forwards"] > 0 and grew[k3] == 5 * forwards,
                    f"runner {label}: K3 launched {grew[k3]} in {forwards} forwards")
    else:
        # fit's steps ran as CUDA graphs; the counts must be the eager path's: K2 three a train
        # step, and every forward (train or eval) three K1 and, in stage 2, five K3
        require(grew[k1] >= 3 * new_steps and grew[k1] % 3 == 0,
                f"runner {label}: K1 launched {grew[k1]}")
        require(grew[k2] == 3 * new_steps, f"runner {label}: K2 launched {grew[k2]} in {new_steps} steps")
        if stage == "conan_fgw":
            require(3 * grew[k3] == 5 * grew[k1], f"runner {label}: K3 launched {grew[k3]}, K1 {grew[k1]}")
    if stage != "conan_fgw":
        require(grew[k3] == 0, f"runner {label}: K3 launched in stage 1")
    for r in history:
        n64 = r["steps_n64"] / r["train_steps"]
        print(f"[runner {label}] epoch {r['epoch']}: {r['epoch_time_s']:.3f} s, {r['train_steps']}"
              f" steps ({r['steps_n32']} at N=32, {r['steps_n64']} at N=64: {100 * n64:.1f}%),"
              f" {1e3 * r['train_s_n32'] / r['steps_n32']:.2f} ms/step at N=32,"
              f" {1e3 * r['train_s_n64'] / r['steps_n64']:.2f} ms/step at N=64,"
              f" fgw_diverged {r['fgw_diverged']}, train_loss {r['train_loss']:.5f},"
              f" {val_key} {r[val_key]:.5f}")
    print(f"[runner {label}] {steps} steps in all, {new_steps} in this run: {wall:.1f} s wall with"
          f" data and test on {card}; test_{metric} {summary[f'test_{metric}']['mean']:.6f};"
          f" launches {grew}; CUDA graphs captured {dict(captures)}; host pipeline {dict(host)}")
    return summary, history, grew


def stage_row(history, summary, metric):
    """What the result line keeps of one runner stage."""
    last = history[-1]
    return dict(epoch_s=[r["epoch_time_s"] for r in history],
                steps=last["train_steps"], steps_n64=last["steps_n64"],
                ms_n32=1e3 * last["train_s_n32"] / last["steps_n32"],
                ms_n64=1e3 * last["train_s_n64"] / last["steps_n64"],
                fgw_diverged=[r["fgw_diverged"] for r in history],
                **{f"test_{metric}": summary[f"test_{metric}"]["mean"]})


def check_warm_start(restores, first_restore, pre_dir):
    """The stage-2 weights right after the warm start equal stage 1's
    ``best`` file bit for bit."""
    import numpy as np

    warm = [st for d, which, st in restores[first_restore:] if Path(d) == pre_dir and which == "best"]
    require(len(warm) == 1, f"stage 2 restored stage 1's best {len(warm)} times")
    with np.load(pre_dir / "best.npz") as best:
        differ = [k for k, v in warm[0].items()
                  if not np.array_equal(best[k].view(np.uint32), v.numpy().view(np.uint32))]
        require(set(best.files) == set(warm[0]), "stage 1's best and the model differ in keys")
    print(f"[runner] warm start: {len(warm[0])} tensors equal stage 1's best bit for bit,"
          f" {len(differ)} differ")
    require(not differ, f"the warm start differs from stage 1's best in {differ[:3]}")


def phase_runner(device, card):
    """Phase 5: the runner's two stages, a resume and predict on sol250."""
    from conan_fgw_tpu_torch.train import predict

    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_runner_") as name, \
            runner_spies() as (plain_calls, restores, captures, host):
        tmp = Path(name)
        common = ["--data_root", ".", "--run_name", "smoke", "--run_id", "0",
                  "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                  "--metrics_dir", str(tmp / "metrics"), "--device", device]
        ctx = (common, tmp, plain_calls, captures, host, device, card)
        cfgs, totals = {}, collections.Counter()
        for stage, src in RUNNER_STAGES:
            first_restore = len(restores)  # stage 1 restores its own best for its test
            cfgs[stage] = config_copy(src, tmp, RUNNER_EPOCHS)
            label = "stage 1" if stage == "conan_fgw_pre" else "stage 2"
            summary, history, grew = runner_stage(label, stage, cfgs[stage], ctx)
            totals.update(grew)
            out[label] = stage_row(history, summary, "rmse")

        check_warm_start(restores, first_restore, tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0")

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


# ---------------------------------------------------------------- phase 6
CLASS_STAGES = (("conan_fgw_pre", "config/schnet/sol1k_class_5.yaml"),
                ("conan_fgw", "config/schnet/sol1k_class_5_bc.yaml"))


def phase_classification(device, card):
    """Phase 6: the classification model's two stages and predict on
    ``data/sol1k_class`` through the runner, at full width (hidden 512, 256
    filters, 10 Gaussians): the F=256 kernels and K3."""
    import csv

    import numpy as np

    from conan_fgw_tpu_torch.train import metrics as metrics_lib
    from conan_fgw_tpu_torch.train import predict

    out, totals = {}, collections.Counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_class_") as name, \
            runner_spies() as (plain_calls, restores, captures, host):
        tmp = Path(name)
        common = ["--data_root", ".", "--run_name", "smoke", "--run_id", "0",
                  "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                  "--metrics_dir", str(tmp / "metrics"), "--device", device]
        ctx = (common, tmp, plain_calls, captures, host, device, card)
        for stage, src in CLASS_STAGES:
            first_restore = len(restores)
            cfg = config_copy(src, tmp, RUNNER_EPOCHS)
            label = "class stage 1" if stage == "conan_fgw_pre" else "class stage 2"
            summary, history, grew = runner_stage(label, stage, cfg, ctx, kernels=CLASSIFICATION,
                                                  metric="auroc")
            totals.update(grew)
            out[label] = stage_row(history, summary, "auroc")
            aurocs = [r["val_auroc"] for r in history]
            require(all(0.0 <= v <= 1.0 for v in aurocs + [summary["test_auroc"]["mean"]]),
                    f"{label}: an AUROC outside [0, 1]: {aurocs}, {summary['test_auroc']}")
            run_dir = tmp / "models" / "smoke" / "0" / f"run_{stage}:0"
            best_epoch = json.loads((run_dir / "best.meta.json").read_text())["epoch"]
            require(best_epoch == int(np.argmax(aurocs)),
                    f"{label}: best is epoch {best_epoch}, the highest val_auroc is at"
                    f" {int(np.argmax(aurocs))} ({aurocs})")
            print(f"[runner {label}] best: epoch {best_epoch} of val_auroc {aurocs} (higher is better)")
        check_warm_start(restores, first_restore, tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0")

        preds = tmp / "class_preds.csv"
        run_main(predict.main, ["--config", cfg, "--checkpoint",
                                str(tmp / "models" / "smoke" / "0" / "run_conan_fgw:0"),
                                "--data_root", ".", "--device", device, "--out", str(preds)])
        with open(preds) as f:
            rows = list(csv.DictReader(f))
        prob = np.asarray([float(r["prediction"]) for r in rows])
        target = np.asarray([float(r["target"]) for r in rows])
        require(bool(np.all((prob >= 0) & (prob <= 1))), "predict's probabilities leave [0, 1]")
        auroc = metrics_lib.roc_auc(target.astype(np.int64), prob)
        reported = summary["test_auroc"]["mean"]
        print(f"[runner] predict on class stage 2's best: test AUROC from its probabilities"
              f" {auroc!r}, the runner's {reported!r}, diff {abs(auroc - reported):.3e}"
              f" (tol {PREDICT_RTOL})")
        require(abs(auroc - reported) <= PREDICT_RTOL, "predict's test AUROC disagrees with the runner's")
        require(not plain_calls, f"plain versions ran: {dict(plain_calls)}")
    out["launches"] = dict(totals)
    return out


# ---------------------------------------------------------------- phase 8
# how the result line's launch counts were taken
LAUNCHES_COUNTED = ("wrapper counts over CUDA-graphed steps: each graph's capture-time counts"
                    " once per replay (train/graphs.py::LaunchReplays), held against the"
                    " profiler's kernel executions in phase 8")
GRAPH_STEPS = 20     # batches of the eager-against-graphed run
GRAPH_LR_AT = 10     # set_learning_rate after this many steps, in both runs
GRAPH_TIMED = 50     # warmed steps in each timing turn
GRAPH_RTOL = 1e-5    # per-step losses and final weights, relative
GRAPH_EVAL_RTOL = 1e-6
# label, classification?, stage 2?, bucket N, heavy atoms per molecule, batch.
# Every case draws its molecules, in order and cycled, from the 480 of its
# bucket (GRAPH_STEPS batches of B); B=96 is config/schnet/sol250_5.yaml's
# stage-1 batch
GRAPH_CASES = (("stage 1 N32", False, False, 32, (8, 13), B),
               ("stage 1 N64", False, False, 64, (20, 26), B),
               ("stage 2 N32", False, True, 32, (8, 13), B),
               ("stage 2 N64", False, True, 64, (20, 26), B),
               ("class stage 2 N32", True, True, 32, (8, 13), B_CLS),
               ("stage 1 N32 B96", False, False, 32, (8, 13), 96))
PROFILED = {"cfconv_fwd_kernel": ("cfconv_fwd", "cfconv_fwd_f256"),
            "cfconv_bwd_kernel": ("cfconv_bwd", "cfconv_bwd_f256"),
            "fgw_couplings_kernel": ("fgw_couplings",)}


def _max_rel(a, b) -> float:
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@functools.cache
def graph_records(n_atoms: int, heavy: tuple, device: str) -> list:
    """Phase 8's synthetic molecules of one bucket (B=24's GRAPH_STEPS batches)."""
    from conan_fgw_tpu_torch.data.synthetic import random_dataset

    return random_dataset(SEED + 500 + n_atoms, GRAPH_STEPS * B, num_conformers=K,
                          heavy_range=heavy, device=device)


@contextlib.contextmanager
def host_split():
    """Host seconds of the pipelined graphed step's parts, summed into the
    yielded dict. On the prefetch thread: ``pack`` (the native packer into a
    pinned slot) and ``native`` (its foreign call, which runs without the
    interpreter lock). On the main thread: ``stage`` (``StepGraphs._load``:
    the non-blocking copy, its event, freeing landed slots) and
    ``slot_wait`` (the part of ``stage`` waiting for an earlier copy while
    too many are in flight)."""
    from conan_fgw_tpu_torch.data import native
    from conan_fgw_tpu_torch.train import graphs as graphs_mod

    spent = collections.Counter()
    lib = native.load_library()
    saved = [(graphs_mod, "pack_batch_native"), (graphs_mod.StepGraphs, "_load"),
             (graphs_mod.PinnedSlots, "reclaim"), (lib, "pack_batch")]
    originals = [getattr(owner, name) for owner, name in saved]

    def timed(name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[name] += time.perf_counter() - t0
        return call

    for (owner, name), fn, key in zip(saved, originals,
                                      ("pack", "stage", "slot_wait", "native")):
        setattr(owner, name, timed(key, fn))
    try:
        yield spent
    finally:
        for (owner, name), fn in zip(saved, originals):
            setattr(owner, name, fn)


def graph_case(label, classify, bary, n_atoms, heavy, batch, device, card, base=None,
               timed=GRAPH_TIMED):
    """One shape of phase 8: eager steps on pre-packed batches against
    graphed steps fed by the host pipeline (prefetch, native packing into
    pinned slots, non-blocking copies), from identical weights through an lr
    change; the eval graph against eager eval; ms per step in turns (eager,
    graphed, pipelined, serial and back); the pipelined step's host time
    split; for stage 2 a profile of three graphed steps. ``base`` is the
    model to start from (default: the seeded SchNet model of the case's
    task); a model without cfconv must launch K3 alone. ``timed`` warmed
    steps a turn."""
    import dataclasses

    import numpy as np
    import torch

    from conan_fgw_tpu_torch.data.loader import batches as host_batches
    from conan_fgw_tpu_torch.data.packing import bucket_for, pack_batch
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.models.schnet import SchNet3D
    from conan_fgw_tpu_torch.ops.cuda import launches
    from conan_fgw_tpu_torch.train import loop

    # the molecules of the case's own bucket, so that the pipeline's
    # bucketed batches are the pre-packed ones: one shape, in input order
    pool = [r for r in graph_records(n_atoms, heavy, device)
            if bucket_for(r.num_atoms, loop.bucket_boundaries(n_atoms)) == n_atoms]
    recs = [pool[i % len(pool)] for i in range(GRAPH_STEPS * batch)]
    if classify:
        median = float(np.median([r.y for r in recs]))
        recs = [dataclasses.replace(r, y=float(r.y > median)) for r in recs]
    t0 = time.perf_counter()
    batches = list(host_batches(recs, batch, n_atoms, pack=pack_batch))
    numpy_ms = 1e3 * (time.perf_counter() - t0) / len(batches)
    require(len(batches) == GRAPH_STEPS and all(pb.mol_mask.all() for pb in batches),
            f"graphs {label}: the batches are not {GRAPH_STEPS} full ones at N={n_atoms}")
    width = dict(task="classification", hidden_channels=512, num_filters=256,
                 num_gaussians=GAUSS_CLS) if classify else {}
    if base is None:
        base = ConanModel(seed=SEED, device=device, **width)
    schnet = isinstance(base.backbone, SchNet3D)
    settings = loop.TrainSettings(task=width.get("task", "regression"), batch_size=batch,
                                  use_barycenter=bary)

    # eager against graphed, from identical weights and a fresh Adam each
    runs = {}
    for mode in ("eager", "graphed"):
        model = copy.deepcopy(base)
        opt = loop.make_optimizer(model, settings)
        graphs = loop.step_graphs(model, opt, settings, device)
        before, losses = collections.Counter(launches), []
        if mode == "eager":
            for i, pb in enumerate(batches):
                if i == GRAPH_LR_AT:
                    loop.set_learning_rate(opt, 0.5 * settings.learning_rate)
                losses.append(loop.train_step(model, opt, pb.to(device), settings)[0])
        else:
            with loop.step_batches(recs, settings, n_atoms, graphs) as staged:
                for i, pb in enumerate(staged):
                    if i == GRAPH_LR_AT:
                        loop.set_learning_rate(opt, 0.5 * settings.learning_rate)
                    losses.append(graphs.train(pb)[0])
        torch.cuda.synchronize()
        grew = {k: launches[k] - before[k] for k in REPLACES if launches[k] != before[k]}
        runs[mode] = (model, opt, graphs, torch.stack(losses), grew)
    (m_e, opt_e, _, loss_e, grew_e), (m_g, opt_g, graphs, loss_g, grew_g) = runs["eager"], runs["graphed"]
    require(loss_e.isfinite().all(), f"graphs {label}: a non-finite eager loss")
    require(len(loss_g) == GRAPH_STEPS, f"graphs {label}: the pipeline gave {len(loss_g)} batches")
    loss_rel = _max_rel(loss_g, loss_e)
    w_rel = max(_max_rel(q.detach(), p.detach()) for p, q in zip(m_e.parameters(), m_g.parameters()))
    bits = bool(torch.equal(loss_e, loss_g)) and all(
        torch.equal(p, q) for p, q in zip(m_e.parameters(), m_g.parameters()))
    captured = sorted(k[0] for k, s in graphs.steps.items() if s.graph is not None)
    require(list(graphs.pools) == [(batch, K, n_atoms)],
            f"graphs {label}: pinned slots for {list(graphs.pools)}")
    print(f"[graphs {label}] {GRAPH_STEPS} steps eager vs graphed (batches through prefetch,"
          f" native packing into pinned slots), lr halved after {GRAPH_LR_AT}: losses rel"
          f" {loss_rel:.3e}, weights rel {w_rel:.3e} (tol {GRAPH_RTOL}); bit-identical {bits};"
          f" graphs captured {captured}; launches eager {grew_e} graphed {grew_g}")
    require(loss_rel <= GRAPH_RTOL and w_rel <= GRAPH_RTOL, f"graphs {label}: eager and graphed differ")
    require(captured == ["train"], f"graphs {label}: captured {captured}")
    require(grew_e == grew_g, f"graphs {label}: launches eager {grew_e} graphed {grew_g}")

    # the eval graph against eager eval on the same weights (the first
    # batch warms up, the second is captured, the rest replay)
    before, preds_g, preds_e = collections.Counter(launches), [], []
    for pb in batches[:5]:
        preds_g.append(graphs.eval(pb)[1])
    grew_eval = {k: launches[k] - before[k] for k in REPLACES if launches[k] != before[k]}
    before = collections.Counter(launches)
    for pb in batches[:5]:
        preds_e.append(loop.eval_step(m_g, pb.to(device), settings)[1])
    grew_eager_eval = {k: launches[k] - before[k] for k in REPLACES if launches[k] != before[k]}
    eval_rel = _max_rel(torch.cat(preds_g), torch.cat(preds_e))
    print(f"[graphs {label}] eval graph vs eager eval, 5 batches: predictions rel {eval_rel:.3e}"
          f" (tol {GRAPH_EVAL_RTOL}); launches {grew_eval}")
    require(eval_rel <= GRAPH_EVAL_RTOL, f"graphs {label}: the eval graph disagrees")
    require(grew_eval == grew_eager_eval, f"graphs {label}: eval launches {grew_eval} against"
            f" {grew_eager_eval} eager")

    # timing in turns of timed warmed steps over the batches: eager
    # and graphed steps on pre-packed batches (pageable copies), pipelined
    # ones through the host pipeline, serial ones packed by numpy on this
    # thread (pageable copies)
    order = [batches[i % GRAPH_STEPS] for i in range(timed)]
    timed_recs = [r for i in range(timed) for r in recs[(i % GRAPH_STEPS) * batch:][:batch]]

    def eager_turn():
        for pb in order:
            loop.train_step(m_e, opt_e, pb.to(device), settings)

    def graphed_turn():
        for pb in order:
            graphs.train(pb)

    def pipelined_turn(split=None, **pipeline):
        with loop.step_batches(timed_recs, settings, n_atoms, graphs, **pipeline) as staged:
            staged = iter(staged)
            while True:
                t0 = time.perf_counter()
                pb = next(staged, None)
                if split is not None:
                    split["queue_wait"] += time.perf_counter() - t0
                if pb is None:
                    return
                graphs.train(pb)

    turn_fns = {"eager": eager_turn, "graphed": graphed_turn, "pipelined": pipelined_turn,
                "serial": functools.partial(pipelined_turn, prefetch=False, native=False)}
    turns = collections.defaultdict(list)
    for mode in (*turn_fns, *reversed(turn_fns)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        turn_fns[mode]()
        torch.cuda.synchronize()
        turns[mode].append(1e3 * (time.perf_counter() - t0) / timed)
    # the pipelined step's host time per step, from one more turn
    with host_split() as split:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pipelined_turn(split)
        torch.cuda.synchronize()
        split_turn_ms = 1e3 * (time.perf_counter() - t0) / timed
    per = {k: 1e3 * v / timed for k, v in split.items()}
    per["copy"] = per["stage"] - per["slot_wait"]
    per["replay"] = split_turn_ms - per["queue_wait"] - per["stage"]
    gps = {m: batch * K * 1e3 / min(v) for m, v in turns.items()}
    print(f"[graphs {label}] ms/step over {timed} warmed steps, turns "
          + "/".join(turns) + ", then back: " + "; ".join(
              f"{m} {v[0]:.3f}/{v[1]:.3f}" for m, v in turns.items())
          + f" on {card}; graphs/s " + ", ".join(f"{m} {v:.1f}" for m, v in gps.items()))
    print(f"[graphs {label}] pipelined step, host ms per step ({split_turn_ms:.3f} ms a step):"
          f" queue wait {per['queue_wait']:.3f}, copy {per['copy']:.3f} (non-blocking), slot"
          f" wait {per['slot_wait']:.3f}, replay and the rest {per['replay']:.3f}; prefetch thread:"
          f" native packing {per['pack']:.3f} ms a batch (the foreign call {per['native']:.3f},"
          f" the interpreter lock held {per['pack'] - per['native']:.3f}); numpy packing"
          f" {numpy_ms:.3f} ms a batch")
    row = dict(eager_ms=turns["eager"], graphed_ms=turns["graphed"],
               pipelined_ms=turns["pipelined"], serial_ms=turns["serial"],
               **{f"{m}_gps": v for m, v in gps.items()}, numpy_pack_ms=numpy_ms,
               native_pack_ms=per["pack"], native_call_ms=per["native"],
               staged_copy_ms=per["copy"], slot_wait_ms=per["slot_wait"],
               queue_wait_ms=per["queue_wait"], pipelined_replay_ms=per["replay"],
               split_step_ms=split_turn_ms, loss_rel=loss_rel, weights_rel=w_rel,
               eval_rel=eval_rel, bit_identical=bits)
    if bary:
        before = collections.Counter(launches)
        prof = profile_steps(f"[graphs {label}] profile, graphed", lambda: graphs.train(batches[0]))
        grew = {k: launches[k] - before[k] for k in REPLACES if launches[k] != before[k]}
        # the launch counts of graphed steps are derived (LaunchReplays): the
        # profiler's count of executions must back them
        require(prof is not None, f"graphs {label}: the profiler saw no device activity")
        busy, per_step, counts = prof
        seen = {name: sum(c for key, c in counts.items() if name in key) for name in PROFILED}
        want = {name: sum(grew.get(k, 0) for k in names) for name, names in PROFILED.items()}
        print(f"[graphs {label}] kernel executions seen by the profiler {seen}, counted by"
              f" the wrappers {want}")
        ran = seen.values() if schnet else [seen["fgw_couplings_kernel"]]
        require(seen == want and all(ran), f"graphs {label}: the profiler saw {seen}, launches {want}")
        row.update(busy_share=busy, kernels_per_step=per_step)
    del runs, graphs, m_e, m_g, opt_e, opt_g
    torch.cuda.empty_cache()
    return row


def phase_graphs(device, card):
    """Phase 8: the train and eval steps as CUDA graphs, at full width."""
    return {label: graph_case(label, *case, device, card) for label, *case in GRAPH_CASES}


# ---------------------------------------------------------------- phase 9
# configs whose datasets the packer check packs, at their batch sizes (the
# stage-1 and stage-2 batches of sol250, sol1k_class's)
PACKER_DATA = (("config/schnet/sol250_5.yaml", (96, 24)),
               ("config/schnet/sol1k_class_5.yaml", (18,)))
PIPELINE_EPOCHS = 2


def packer_check(device):
    """The native packer against the numpy one, byte for byte, over every
    batch of every split of ``data/sol250`` and ``data/sol1k_class`` at their
    configs' batch sizes, in every bucket they reach: packed fresh and into
    one reused pinned buffer per shape."""
    import numpy as np

    from conan_fgw_tpu_torch.data import native
    from conan_fgw_tpu_torch.data.loader import bucketed_batches
    from conan_fgw_tpu_torch.data.packing import batch_layout, pack_batch
    from conan_fgw_tpu_torch.train import loop
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.graphs import host_batch
    from conan_fgw_tpu_torch.train.runner import load_datasets

    out = {}
    for cfg, sizes in PACKER_DATA:
        ds = load_datasets(load_config(cfg), "data")
        splits = {m: ds[m].records() for m in ("train", "valid", "test")}
        buckets = loop.bucket_boundaries(loop.dataset_max_atoms(
            [r for recs in splits.values() for r in recs]))
        for batch in sizes:
            pinned, shapes, spent = {}, collections.Counter(), collections.Counter()

            def check(chunk, *, max_atoms, batch_size):
                t0 = time.perf_counter()
                want = pack_batch(chunk, max_atoms=max_atoms, batch_size=batch_size)
                t1 = time.perf_counter()
                got = native.pack_batch_native(chunk, max_atoms=max_atoms, batch_size=batch_size)
                spent["numpy"] += t1 - t0
                spent["native"] += time.perf_counter() - t1
                shape = want.z.shape
                if shape not in pinned:
                    pinned[shape] = host_batch(batch_layout(*shape), pin=device == "cuda")[1]
                into = native.pack_batch_native(chunk, max_atoms=max_atoms, batch_size=batch_size,
                                                out=pinned[shape])
                for name in ("z", "pos", "atom_mask", "x2d", "bond_adj", "bond_attr", "y",
                             "mol_mask"):
                    ref = getattr(want, name)
                    for other in (got, into):
                        a = getattr(other, name)
                        require(a.dtype == ref.dtype and a.shape == ref.shape
                                and np.array_equal(a.view(np.uint8), ref.view(np.uint8)),
                                f"packer check {cfg} batch {batch} N={max_atoms}: {name} differs")
                shapes[max_atoms] += 1
                return want

            for recs in splits.values():
                for _ in bucketed_batches(recs, batch, buckets, pack=check):
                    pass
            n = sum(shapes.values())
            label = f"{Path(cfg).stem} B={batch}"
            print(f"[packer] {label}: {n} batches byte-identical, native and numpy, fresh and into"
                  f" a reused pinned buffer, by bucket {dict(shapes)}; host ms a batch: numpy"
                  f" {1e3 * spent['numpy'] / n:.3f}, native {1e3 * spent['native'] / n:.3f}")
            out[label] = dict(batches=n, by_bucket=dict(shapes),
                              numpy_ms=1e3 * spent["numpy"] / n, native_ms=1e3 * spent["native"] / n)
    return out


def phase_pipeline(device, card):
    """Phase 9: the packer check, then two ``fit`` runs of sol250's stage 1
    (``config/schnet/sol250_5.yaml``, 2 epochs, from the same seeded model):
    through the host pipeline (prefetch, native packing into pinned slots)
    and with ``prefetch=False, native=False`` (numpy packing on the main
    thread, pageable copies). Losses and weights must agree bit for bit;
    prints both runs' ms per step by bucket."""
    import torch

    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.loop import fit
    from conan_fgw_tpu_torch.train.runner import STAGE_PRE, build_model, build_settings, load_datasets

    out = {"packer": packer_check(device)}
    config = load_config(RUNNER_STAGES[0][1])
    settings = build_settings(config, STAGE_PRE)
    settings.num_epochs = PIPELINE_EPOCHS
    ds = load_datasets(config, "data")

    def train_records(epoch):
        ds["train"].set_epoch(epoch)
        return ds["train"].records()

    runs = {}
    for mode, kw in (("serial numpy", dict(prefetch=False, native=False)), ("prefetched", {})):
        with runner_spies() as (plain_calls, _, _, host):
            res = fit(settings, train_records, ds["valid"].records(),
                      model=build_model(config, seed=settings.seed, device=device), device=device,
                      **kw)
        require(not plain_calls, f"pipeline {mode}: plain versions ran: {dict(plain_calls)}")
        if mode == "prefetched":
            require(host["staged_copy"] and not host["numpy_pack"] and not host["pageable_copy"],
                    f"pipeline {mode}: host pipeline {dict(host)}")
        else:
            require(host["numpy_pack"] and host["pageable_copy"] and not host["staged_copy"],
                    f"pipeline {mode}: host pipeline {dict(host)}")
        runs[mode] = res
        for r in res.history:
            print(f"[pipeline {mode}] epoch {r['epoch']}: {r['epoch_time_s']:.3f} s,"
                  f" {1e3 * r['train_s_n32'] / r['steps_n32']:.2f} ms/step at N=32"
                  f" ({r['steps_n32']} steps), {1e3 * r['train_s_n64'] / r['steps_n64']:.2f} at"
                  f" N=64 ({r['steps_n64']}), train_loss {r['train_loss']!r}, val_loss"
                  f" {r['val_loss']!r}; host pipeline {dict(host)} on {card}")
    a, b = runs["prefetched"], runs["serial numpy"]
    keys = ("train_loss", "val_loss", "val_mse", "val_rmse")
    same_losses = [[ra[k] for k in keys] for ra in a.history] == [[rb[k] for k in keys]
                                                                   for rb in b.history]
    same_weights = all(torch.equal(p, q) for p, q in zip(a.model.parameters(), b.model.parameters()))
    print(f"[pipeline] sol250 stage 1, {PIPELINE_EPOCHS} epochs: prefetched and native against"
          f" serial numpy, losses bit-identical {same_losses}, weights bit-identical {same_weights}")
    require(same_losses and same_weights, "the prefetched run differs from the serial numpy run")
    for mode, res in runs.items():
        last = res.history[-1]
        out[mode] = dict(ms_n32=1e3 * last["train_s_n32"] / last["steps_n32"],
                         ms_n64=1e3 * last["train_s_n64"] / last["steps_n64"],
                         epoch_s=[r["epoch_time_s"] for r in res.history])
    return out


# ---------------------------------------------------------------- phase 10
# the ViSNet and DimeNet paths: (stage-1 config, stage-2 config) each
BACKBONES = {"visnet": ("config/visnet/sol250_5.yaml", "config/visnet/sol250_5_bc.yaml"),
             "dimenet": ("config/dimenet/sol250_5.yaml", "config/dimenet/sol250_5_bc.yaml")}
# what those paths launch: no cfconv, K3 in stage 2
BACKBONE_KERNELS = (None, None, "fgw_couplings")
# DimeNet's barycenter budget: alpha 0.5 with the structure held fixed
FGW_FIXED_KW = dict(FGW_KW, alpha=0.5)
MEMORY_STEPS = 3  # eager steps a stage and bucket; the last two are timed
BACKBONE_TIMED = 10  # warmed steps a timing turn of phase 8's case (steps of 50-110 ms)


def check_fgw_fixed(device, rows):
    """K3 against its plain version at DimeNet's alpha 0.5 on a fixed
    structure (C1 the first conformer's cutoff-5 graph at every outer
    iteration) at DimeNet's stage-2 batch of 16 molecules, N=32 and N=64:
    the first outer iteration and the second (updated M, the first plans
    as T0, the same C1)."""
    import torch

    gen = torch.Generator().manual_seed(SEED + 7)
    for label, heavy, n_atoms in FGW_SHAPES[:2]:
        pos, mask = packed_geometry(SEED + 2000 + n_atoms, 16, heavy, n_atoms, device)
        args, Ys, Cs = fgw_problem(pos, mask, gen, cutoff=5.0)
        tag = "alpha05" if n_atoms == 32 else f"alpha05-{label}"
        check_fgw(tag, args, rows, FGW_FIXED_KW)
        check_fgw(f"{tag}-outer2", second_outer_inputs(args, Ys, Cs, FGW_FIXED_KW,
                                                      fixed_structure=True), rows, FGW_FIXED_KW)


def backbone_memory(name, device, card):
    """Eager train steps of the runner's model from each config at its own
    batch on ``data/sol250``'s molecules of one bucket (cycled to fill the
    batch), stage 1 and 2, N=32 and N=64: ms per step (the last two of
    ``MEMORY_STEPS``, each ending in a synchronise) and the peak of
    ``torch.cuda.max_memory_allocated`` from a fresh model on, less what
    was allocated before it."""
    import torch

    from conan_fgw_tpu_torch.data.packing import bucket_for, pack_batch
    from conan_fgw_tpu_torch.train import loop
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.runner import STAGE_BC, STAGE_PRE, build_model, build_settings
    from conan_fgw_tpu_torch.train.runner import load_datasets

    out = {}
    for stage, cfg in zip((STAGE_PRE, STAGE_BC), BACKBONES[name]):
        config = load_config(cfg)
        settings = build_settings(config, stage)
        records = load_datasets(config, "data")["train"].records()
        for n_atoms in (32, 64):
            pool = [r for r in records if bucket_for(r.num_atoms, (32, 64)) == n_atoms]
            recs = [pool[i % len(pool)] for i in range(settings.batch_size)]
            batch = pack_batch(recs, max_atoms=n_atoms, batch_size=settings.batch_size).to(device)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()  # by earlier phases and the batch
            model = build_model(config, seed=SEED, device=device)
            opt = loop.make_optimizer(model, settings)
            times = []
            for _ in range(MEMORY_STEPS):
                t0 = time.perf_counter()
                loss, _ = loop.train_step(model, opt, batch, settings)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            peak = (torch.cuda.max_memory_allocated() - held) / 2**30
            ms = 1e3 * min(times[1:])
            require(bool(torch.isfinite(loss)), f"{name} {stage} N={n_atoms}: a non-finite loss")
            key = f"{'stage 1' if stage == STAGE_PRE else 'stage 2'} N{n_atoms}"
            print(f"[{name} memory] {key}, batch {settings.batch_size} (G={settings.batch_size * K}):"
                  f" eager {ms:.2f} ms/step, peak {peak:.2f} GiB allocated (model, Adam and the"
                  f" step, beyond what was held before) on {card}")
            out[key] = dict(eager_ms=ms, peak_gib=peak)
            del model, opt, batch
    torch.cuda.empty_cache()
    return out


def phase_backbones(device, card, rows):
    """Phase 10: the ViSNet and DimeNet paths. K3 at alpha 0.5 on a fixed
    structure; then per backbone: eager steps' time and peak memory by
    stage and bucket; the runner's two stages and predict on
    ``data/sol250`` (launch counts zeroed before each stage and read after
    it: no cfconv kernel, K3 in stage 2 only, no plain version, both
    buckets as CUDA graphs fed by the host pipeline, the warm start bit for
    bit, predict's RMSE the runner's, and the peak memory of each stage);
    one stage-2 step on the card against the CPU; and phase 8's case for
    stage 2 at N=32 at the stage-2 config's batch."""
    import torch

    from conan_fgw_tpu_torch.train import predict
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.runner import build_model

    check_fgw_fixed(device, rows)
    out = {}
    for name, (pre_cfg, bc_cfg) in BACKBONES.items():
        row = out[name] = {"memory": backbone_memory(name, device, card)}
        totals = collections.Counter()
        with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{name}_") as tmpname, \
                runner_spies() as (plain_calls, restores, captures, host):
            tmp = Path(tmpname)
            common = ["--data_root", ".", "--run_name", "smoke", "--run_id", "0",
                      "--models_dir", str(tmp / "models"), "--logs_dir", str(tmp / "logs"),
                      "--metrics_dir", str(tmp / "metrics"), "--device", device]
            ctx = (common, tmp, plain_calls, captures, host, device, card)
            for stage, src in zip(("conan_fgw_pre", "conan_fgw"), (pre_cfg, bc_cfg)):
                first_restore = len(restores)
                cfg = config_copy(src, tmp, RUNNER_EPOCHS)
                label = f"{name} stage {1 if stage == 'conan_fgw_pre' else 2}"
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                summary, history, grew = runner_stage(label, stage, cfg, ctx,
                                                      kernels=BACKBONE_KERNELS)
                peak = (torch.cuda.max_memory_allocated() - held) / 2**30
                print(f"[runner {label}] peak {peak:.2f} GiB allocated beyond what was held before"
                      f" (both buckets' train and eval graphs with their pools) on {card}")
                totals.update(grew)
                row[label] = dict(stage_row(history, summary, "rmse"), peak_gib=peak)
            check_warm_start(restores, first_restore,
                             tmp / "models" / "smoke" / "0" / "run_conan_fgw_pre:0")
            reported = summary["test_rmse"]["mean"]
            rmse = run_main(predict.main, ["--config", cfg, "--checkpoint",
                                           str(tmp / "models" / "smoke" / "0" / "run_conan_fgw:0"),
                                           "--data_root", ".", "--device", device,
                                           "--out", str(tmp / "preds.csv")])
            rel = abs(rmse - reported) / abs(reported)
            print(f"[runner {name}] predict on stage 2's best: test RMSE {rmse!r}, the runner's"
                  f" {reported!r}, rel {rel:.3e} (tol {PREDICT_RTOL})")
            require(rel <= PREDICT_RTOL, f"{name}: predict's test RMSE disagrees with the runner's")
            require(not plain_calls, f"{name}: plain versions ran: {dict(plain_calls)}")
        row["launches"] = {k: totals[k] for k in REPLACES}
        require(row["launches"]["fgw_couplings"] > 0, f"{name}: K3 never launched")
        config = load_config(bc_cfg)
        row["parity"] = phase_parity(build_model(config, seed=SEED, device=device), device,
                                     batch=config.batch_size, label=f"{name} parity")
        row["graphs"] = graph_case(f"{name} stage 2 N32", False, True, 32, (8, 13),
                                   config.batch_size, device, card,
                                   base=build_model(config, seed=SEED, device=device),
                                   timed=BACKBONE_TIMED)
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- determinism
DET_STEPS = 3  # stage-1 steps, then as many stage-2 steps, from the same weights
# graphed steps per stage: the shape's eager warm-up, the capture with its
# first replay, then replays
DET_GRAPH_STEPS = 4


def _digest(*arrays) -> str:
    import hashlib

    import numpy as np

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def determinism_worker(out_path: str, deterministic: bool) -> int:
    """One fresh process's run of the seeded steps: ``DET_STEPS`` stage-1
    steps at batch 96 and ``DET_STEPS`` stage-2 steps at batch 24 on
    ``data/sol250``'s first train records, from the seeded flagship model,
    then ``DET_STEPS`` stage-2 steps of the runner's seeded ViSNet and
    DimeNet models at their stage-2 configs' batches. Writes, per step, the
    batch's digest, the loss's bits, each gradient's digest before the clip
    and each weight's digest after the update, to ``out_path`` (JSON). Then,
    from the seeded models again, ``DET_GRAPH_STEPS`` steps a stage through
    ``StepGraphs`` on the N=32 molecules, their batches through the host
    pipeline (prefetch, native packing into pinned slots; stages ``g1``,
    ``g2``, ``gvisnet``, ``gdimenet``), whose gradients are read after the
    clip from the graph's static tensors. ``deterministic`` runs the eager
    steps only, under ``torch.use_deterministic_algorithms(True)``, which
    raises naming an operation that has no deterministic implementation."""
    import os

    if deterministic:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # before CUDA starts
    import struct

    import torch

    from conan_fgw_tpu_torch.data.datasets import ConformerDataset
    from conan_fgw_tpu_torch.data.loader import bucketed_batches
    from conan_fgw_tpu_torch.device import pin_full_f32
    from conan_fgw_tpu_torch.models.heads import ConanModel
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.train.loop import (
        TrainSettings,
        clip_by_global_norm_,
        make_optimizer,
        masked_mse,
        step_batches,
        step_graphs,
    )
    from conan_fgw_tpu_torch.train.runner import build_model

    pin_full_f32()
    torch.use_deterministic_algorithms(deterministic)
    records = ConformerDataset("train", "data", "sol250", "logS_surrogate", K).records()[:192]
    rows, t_steps, graph_s = [], [], []

    def eager_steps(model, settings, stage):
        opt = make_optimizer(model, settings)
        batches = bucketed_batches(records, settings.batch_size, buckets=(32, 64))
        for _, pb in zip(range(DET_STEPS), batches):
            row = {"stage": stage,
                   "batch": _digest(*(getattr(pb, f) for f in ("z", "pos", "atom_mask", "y")))}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            batch = pb.to("cuda")
            opt.zero_grad(set_to_none=True)
            pred, _ = model(batch, use_barycenter=settings.use_barycenter)
            loss = masked_mse(pred, batch)
            loss.backward()
            row["loss"] = struct.pack("<f", float(loss.detach())).hex()
            row["grads"] = {k: _digest(p.grad.cpu().numpy()) for k, p in model.named_parameters()
                            if p.grad is not None}
            clip_by_global_norm_(list(model.parameters()), settings.grad_clip)
            opt.step()
            torch.cuda.synchronize()
            t_steps.append(time.perf_counter() - t0)
            row["weights"] = {k: _digest(p.detach().cpu().numpy()) for k, p in model.named_parameters()}
            rows.append(row)

    def graphed_steps(model, settings, stage):
        # the N=32 molecules, cycled, through the host pipeline as fit takes
        # them: prefetched, packed natively into pinned slots
        names = [k for k, _ in model.named_parameters()]
        graphs = step_graphs(model, make_optimizer(model, settings), settings, "cuda")
        n32 = [r for r in records if r.num_atoms <= 32]
        stream = [n32[i % len(n32)] for i in range(DET_GRAPH_STEPS * settings.batch_size)]
        with step_batches(stream, settings, 32, graphs) as staged:
            for pb in staged:
                digest = _digest(*(getattr(pb, f) for f in ("z", "pos", "atom_mask", "y")))
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                loss, _ = graphs.train(pb)
                torch.cuda.synchronize()
                graph_s.append(time.perf_counter() - t0)
                rows.append({
                    "stage": stage,
                    "batch": digest,
                    "loss": struct.pack("<f", float(loss)).hex(),
                    "grads": {k: _digest(g.cpu().numpy()) for k, g in zip(names, graphs.grads)
                              if g is not None},
                    "weights": {k: _digest(p.detach().cpu().numpy())
                                for k, p in model.named_parameters()},
                })
        require(graphs.pools, "the determinism worker's graphed steps had no pinned slots")
        require(sum(s.graph is not None for s in graphs.steps.values()) == 1,
                "the determinism worker captured no graph")

    schnet_stages = ((False, 96), (True, 24))
    backbones = {name: load_config(bc_cfg) for name, (_, bc_cfg) in BACKBONES.items()}
    model = ConanModel(seed=SEED, device="cuda")
    for bary, batch_size in schnet_stages:
        eager_steps(model, TrainSettings(batch_size=batch_size, use_barycenter=bary), 2 if bary else 1)
    for name, config in backbones.items():
        eager_steps(build_model(config, seed=SEED, device="cuda"),
                    TrainSettings(batch_size=config.batch_size, use_barycenter=True), name)
    if not deterministic:
        model = ConanModel(seed=SEED, device="cuda")
        for bary, batch_size in schnet_stages:
            graphed_steps(model, TrainSettings(batch_size=batch_size, use_barycenter=bary),
                          f"g{2 if bary else 1}")
        for name, config in backbones.items():
            graphed_steps(build_model(config, seed=SEED, device="cuda"),
                          TrainSettings(batch_size=config.batch_size, use_barycenter=True), f"g{name}")
    Path(out_path).write_text(json.dumps({"steps": rows, "step_s": t_steps, "graph_step_s": graph_s}))
    return 0


def _run_worker(path: Path, deterministic: bool) -> dict:
    proc = subprocess.run([sys.executable, __file__, "--determinism-worker", str(path),
                           "1" if deterministic else "0"], capture_output=True, text=True,
                          timeout=600)
    require(proc.returncode == 0, f"determinism worker (deterministic={deterministic}) failed:\n"
            + (proc.stdout + proc.stderr)[-3000:])
    return json.loads(path.read_text())


def _first_difference(a: dict, b: dict):
    """``(step, stage, what differs)`` of two workers' runs, or None."""
    for k, (ra, rb) in enumerate(zip(a["steps"], b["steps"])):
        diff = {key: [n for n in ra[key] if ra[key][n] != rb[key].get(n)]
                for key in ("grads", "weights")}
        diff.update({key: ra[key] != rb[key] for key in ("batch", "loss")})
        if any(diff.values()):
            return k, ra["stage"], diff
    return None


def phase_determinism():
    """Reproducibility across processes: two fresh processes run
    ``determinism_worker`` as a user's run does, and their batches, losses,
    gradients and weights must agree bit for bit; a third runs it under
    ``torch.use_deterministic_algorithms(True)`` and must finish (torch
    raises on an operation of the path that has no deterministic
    implementation). Prints the first difference, if any, and the step
    times of both modes."""
    with tempfile.TemporaryDirectory(prefix="chip_smoke_det_") as name:
        tmp = Path(name)
        a, b = (_run_worker(tmp / f"run{i}.json", False) for i in range(2))
        strict = _run_worker(tmp / "strict.json", True)
    first = _first_difference(a, b)
    ms = [1e3 * min(x, y) for x, y in zip(a["step_s"], b["step_s"])]
    print(f"[determinism] step ms (the faster process): " + ", ".join(f"{v:.2f}" for v in ms)
          + "; under deterministic algorithms: "
          + ", ".join(f"{1e3 * v:.2f}" for v in strict["step_s"]))
    same_strict = _first_difference(a, strict) is None
    print(f"[determinism] deterministic-algorithms run finished; bit-identical to the default"
          f" runs: {same_strict}")
    if first is not None:
        k, stage, diff = first
        print(f"[determinism] first difference at step {k} (stage {stage}): batch {diff['batch']},"
              f" loss {diff['loss']}, gradients {diff['grads'][:8]}, weights {diff['weights'][:8]}")
    require(first is None, "two processes of the same seeded steps differ")
    graphed = sum(str(r["stage"]).startswith("g") for r in a["steps"])
    require(graphed == (2 + len(BACKBONES)) * DET_GRAPH_STEPS, f"the workers ran {graphed} graphed steps")
    graph_ms = [1e3 * min(x, y) for x, y in zip(a["graph_step_s"], b["graph_step_s"])]
    print(f"[determinism] two processes: batches, losses, gradients and weights bit-identical over"
          f" {len(a['steps'])} steps ({len(a['steps']) - graphed} eager, {graphed} through CUDA"
          f" graphs; SchNet stage 1 and stage 2, ViSNet and DimeNet stage 2); graphed step ms"
          f" (the faster process, each with a"
          " synchronise): " + ", ".join(f"{v:.2f}" for v in graph_ms))
    return dict(steps=len(a["steps"]), step_ms=ms, graph_step_ms=graph_ms,
                strict_step_ms=[1e3 * v for v in strict["step_s"]], strict_identical=same_strict)


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
    stage_rows["classification"] = phase_classification(device, card)
    stage_rows["graphs"] = phase_graphs(device, card)
    stage_rows["pipeline"] = phase_pipeline(device, card)
    stage_rows["backbones"] = phase_backbones(device, card, rows)
    stage_rows["determinism"] = phase_determinism()

    def extra(row):
        out = {"bound_f32_ms": row["bound_f32"][0]} if "bound_f32" in row else {}
        out.update({k: row[k] for k in ("graph_ms", "sinkhorn_iters") if k in row})
        return out

    # launches: the regression kernels on the main path (phase 3), the F=256
    # ones on the classification path (phase 6); each also by runner path,
    # the ViSNet and DimeNet runners' included (phase 10).
    # All three paths step through CUDA graphs: see the module docstring
    class_launches = stage_rows["classification"]["launches"]
    kernels = []
    for name in REPLACES:
        r = rows[name]["N32"]
        bound_ms, bound_by = r["bound"]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            "launches": totals[name] if name in REGRESSION else class_launches[name],
            "runner_launches": stage_rows["runner"]["launches"][name],
            "classification_launches": class_launches[name],
            **{f"{bb}_launches": stage_rows["backbones"][bb]["launches"][name] for bb in BACKBONES},
            "max_abs_err": max(rows[name][lab]["max_abs_err"] for lab in rows[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, **extra(r),
        })
        for lab, other in rows[name].items():
            if lab != "N32":
                kernels[-1][lab.lower()] = dict(
                    ms=other["ms"], plain_ms=other["plain_ms"], bound_ms=other["bound"][0],
                    **extra(other))
    flagship = stage_rows["graphs"]["stage 2 N32"]
    print(f"[done] {time.perf_counter() - t0:.1f} s; stage 2 {stage_rows[2]['step_ms']:.2f} ms/step"
          f" (phase 3, graphed); phase 8 at N=32: eager {min(flagship['eager_ms']):.3f}, graphed"
          f" {min(flagship['graphed_ms']):.3f} ms/step")
    print(json.dumps({"kernels": kernels, "launches_counted": LAUNCHES_COUNTED, "train": stage_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 4 and sys.argv[1] == "--determinism-worker":
        sys.exit(determinism_worker(sys.argv[2], sys.argv[3] == "1"))
    sys.exit(main())
