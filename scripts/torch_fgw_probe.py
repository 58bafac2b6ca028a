#!/usr/bin/env python3
"""Where the FGW coupling kernel K3 (``conan_fgw_tpu_torch/csrc/fgw.cu``)
spends its time on one NVIDIA card, at ``chip_smoke.py``'s K3 inputs
(S = 120 solves at N = 32, 64, 96 and 128, and the barycenter's second outer
iteration at N = 32 and 64) and, above 128 atoms, on phase 18's kind of
input (S = 90 solves: the F=256 molecules at N = 192, 256 and 288, first
and second outer iteration; ``chip_smoke.py``'s point clouds at other N,
first outer iteration): there the global route beside the cluster route
with each compiled band height R, or the stream route with each R it has a
plan for.

    python3 scripts/torch_fgw_probe.py [--pkg DIR] [--big [N ...]]

``--pkg`` takes the port's package (kernel source and wrapper) from another
checkout, by default this one, so that two versions of K3 can be measured
in one run on one card. The inputs always come from this checkout's
``chip_smoke.py``. ``--big`` measures the sets above 128 atoms instead of
those up to 128, at the N it names (by default 288 and 384), after a table
of the stream route's plan and the clusters the card holds at once for
each N and R. Prints, per input set:

1. K3's device time per launch (``torch.profiler``), the CUDA-event time
   per call of back-to-back wrapper calls, their difference (the host time
   the card waits for between calls), and the host time to issue one call
   (host clock over 20 calls issued behind a spin kernel, so that every
   call only enqueues whatever the kernel's own length: the median and the
   least of 20 such runs, the least being the cost without interference
   from other work on a shared host); above 128 atoms instead each route's
   CUDA-event time over eager calls and over CUDA-graph replays, and its
   largest distance from the plain version;
2. K3's cycles by phase. A copy of the source gets ``clock64`` reads at each
   phase boundary; thread 0 of every block sums them, so a phase includes
   its barrier's wait for the slowest warp. The templates: set-up (loads,
   marginals, c1p/c2q); the two products and the gradient assembly; the
   Sinkhorn log-sum-exp updates; the column-marginal checks; the candidate
   plan and its acceptance; the final store. The global and the cluster
   route: set-up; product 1; product 2 with the gradient; the Sinkhorn
   column sweep (on the cluster routes its band partials and their
   combination); the row sweep; the marginal check with the flags; the
   candidate plan; the store; and, on the cluster and stream routes, the
   waits at the cluster barriers, apart. On the stream route a product's
   phase holds its ring's waits and copies, and the first slice's
   prologue falls in the phase before it.

Needs the CUDA toolkit and a card. Builds go to ``<DIR>/conan_fgw_tpu_torch/_build/probe``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
PHASES = ["set-up", "products+gradient", "Sinkhorn LSE", "marginal check", "candidate plan", "store"]
BIG_PHASES = ["set-up", "product 1", "product 2+gradient", "Sinkhorn columns", "Sinkhorn rows",
              "marginal check+flags", "candidate plan", "store", "cluster barriers"]
MAX_BLOCKS = 4096
NPH = 9  # phase counters a block
BIG_SEED = 6000  # chip_smoke.py's seed offset of phase 18's F=256 molecules
SPIN_CYCLES = 10_000_000  # ~5 ms on the card, longer than issuing 20 calls


def _tick(k: int) -> str:
    return f"{{ long long n_ = clock64(); ph_[{k}] += n_ - tc_; tc_ = n_; }}\n"


# (anchor, replacement): every anchor is a line that both the CUDA-core K3
# and its tensor-core redesign carry, so the same split applies to either;
# each edit goes to the anchor's first copy, the <N, PAD> templates' (the
# global route for N > 128 comes after them and repeats some anchors)
EDITS = [
    ("namespace {\n", f"namespace {{\n__device__ long long g_phase[{MAX_BLOCKS}][{NPH}];\n"),
    ("  const int s = blockIdx.x, tid = threadIdx.x;\n",
     "  const int s = blockIdx.x, tid = threadIdx.x;\n  long long ph_[8] = {}; long long tc_ = clock64();\n"),
    ("  bool frozen = false, diverged = false;", _tick(0) + "  bool frozen = false, diverged = false;"),
    ("    // log-domain Sinkhorn\n", "    " + _tick(1) + "    // log-domain Sinkhorn\n"),
    ("      if (si % 10 == 0) {", "      " + _tick(2) + "      if (si % 10 == 0) {"),
    ("      if (!newly_div) {", "      " + _tick(3) + "      if (!newly_div) {"),
    ("    // candidate plan, its finiteness and its distance to T\n",
     "    " + _tick(2) + "    // candidate plan, its finiteness and its distance to T\n"),
    ("    diverged = diverged || bad;\n  }\n", "    diverged = diverged || bad;\n    " + _tick(4) + "  }\n"),
    ("  if (tid == 0) {\n    div_out[s]",
     "  " + _tick(5) + "  if (tid == 0) for (int k_ = 0; k_ < 8; ++k_) g_phase[s][k_] = ph_[k_];\n"
     "  if (tid == 0) {\n    div_out[s]"),
    ('extern "C" {\n', 'extern "C" {\n'
     "int phase_dump(void* dst) { return (int)cudaMemcpyFromSymbol(dst, g_phase, sizeof(g_phase)); }\n"),
]


def _ph(k) -> str:
    """From here on the block's cycles go to phase ``k`` (an int or a name)."""
    return f"{{ long long n_ = clock64(); ph_[cur_] += n_ - tc_; tc_ = n_; cur_ = {k}; }}\n"


_INIT = "  long long ph_[9] = {}; long long tc_ = clock64(); int cur_ = 0;\n"
_DUMP = "  if (tid == 0) for (int k_ = 0; k_ < 9; ++k_) g_phase[blockIdx.x][k_] = ph_[k_];\n"
# The large routes, each (first line of its region, line after it, edits):
# every edit goes to its anchor's first copy inside the region.
BIG_EDITS = {
    "global": ("    fgw_couplings_large_kernel(const float* __restrict__ Ms,", "// -------", [
        ("  const int s = blockIdx.x, tid = threadIdx.x;\n",
         "  const int s = blockIdx.x, tid = threadIdx.x;\n" + _INIT),
        ("    // A = C1 @ T\n", "    " + _ph(1) + "    // A = C1 @ T\n"),
        ("    // mr = -(2 alpha", "    " + _ph(2) + "    // mr = -(2 alpha"),
        ("      int bad = lse_cols(", "      " + _ph(3) + "      int bad = lse_cols("),
        ("      bad |= lse_rows(", "      " + _ph(4) + "      bad |= lse_rows("),
        ("      const bool newly_div = __syncthreads_or(bad) != 0;",
         "      " + _ph(5) + "      const bool newly_div = __syncthreads_or(bad) != 0;"),
        ("    // the candidate plan's finiteness and distance to T\n",
         "    " + _ph(6) + "    // the candidate plan's finiteness and distance to T\n"),
        ("  if (tid == 0) {\n    div_out[s]", "  " + _ph(7) + _DUMP + "  if (tid == 0) {\n    div_out[s]"),
    ]),
    "cluster": ("    fgw_couplings_cluster_kernel(const float* __restrict__ Ms,", "// The cluster route's instantiations", [
        ("  const int s = blockIdx.x / C, tid = threadIdx.x;\n",
         "  const int s = blockIdx.x / C, tid = threadIdx.x;\n" + _INIT),
        ("    // product 1:", "    " + _ph(1) + "    // product 1:"),
        ("    // product 2:", "    " + _ph(2) + "    // product 2:"),
        ("      // Sinkhorn columns", "      " + _ph(3) + "      // Sinkhorn columns"),
        ("      // Sinkhorn rows", "      " + _ph(4) + "      // Sinkhorn rows"),
        ("      // marginal check and flags", "      " + _ph(5) + "      // marginal check and flags"),
        ("    // candidate plan", "    " + _ph(6) + "    // candidate plan"),
        ("  // store", "  " + _ph(7) + "  // store"),
        ("  cluster.sync();  // no CTA leaves", "  " + _ph(7) + _DUMP + "  cluster.sync();  // no CTA leaves"),
    ]),
    "stream": ("    fgw_couplings_stream_kernel(const float* __restrict__ Ms,", "// The launch configuration of the stream", [
        ("  const int s = blockIdx.x / C, tid = threadIdx.x;\n",
         "  const int s = blockIdx.x / C, tid = threadIdx.x;\n" + _INIT),
        ("      if (STAGES == 3) cp_async_wait<1>();",
         "      " + _ph("(x / KN) % 2 == 0 ? 1 : 2") + "      if (STAGES == 3) cp_async_wait<1>();"),
        ("      // Sinkhorn columns", "      " + _ph(3) + "      // Sinkhorn columns"),
        ("      // Sinkhorn rows", "      " + _ph(4) + "      // Sinkhorn rows"),
        ("      // marginal check and flags", "      " + _ph(5) + "      // marginal check and flags"),
        ("    // candidate plan", "    " + _ph(6) + "    // candidate plan"),
        ("  cluster.sync();  // no CTA leaves", "  " + _ph(7) + _DUMP + "  cluster.sync();  // no CTA leaves"),
    ]),
}
# every cluster barrier of the cluster route, apart (phase 8)
BARRIER = ("cluster.sync();", "{ const int sv_ = cur_; " + _ph(8).strip() + " cluster.sync(); "
           + _ph("sv_").strip() + " }")


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"the source holds no copy of {old[:50]!r}")
        src = src.replace(old, new, 1)
    return src


def instrumented(src: str) -> str:
    src = _edit(src, EDITS)
    for kind, (begin, end, edits) in BIG_EDITS.items():
        if begin not in src:
            raise SystemExit(f"the source holds no {kind} route ({begin.strip()[:50]!r})")
        a = src.index(begin)
        b = src.index(end, a)
        region = _edit(src[a:b], edits)
        if kind != "global":
            region = region.replace(*BARRIER)
        src = src[:a] + region + src[b:]
    return src


def build_phases(build, csrc: Path) -> ctypes.CDLL:
    out = build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "fgw_phases.cu", out / "fgw_phases.so"
    cu.write_text(instrumented((csrc / "fgw.cu").read_text()))
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", str(cu), "-o", str(so)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"the instrumented K3 failed to build:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn in ("fgw_couplings", "fgw_smem", "fgw_couplings_large", "fgw_large_scratch_floats",
               "fgw_couplings_cluster", "fgw_cluster_smem", "fgw_cluster_active",
               "fgw_couplings_stream", "fgw_stream_smem", "fgw_stream_plan", "fgw_stream_active"):
        if fn in build.SIGNATURES:
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = build.SIGNATURES[fn]
    lib.phase_dump.argtypes = [ctypes.c_void_p]
    return lib


def big_launch(lib, kind, R, args, kw, sync=True):
    """One launch of a large route of ``lib`` on ``args`` (all N atoms
    real): ``(T, diverged, iterations)``, after a synchronise unless
    ``sync`` is false (for capture into a graph)."""
    import torch

    S, N, _ = args[0].shape
    T = torch.empty_like(args[0])
    flags = torch.empty((2, S), dtype=torch.int32, device="cuda")
    solver = (kw["alpha"], kw["epsilon"], kw["pgd_iters"], kw["pgd_tol"], kw["sinkhorn_iters"],
              kw["sinkhorn_thr"])
    ptrs = (*(a.data_ptr() for a in args), T.data_ptr(), flags[0].data_ptr(), flags[1].data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "global":
        scratch = torch.empty(lib.fgw_large_scratch_floats(S, N), device="cuda")
        code = lib.fgw_couplings_large(*ptrs, scratch.data_ptr(), S, N, N, *solver, stream)
    elif kind == "cluster":
        code = lib.fgw_couplings_cluster(*ptrs, S, N, N, R, *solver, stream)
    else:
        code = lib.fgw_couplings_stream(*ptrs, S, N, N, R, *solver, stream)
    if code != 0:
        raise SystemExit(f"the {kind} route (R={R}) failed with CUDA error {code}")
    if sync:
        torch.cuda.synchronize()
    return T, flags[0], flags[1]


def stream_table(lib):
    """The stream route's plan, shared bytes and clusters at once for each
    N and R it has a plan for."""
    for N in range(288, 513, 32):
        for R in (48, 64, 96):
            smem = lib.fgw_stream_smem(N, R)
            if not smem:
                continue
            plan, active = lib.fgw_stream_plan(N, R), lib.fgw_stream_active(N, R)
            rounds = -(-90 // active) if active > 0 else None
            print(f"[stream table] N={N} R={R}: {N // R} CTAs, SUB={plan // 10000}"
                  f" KS={plan // 100 % 100} stages={plan % 100}, {smem} shared bytes a CTA,"
                  f" {active} clusters at once, {rounds} rounds at S=90")


def big_sets(smoke, sizes, torch):
    """``(label, args)`` of each N in ``sizes``: the F=256 molecules of
    ``chip_smoke.py``'s phase 18 at N <= 288 (first and second outer
    iteration), its point clouds elsewhere (first)."""
    gen = torch.Generator().manual_seed(smoke.SEED + 18)
    heavy = {N: h for _, h, N in smoke.BIG_SHAPES}
    heavy[smoke.STREAM_SHAPE[2]] = smoke.STREAM_SHAPE[1]
    clouds = dict(smoke.STREAM_CLOUDS)
    sets = []
    for N in sizes:
        if N in heavy:
            pos, mask = smoke.packed_geometry(smoke.SEED + BIG_SEED + N, smoke.B_CLS, heavy[N], N,
                                              "cuda")
            args, Ys, Cs = smoke.fgw_problem(pos, mask, gen)
            sets += [(f"N{N}", args), (f"N{N}-outer2", smoke.second_outer_inputs(args, Ys, Cs))]
        else:
            atoms = clouds.get(N, (N - 31, N))
            pos, mask = smoke.cloud_geometry(smoke.SEED + 6100 + N, smoke.B_CLS, atoms, N, "cuda")
            sets.append((f"N{N}", smoke.fgw_problem(pos, mask, gen)[0]))
    return sets


def probe_big(smoke, lib, plib, torch, sizes):
    """The sets of ``big_sets``: the global route and the cluster route at
    each compiled R, or the stream route at each R with a plan, timed on
    the package's library ``lib`` and split by phase on the instrumented
    copy ``plib``."""
    from conan_fgw_tpu_torch.ops.cuda.fgw import fgw_couplings_plain

    kw = smoke.FGW_KW
    if hasattr(lib, "fgw_couplings_stream"):
        stream_table(lib)
    for label, args in big_sets(smoke, sizes, torch):
        S, N, _ = args[0].shape
        routes = [("global", 0)] + [("cluster", R) for R in (32, 64) if lib.fgw_cluster_smem(N, R)]
        if hasattr(lib, "fgw_couplings_stream"):
            routes += [("stream", R) for R in (48, 64, 96) if lib.fgw_stream_smem(N, R)]
        T_p, div_p = fgw_couplings_plain(*args, **kw)
        for kind, R in routes:
            name = kind if kind == "global" else f"{kind} R={R}"
            T, div, iters = big_launch(lib, kind, R, args, kw)
            err = float((T - T_p).abs().max())
            same = bool(torch.equal(div, div_p))
            again = big_launch(lib, kind, R, args, kw)[0]
            ms = smoke.cuda_ms(lambda: big_launch(lib, kind, R, args, kw), reps=10, warmup=2)
            replay = smoke.graph_ms(lambda: big_launch(lib, kind, R, args, kw, sync=False))
            extra = ""
            if kind == "cluster":
                extra = (f"; {N // R} CTAs of {lib.fgw_cluster_smem(N, R)} bytes a cluster,"
                         f" {lib.fgw_cluster_active(N, R)} clusters at once")
            elif kind == "stream":
                plan = lib.fgw_stream_plan(N, R)
                extra = (f"; {N // R} CTAs of {lib.fgw_stream_smem(N, R)} bytes a cluster"
                         f" (SUB={plan // 10000} KS={plan // 100 % 100} stages={plan % 100}),"
                         f" {lib.fgw_stream_active(N, R)} clusters at once")
            print(f"[{label} {name}] S={S}: {ms:.4f} ms (eager, synchronised), graph replays"
                  f" {replay:.4f} ms; max_abs_err {err:.3e} from the plain version, flags equal"
                  f" {same}, bits equal on a second launch {bool(torch.equal(T, again))};"
                  f" {int(iters.sum())} Sinkhorn iterations{extra}")
            big_launch(plib, kind, R, args, kw)
            buf = np.zeros((MAX_BLOCKS, NPH), np.int64)
            if plib.phase_dump(buf.ctypes.data) != 0:
                raise SystemExit("the instrumented K3 failed")
            blocks = S * (1 if kind == "global" else N // R)
            b = buf[:blocks]
            tot = b.sum(1)
            print(f"[{label} {name}]   cycles per block: mean {tot.mean():.0f}, max {tot.max()};"
                  f" {blocks} blocks")
            for k, phase in enumerate(BIG_PHASES):
                if kind == "global" and k == 8:
                    continue
                print(f"[{label} {name}]   {phase:22s} {100 * b[:, k].sum() / tot.sum():5.1f}%,"
                      f" {b[:, k].mean():9.0f} cycles per block")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pkg", default=str(ROOT), help="checkout whose conan_fgw_tpu_torch is measured")
    ap.add_argument("--big", nargs="*", type=int, metavar="N",
                    help="measure the sets above 128 atoms alone, at these N (default 288 384)")
    opts = ap.parse_args()
    pkg = Path(opts.pkg).resolve()
    sys.path.insert(0, str(pkg))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import conan_fgw_tpu_torch
    from conan_fgw_tpu_torch.device import pin_full_f32
    from conan_fgw_tpu_torch.ops.cuda import _build
    from conan_fgw_tpu_torch.ops.cuda.fgw import _launch

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        print("torch_fgw_probe: no CUDA device is available", file=sys.stderr)
        return 2
    pin_full_f32()
    print(smoke.card_line())
    print(f"package {Path(conan_fgw_tpu_torch.__file__).parent}")
    package = _build.load_library()
    lib = build_phases(_build, _build.CSRC_DIR)
    if opts.big is not None:
        probe_big(smoke, package, lib, torch, opts.big or (288, 384))
        return 0
    kw = smoke.FGW_KW
    gen = torch.Generator().manual_seed(smoke.SEED)
    sets = []
    for label, heavy, n in smoke.FGW_SHAPES:  # the same draws, in order, as chip_smoke.py
        pos, mask = smoke.packed_geometry(smoke.SEED + n, smoke.B, heavy, n, "cuda")
        if n <= 64:
            smoke.cfconv_params(pos.shape[0], n, gen, "cuda")
        args, Ys, Cs = smoke.fgw_problem(pos, mask, gen)
        sets.append((label, args))
        if n <= 64:
            sets.append((f"{label}-outer2", smoke.second_outer_inputs(args, Ys, Cs)))
    for label, args in sets:
        S, N, _ = args[0].shape
        _, _, iters = _launch(*args, **kw)
        for _ in range(3):
            _launch(*args, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                _launch(*args, **kw)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and "fgw_couplings_kernel" in e.key]
        dev_ms = sum(e.self_device_time_total for e in dev) / max(1, sum(e.count for e in dev)) / 1e3
        ev_ms = smoke.cuda_ms(lambda: _launch(*args, **kw), reps=50, warmup=5)
        batches = []
        for _ in range(20):
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            for _ in range(20):
                _launch(*args, **kw)
            batches.append((time.perf_counter() - t0) / 20 * 1e6)
            torch.cuda.synchronize()
        host_us, host_min = float(np.median(batches)), min(batches)
        print(f"[{label}] S={S} N={N}: device {dev_ms:.4f} ms per launch, events {ev_ms:.4f} ms per call,"
              f" events - device {1e3 * (ev_ms - dev_ms):.1f} us; host {host_us:.1f} us (least {host_min:.1f})"
              f" to issue a call;"
              f" {int(iters.sum())} Sinkhorn iterations")

        resident = int(lib.fgw_smem(N, 1) <= _build.MAX_SMEM_BYTES)
        T = torch.empty_like(args[0])
        flags = torch.empty((2, S), dtype=torch.int32, device="cuda")
        # the atom count n (all N real) where the measured K3 takes one
        n_arg = (N,) if len(_build.SIGNATURES["fgw_couplings"][1]) > 19 else ()
        code = lib.fgw_couplings(*(a.data_ptr() for a in args), T.data_ptr(), flags[0].data_ptr(),
                                 flags[1].data_ptr(), S, N, *n_arg, resident, kw["alpha"], kw["epsilon"],
                                 kw["pgd_iters"], kw["pgd_tol"], kw["sinkhorn_iters"],
                                 kw["sinkhorn_thr"], torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        buf = np.zeros((MAX_BLOCKS, 8), np.int64)
        if code != 0 or lib.phase_dump(buf.ctypes.data) != 0:
            raise SystemExit("the instrumented K3 failed")
        b = buf[:S, :6]
        tot = b.sum(1)
        sk = flags[1].cpu().numpy()
        print(f"[{label}]   cycles per block: mean {tot.mean():.0f}, max {tot.max()};"
              f" Sinkhorn iterations per block mean {sk.mean():.2f}, max {sk.max()}")
        for k, name in enumerate(PHASES):
            print(f"[{label}]   {name:18s} {100 * b[:, k].sum() / tot.sum():5.1f}%,"
                  f" {b[:, k].mean():8.0f} cycles per block")
        per_it = b[:, 2].sum() / max(1, sk.sum())
        print(f"[{label}]   Sinkhorn LSE {per_it:.0f} cycles per iteration; products+gradient"
              f" {b[:, 1].mean() / kw['pgd_iters']:.0f} per PGD step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
