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

    python3 scripts/torch_fgw_probe.py [--pkg DIR] [--big [N ...] | --faults]

``--pkg`` takes the port's package (kernel source and wrapper) from another
checkout, by default this one, so that two versions of K3 can be measured
in one run on one card. The inputs always come from this checkout's
``chip_smoke.py``. ``--big`` measures the sets above 128 atoms instead of
those up to 128, at the N it names (by default 288 and 384), after a table
of the stream route's plan and the clusters the card holds at once for
each N and R, and of the global route's plan for each set where the
checkout has ``csrc/fgw_team.cu``. Above 512 atoms a set is phase 18b's
kind: S = 15 point clouds, first outer iteration and a later one whose M
differs from row to row (``chip_smoke.later_inputs``), and at N = 544 also
K3' at n = 520 (K = 5 solves padded to 544). ``--faults`` builds copies of
``csrc/fgw_team.cu`` with a fault planted (``FAULTS``: the plan left at
T0; product 1's or product 2's second row tile of 64 never written, its
rows of C1 T or of mr left as the zeroed scratch holds them), each alone into a
library of its own in a temporary directory, and runs each, and the
package's library as a control, on the later inputs at N = 544 and 800
against the plain version with ``chip_smoke.py``'s gate
(``fgw_limit(..., rel=True)``): it exits with 1 unless every fault
misses the gate and the control meets it. Prints, per input set:

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
   waits at the cluster barriers, apart (on the team kernel of
   ``csrc/fgw_team.cu``, the global route where a checkout has it, the waits at the
   team barriers, its phases summed over the solves a team takes in turn).
   On the stream route a product's phase holds its ring's waits and
   copies, and the first slice's prologue falls in the phase before it.

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
              "marginal check+flags", "candidate plan", "store", "cluster or team barriers"]
MAX_BLOCKS = 4096
NPH = 9  # phase counters a block
BIG_SEED = 6000  # chip_smoke.py's seed offset of phase 18's F=256 molecules
SPIN_CYCLES = 10_000_000  # ~5 ms on the card, longer than issuing 20 calls
# faults planted in csrc/fgw_team.cu by --faults, each (anchor, replacement)
FAULTS = {
    "plan left at T0": ("      if (!(frozen || bad)) {  // the candidate becomes T",
                        "      if (false) {  // the candidate becomes T"),
    "product 1's row tile 1 dropped": (
        "                     const int li = TILE * rtile + 16 * wq + g;\n",
        "                     if (rtile == 1) return;\n"
        "                     const int li = TILE * rtile + 16 * wq + g;\n"),
    "product 2's row tile 1 dropped": (
        "                            const int l0 = TILE * rtile + 16 * wq + g;\n",
        "                            if (rtile == 1) return;\n"
        "                            const int l0 = TILE * rtile + 16 * wq + g;\n"),
}
FAULT_BUILD_S = 900  # a fault's nvcc, at most


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
# the global route of csrc/fgw_team.cu (the region above is the one-CTA
# kernel in an older checkout's fgw.cu): the team barriers' waits apart
# (phase 8); the next Sinkhorn iteration's column partials count as columns
TEAM_EDITS = [
    ("namespace {\n", f"namespace {{\n__device__ long long g_phase[{MAX_BLOCKS}][{NPH}];\n"),
    ("  const int team = blockIdx.x / C, rank = blockIdx.x % C, tid = threadIdx.x;\n",
     "  const int team = blockIdx.x / C, rank = blockIdx.x % C, tid = threadIdx.x;\n" + _INIT),
    ("    // set-up: T's band", "    " + _ph(0) + "    // set-up: T's band"),
    ("      // product 1: C1 T", "      " + _ph(1) + "      // product 1: C1 T"),
    ("      // product 2: mr =", "      " + _ph(2) + "      // product 2: mr ="),
    ("      // log-domain Sinkhorn\n", "      " + _ph(3) + "      // log-domain Sinkhorn\n"),
    ("        // Sinkhorn columns:", "        " + _ph(3) + "        // Sinkhorn columns:"),
    ("        // Sinkhorn rows:", "        " + _ph(4) + "        // Sinkhorn rows:"),
    ("        // the band's column marginals", "        " + _ph(5) + "        // the band's column marginals"),
    ("        // the next iteration's column partials", "        " + _ph(3)
     + "        // the next iteration's column partials"),
    ("        bad_u = __syncthreads_or(bad_u);", "        " + _ph(5) + "        bad_u = __syncthreads_or(bad_u);"),
    ("      // candidate plan, into Tnext", "      " + _ph(6) + "      // candidate plan, into Tnext"),
    ("    // the final plan's band to Tout", "    " + _ph(7) + "    // the final plan's band to Tout"),
    ("    if (rank == 0 && tid == 0) {\n      div_out[s]",
     "    " + _ph(7) + "  " + _DUMP + "    if (rank == 0 && tid == 0) {\n      div_out[s]"),
    ('extern "C" {\n', 'extern "C" {\n'
     "int phase_dump_team(void* dst) { return (int)cudaMemcpyFromSymbol(dst, g_phase, sizeof(g_phase)); }\n"),
]
# every cluster barrier of the cluster route, apart (phase 8), and every
# team barrier of the global route
BARRIER = ("cluster.sync();", "{ const int sv_ = cur_; " + _ph(8).strip() + " cluster.sync(); "
           + _ph("sv_").strip() + " }")
TEAM_BARRIER = ("team_sync(counter, count, C);", "{ const int sv_ = cur_; " + _ph(8).strip()
                + " team_sync(counter, count, C); " + _ph("sv_").strip() + " }")


def _edit(src: str, edits) -> str:
    for old, new in edits:
        if old not in src:
            raise SystemExit(f"the source holds no copy of {old[:50]!r}")
        src = src.replace(old, new, 1)
    return src


def instrumented(src: str, kinds=tuple(BIG_EDITS)) -> str:
    """``fgw.cu`` with the clock64 edits of the templates and of the large
    routes ``kinds`` (each must be there)."""
    src = _edit(src, EDITS)
    for kind in kinds:
        begin, end, edits = BIG_EDITS[kind]
        if begin not in src:
            raise SystemExit(f"the source holds no {kind} route ({begin.strip()[:50]!r})")
        a = src.index(begin)
        b = src.index(end, a)
        region = _edit(src[a:b], edits)
        if kind != "global":
            region = region.replace(*BARRIER)
        src = src[:a] + region + src[b:]
    return src


def instrumented_team(src: str) -> str:
    """``fgw_team.cu`` with the clock64 edits of the global route."""
    return _edit(src, TEAM_EDITS).replace(*TEAM_BARRIER)


def build_phases(build, csrc: Path) -> ctypes.CDLL:
    """The instrumented K3 of the checkout whose sources are ``csrc``: its
    ``fgw.cu``, and its ``fgw_team.cu`` where it has one (then the global
    route's phases come from ``phase_dump_team``)."""
    out = build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "fgw_phases.cu", out / "fgw_phases.so"
    team = csrc / "fgw_team.cu"
    sources = [str(cu)]
    if team.exists():
        cu.write_text(instrumented((csrc / "fgw.cu").read_text(), ("cluster", "stream")))
        tcu = out / "fgw_team_phases.cu"
        tcu.write_text(instrumented_team(team.read_text()))
        sources.append(str(tcu))
    else:
        cu.write_text(instrumented((csrc / "fgw.cu").read_text()))
    res = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-I{csrc}", "-shared", *sources, "-o",
                          str(so)], capture_output=True, text=True)
    if res.returncode != 0:
        raise SystemExit(f"the instrumented K3 failed to build:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    for fn in ("fgw_couplings", "fgw_smem", "fgw_couplings_large", "fgw_large_scratch_floats",
               "fgw_couplings_cluster", "fgw_cluster_smem", "fgw_cluster_active",
               "fgw_couplings_stream", "fgw_stream_smem", "fgw_stream_plan", "fgw_stream_active",
               "fgw_team_plan"):
        if fn in build.SIGNATURES and hasattr(lib, fn):
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = build.SIGNATURES[fn]
    lib.phase_dump.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "phase_dump_team"):
        lib.phase_dump_team.argtypes = [ctypes.c_void_p]
    return lib


def big_launch(lib, kind, R, args, kw, sync=True, n=None, fill=None):
    """One launch of a large route of ``lib`` on ``args`` (the first ``n``
    atoms real, all by default): ``(T, diverged, iterations)``, after a
    synchronise unless ``sync`` is false (for capture into a graph). The
    global route's scratch holds ``fill`` where one is given."""
    import torch

    S, N, _ = args[0].shape
    n = N if n is None else n
    T = torch.empty_like(args[0])
    flags = torch.empty((2, S), dtype=torch.int32, device="cuda")
    solver = (kw["alpha"], kw["epsilon"], kw["pgd_iters"], kw["pgd_tol"], kw["sinkhorn_iters"],
              kw["sinkhorn_thr"])
    ptrs = (*(a.data_ptr() for a in args), T.data_ptr(), flags[0].data_ptr(), flags[1].data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "global":
        from conan_fgw_tpu_torch.ops.cuda import fgw as k3

        # the wrapper's plan; an older checkout's one-CTA kernel took 2 N^2 floats a solve
        floats = (k3._team_ready(N, S, torch.cuda.current_device()).scratch_floats
                  if hasattr(k3, "_team_ready") else lib.fgw_large_scratch_floats(S, N))
        scratch = (torch.empty(floats, device="cuda") if fill is None
                   else torch.full((floats,), fill, device="cuda"))
        code = lib.fgw_couplings_large(*ptrs, scratch.data_ptr(), S, N, n, *solver, stream)
    elif kind == "cluster":
        code = lib.fgw_couplings_cluster(*ptrs, S, N, n, R, *solver, stream)
    else:
        code = lib.fgw_couplings_stream(*ptrs, S, N, n, R, *solver, stream)
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


def team_table(lib, sets):
    """The global route's plan for each set's (N, S), where the library
    has one (``fgw_team_plan``)."""
    if not hasattr(lib, "fgw_team_plan"):
        return
    for label, args, _ in sets:
        S, N, _ = args[0].shape
        out = (ctypes.c_int * 9)()
        if lib.fgw_team_plan(S, N, 0, out) == 0:
            R, C, teams, rounds, passes, P, vec_smem, smem, _ = out
            print(f"[team table] {label} S={S} N={N}: R={R}, {C} CTAs a team, {teams} teams at"
                  f" once, {rounds} rounds, {passes} passes of {P} column tiles, {smem} shared"
                  f" bytes a CTA (vectors in {'shared' if vec_smem else 'device'} memory)")


def big_sets(smoke, sizes, torch):
    """``(label, args, n)`` of each N in ``sizes``: the F=256 molecules of
    ``chip_smoke.py``'s phase 18 at N <= 288 (first and second outer
    iteration), its point clouds elsewhere (first), S = 90 solves up to
    512 atoms and phase 18b's ``GLOBAL_S`` above (there also a later outer
    iteration, ``later_inputs``); at ``GLOBAL_N`` also K3' at n =
    ``GLOBAL_MOL`` (padded to N, K solves)."""
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
            sets += [(f"N{N}", args, N), (f"N{N}-outer2", smoke.second_outer_inputs(args, Ys, Cs), N)]
        else:
            atoms = clouds.get(N, (N - 31, N))
            mols = smoke.B_CLS if N <= 512 else smoke.GLOBAL_S // smoke.K
            pos, mask = smoke.cloud_geometry(smoke.SEED + 6100 + N, mols, atoms, N, "cuda")
            args, Ys, _ = smoke.fgw_problem(pos, mask, gen)
            sets.append((f"N{N}", args, N))
            if N > 512:
                sets.append((f"N{N}-later", smoke.later_inputs(args, Ys, gen), N))
        if N == smoke.GLOBAL_N:
            n = smoke.GLOBAL_MOL
            sets.append((f"mol{n}", smoke.mol_args(n, "cuda")[1], n))
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
    sets = big_sets(smoke, sizes, torch)
    team_table(lib, sets)
    for label, args, n in sets:
        S, N, _ = args[0].shape
        routes = [("global", 0)] + [("cluster", R) for R in (32, 64) if lib.fgw_cluster_smem(N, R)]
        if hasattr(lib, "fgw_couplings_stream"):
            routes += [("stream", R) for R in (48, 64, 96) if lib.fgw_stream_smem(N, R)]
        T_p, (div_p, _) = fgw_couplings_plain(*args, n=n, **kw)
        for kind, R in routes:
            name = kind if kind == "global" else f"{kind} R={R}"
            T, div, iters = big_launch(lib, kind, R, args, kw, n=n)
            err = float((T - T_p).abs().max())
            same = bool(torch.equal(div, div_p))
            again = big_launch(lib, kind, R, args, kw, n=n)[0]
            ms = smoke.cuda_ms(lambda: big_launch(lib, kind, R, args, kw, n=n), reps=10, warmup=2)
            replay = smoke.graph_ms(lambda: big_launch(lib, kind, R, args, kw, sync=False, n=n))
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
            big_launch(plib, kind, R, args, kw, n=n)
            buf = np.zeros((MAX_BLOCKS, NPH), np.int64)
            team = kind == "global" and hasattr(plib, "phase_dump_team")
            if (plib.phase_dump_team if team else plib.phase_dump)(buf.ctypes.data) != 0:
                raise SystemExit("the instrumented K3 failed")
            if team:  # the persistent grid: teams at once times the team's CTAs
                out = (ctypes.c_int * 9)()
                plib.fgw_team_plan(S, N, 0, out)
                blocks = out[1] * out[2]
            else:
                blocks = S * (1 if kind == "global" else N // R)
            b = buf[:blocks]
            tot = b.sum(1)
            print(f"[{label} {name}]   cycles per block: mean {tot.mean():.0f}, max {tot.max()};"
                  f" {blocks} blocks")
            for k, phase in enumerate(BIG_PHASES):
                if kind == "global" and k == 8 and not team:
                    continue
                print(f"[{label} {name}]   {phase:22s} {100 * b[:, k].sum() / tot.sum():5.1f}%,"
                      f" {b[:, k].mean():9.0f} cycles per block")


def probe_faults(smoke, build, lib, torch) -> int:
    """``--faults``: each of ``FAULTS`` built alone from this package's
    ``fgw_team.cu`` (all builds at once, in a temporary directory), then it
    and the package's library ``lib`` on the later sets at N = 544 and 800
    against the plain version; 1 unless every fault misses
    ``chip_smoke.fgw_limit``'s gate and ``lib`` meets it."""
    import tempfile

    from conan_fgw_tpu_torch.ops.cuda.fgw import fgw_couplings_plain

    src = (build.CSRC_DIR / "fgw_team.cu").read_text()
    kw = smoke.FGW_KW
    with tempfile.TemporaryDirectory(prefix="fgw_faults_") as tmp:
        jobs = {}
        for k, (name, (old, new)) in enumerate(FAULTS.items()):
            if src.count(old) != 1:
                raise SystemExit(f"fault {name!r}: the source holds {src.count(old)} copies of its anchor")
            cu, so = Path(tmp) / f"fault{k}.cu", Path(tmp) / f"fault{k}.so"
            cu.write_text(src.replace(old, new))
            jobs[name] = (so, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC_DIR}", "-shared", str(cu), "-o",
                 str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        libs = {"control (the package)": lib}
        for name, (so, proc) in jobs.items():
            try:
                log, _ = proc.communicate(timeout=FAULT_BUILD_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                raise SystemExit(f"fault {name!r}: nvcc ran past {FAULT_BUILD_S} s")
            if proc.returncode != 0:
                raise SystemExit(f"fault {name!r} failed to build:\n{log}")
            flib = ctypes.CDLL(str(so))
            flib.fgw_couplings_large.restype, flib.fgw_couplings_large.argtypes = \
                build.SIGNATURES["fgw_couplings_large"]
            libs[name] = flib
        ok = True
        for label, args, n in big_sets(smoke, (smoke.GLOBAL_N, smoke.GLOBAL_BIG), torch):
            if not label.endswith("-later"):
                continue
            T_p, (div_p, _) = fgw_couplings_plain(*args, n=n, **kw)
            for name, flib in libs.items():
                T, div, _ = big_launch(flib, "global", 0, args, kw, n=n, fill=0.0)
                err = float((T - T_p).abs().max())
                limit, moved = smoke.fgw_limit(T_p, args[5], True)
                caught = not (err <= limit and bool(torch.equal(div, div_p)))
                want = name in FAULTS
                ok = ok and caught == want
                print(f"[faults {label}] {name}: max_abs_err {err:.3e}, gate {limit:.3e} (the plain"
                      f" plan moved {moved:.3e} from T0), flags equal {bool(torch.equal(div, div_p))}:"
                      f" {'caught' if caught else 'passes'}"
                      f"{'' if caught == want else ' <- WRONG'}")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pkg", default=str(ROOT), help="checkout whose conan_fgw_tpu_torch is measured")
    ap.add_argument("--big", nargs="*", type=int, metavar="N",
                    help="measure the sets above 128 atoms alone, at these N (default 288 384)")
    ap.add_argument("--faults", action="store_true",
                    help="plant FAULTS in fgw_team.cu and show that the card check catches each")
    opts = ap.parse_args()
    pkg = Path(opts.pkg).resolve()
    sys.path.insert(0, str(pkg))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import conan_fgw_tpu_torch
    from conan_fgw_tpu_torch.device import pin_full_f32
    from conan_fgw_tpu_torch.ops.cuda import _build
    from conan_fgw_tpu_torch.ops.cuda.fgw import _couplings

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
    if opts.faults:
        return probe_faults(smoke, _build, package, torch)
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
        _, (_, iters) = _couplings(*args, **kw)
        for _ in range(3):
            _couplings(*args, **kw)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                _couplings(*args, **kw)
            torch.cuda.synchronize()
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and "fgw_couplings_kernel" in e.key]
        dev_ms = sum(e.self_device_time_total for e in dev) / max(1, sum(e.count for e in dev)) / 1e3
        ev_ms = smoke.cuda_ms(lambda: _couplings(*args, **kw), reps=50, warmup=5)
        batches = []
        for _ in range(20):
            torch.cuda._sleep(SPIN_CYCLES)
            t0 = time.perf_counter()
            for _ in range(20):
                _couplings(*args, **kw)
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
