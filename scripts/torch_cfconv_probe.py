#!/usr/bin/env python3
"""Where the cfconv kernels K1/K2 spend their time on one NVIDIA card.

    PYTHONPATH=. python3 scripts/torch_cfconv_probe.py [--pkg DIR] [--big [N ...]]

Without ``--big``: ``conan_fgw_tpu_torch/csrc/cfconv.cu``'s kernels at
``chip_smoke.py``'s kernel-check inputs (G = 120 graphs at N = 32 and at
N = 64, F = 128, 50 Gaussians). Prints, per shape:
1. each kernel's device time per launch (``torch.profiler``);
2. the CUDA-event time of the source as it is (``base``) and of textual
   variants, each built into its own library: ``no_mma`` (the tensor-core
   products skipped),
   ``one_pass`` (only a_big b_big of the 3xTF32 split kept). Their results are wrong;
   only the times say something;
3. K1's and K2's cycles by phase: thread 0 of every team reads ``clock64``
   at each phase boundary (for K1: set-up of an item; gather, RBF and the
   first barrier; layer 1; layer 2 and the message; the row sums; the row
   store; K2 has its backward products as phases too),
   with the items and tiles each team took.

With ``--big``: the route above 128 atoms at the N it names (by default
192), on ``chip_smoke.py`` phase 18a's inputs (G = 90 graphs, F = 128 with
50 Gaussians and F = 256 with 10, the index cap; K2 at F = 128 also with
the nearest cap and in bf16 and f16): the CUDA-event ms of the package's
``cfconv_forward`` and ``cfconv_backward`` and the cycles by phase of a
``clock64`` copy of ``csrc/cfconv_wgmma.cu``, one counter set a team
(K1's and the F = 256 dx kernel's body, the F = 256 weight-gradient
kernel, and K2 at F = 128's kernel, a team its warpgroup: layer 1, the
softplus and h's stores, layer 2, the message's dx sums, dW's stores, P4,
P3, P5), the share of the slowest team's cycles in the mean's. ``--pkg`` takes the package (kernel sources and wrapper) from
another checkout, e.g. the parent commit unpacked with ``git archive <rev>
conan_fgw_tpu_torch`` into ``outputs/parent/``; the inputs always come
from this checkout's ``chip_smoke.py``, so two runs in one chip call
measure two versions on the same inputs on one card.

Needs the CUDA toolkit and a card. Builds go to
``<DIR>/conan_fgw_tpu_torch/_build/probe``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
MAX_TEAMS = 4096


def _tick(k: int) -> str:
    return f"{{ long long n_ = clock64(); ph_[{k}] += n_ - tc_; tc_ = n_; }}\n"


_INIT = "  long long ph_[10] = {}; long long tc_ = clock64();\n"
# one counter array a kernel (g_phase, g_phase2, g_phase3), read by phase_dump<k>
_ARRAYS = ("g_phase", "g_phase2", "g_phase3")
_DECLS = "namespace {\n" + "".join(f"__device__ long long {a}[{MAX_TEAMS}][10];\n" for a in _ARRAYS)
_DUMPS = ('extern "C" {\n', 'extern "C" {\n' + "".join(
    f"int {a.replace('g_phase', 'phase_dump')}(void* dst) {{ return (int)cudaMemcpyFromSymbol(dst, {a},"
    f" sizeof({a})); }}\n" for a in _ARRAYS))


def _dump(arr: str, team: str, tiles: str, first: str = "threadIdx.x == 0") -> str:
    return (f"  if ({first}) {{ for (int k_ = 0; k_ < 9; ++k_) {arr}[{team}][k_] = ph_[k_];"
            f" {arr}[{team}][9] = {tiles}; }}\n")


# csrc/cfconv_wgmma.cu's phases: (kernel, the calls it serves, its counter
# array, phase names, edits); a call is "K1" or "K2", or with its width
# ("K2@128"). Every edit goes to the first copy of its anchor after the
# kernel's first line.
BIG_SOURCE = "cfconv_wgmma.cu"
BIG_PHASES = [
        ("msg_body(", ("K1", "K2@256"), "g_phase", ["ring wait+barrier", "item switch+records", "gathers sent", "rbf+layer 1 (wgmma)",
                       "ssp+split", "layer 2 (wgmma)", "message+row sums", "last rows"], [
            ("  if (run.lo < run.hi) fetch_tile(ring, edges, run.lo);\n",
             "  if (run.lo < run.hi) fetch_tile(ring, edges, run.lo);\n" + _INIT),
            ("    const int item = l.tile_item[t];\n", "    " + _tick(0) + "    const int item = l.tile_item[t];\n"),
            ("    // -- the gathered rows", "    " + _tick(1) + "    // -- the gathered rows"),
            ("    uint32_t rb[KG / 8][4], rs[KG / 8][4];\n    const float d1", "    " + _tick(2)
             + "    uint32_t rb[KG / 8][4], rs[KG / 8][4];\n    const float d1"),
            ("      fence_regs(acc1);\n", "      fence_regs(acc1);\n      " + _tick(3)),
            ("      wg_fence();\n#pragma unroll\n      for (int s = 0; s < HC / 8; ++s) {",
             "      " + _tick(4) + "      wg_fence();\n#pragma unroll\n      for (int s = 0; s < HC / 8; ++s) {"),
            ("      fence_regs(acc2);\n    });\n", "      fence_regs(acc2);\n      " + _tick(5) + "    });\n"),
            ("e1, e2, lo, hi, rows[m]);\n    });\n",
             "e1, e2, lo, hi, rows[m]);\n    });\n    " + _tick(6)),
            ("  if (cur >= 0) put_rows<F, FO, MC>(out, rows, gidx, key0 + w, n, o0, lane);\n}\n",
             "  if (cur >= 0) put_rows<F, FO, MC>(out, rows, gidx, key0 + w, n, o0, lane);\n  " + _tick(7)
             + _dump("g_phase", "blockIdx.x * 2 + wg()", "run.hi - run.lo", "(threadIdx.x & 127) == 0") + "}\n"),
        ]),
        ("cfconv_dw_wgmma_kernel(", ("K2@256",), "g_phase2", ["top: barrier, records, gathers", "dW+P3 (wgmma)",
                                     "rbf+P1 (wgmma)+h, dpre+sync", "P4 (wgmma)+db2",
                                     "dpre^T+sync", "P5 (wgmma)+db1"], [
            ("  for (int t = lo; t < hi; ++t) {\n",
             _INIT + "  for (int t = lo; t < hi; ++t) {\n"),
            ("    // -- P3: dh = dW W2", "    " + _tick(0) + "    // -- P3: dh = dW W2"),
            ("    // -- P1: pre = rbf W1", "    " + _tick(1) + "    // -- P1: pre = rbf W1"),
            ("    // -- P4: dW2", "    " + _tick(2) + "    // -- P4: dW2"),
            ("    // dpre to dpre^T", "    " + _tick(3) + "    // dpre to dpre^T"),
            ("    // -- P5: dW1", "    " + _tick(4) + "    // -- P5: dW1"),
            ("      for (int i = 0; i < KG / 2; ++i) dw1[i] += tw[i];\n    }\n  }\n",
             "      for (int i = 0; i < KG / 2; ++i) dw1[i] += tw[i];\n    }\n    " + _tick(5) + "  }\n"),
            ("  float* out = partial + (size_t)blockIdx.x * C::PARTIAL;\n",
             _dump("g_phase2", "blockIdx.x", "hi - lo") + "  float* out = partial + (size_t)blockIdx.x * C::PARTIAL;\n"),
        ]),
        ("cfconv_bwd_wgmma_kernel(", ("K2@128",), "g_phase3", [
            "tile top: barrier, records, item switch, RBF and S stores, barrier", "layer 1 (P1, wgmma)",
            "softplus and h's split stores, barrier", "layer 2 (P2, wgmma), g gathers behind it",
            "message, P0 (dx sums, wgmma)", "barrier, dW's split stores, RBF again, barrier", "P4 (wgmma)",
            "P3 (wgmma)", "dpre, P5 (wgmma), dW1 partial adds"], [
            ("  int next = run.lo < run.hi ? l.tile_item[run.lo] : -1;\n",
             "  int next = run.lo < run.hi ? l.tile_item[run.lo] : -1;\n" + _INIT + "  int tiles_ = 0;\n"),
            ("    // -- P1^T: pre^T", "    " + _tick(0) + "    ++tiles_;\n    // -- P1^T: pre^T"),
            ("(gs + 7) / 8, t4, [] {});\n", "(gs + 7) / 8, t4, [] {});\n      " + _tick(1)),
            ("    // -- P2^T: W^T", "    " + _tick(2) + "    // -- P2^T: W^T"),
            ("      });\n      // the message", "      });\n      " + _tick(3) + "      // the message"),
            ("      fence_regs(dxacc);\n", "      fence_regs(dxacc);\n      " + _tick(4)),
            ("    // -- P4^T:", "    " + _tick(5) + "    // -- P4^T:"),
            ("    // -- P3^T:", "    " + _tick(6) + "    // -- P3^T:"),
            ("      weight_chain<F / 8>(acc, w2r, WS2, 1, r0, d_eb, d_es, F / 8, t4, [] {});\n",
             "      weight_chain<F / 8>(acc, w2r, WS2, 1, r0, d_eb, d_es, F / 8, t4, [] {});\n      " + _tick(7)),
            ("(i & 1)] += acc[i];\n    }\n", "(i & 1)] += acc[i];\n    }\n    " + _tick(8)),
            ("  if (cur >= 0) put_dx();\n",
             _dump("g_phase3", "blockIdx.x * 2 + wg()", "tiles_", "(threadIdx.x & 127) == 0")
             + "  if (cur >= 0) put_dx();\n"),
        ]),
]


def instrument_big(src: str) -> str:
    """``BIG_SOURCE`` with the phase counters (a kernel of ``BIG_PHASES``
    that the source does not hold is left out)."""
    src = src.replace("namespace {\n", _DECLS, 1).replace(*_DUMPS, 1)
    for kernel, _, _, _, edits in BIG_PHASES:
        if kernel not in src:
            continue
        at = src.index(kernel)
        for old, new in edits:
            k = src.find(old, at)
            if k < 0:
                raise SystemExit(f"{BIG_SOURCE}: {kernel} no longer holds {old[:60]!r}")
            src = src[:k] + new + src[k + len(old):]
    return src


def build_big(build, csrc: Path):
    """``BIG_SOURCE`` instrumented and built into a library of its own with
    csrc/cfconv.cu."""
    out = build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"phases_{BIG_SOURCE}", out / f"phases_{Path(BIG_SOURCE).stem}.so"
    cu.write_text(instrument_big((csrc / BIG_SOURCE).read_text()))
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-shared", str(cu),
                           str(csrc / "cfconv.cu"), "-o", str(so)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"the instrumented {BIG_SOURCE} failed to build:\n{proc.stdout}")
    lib = ctypes.CDLL(str(so))
    for fn, (restype, argtypes) in build.SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
    for array in _ARRAYS:
        getattr(lib, array.replace("g_phase", "phase_dump")).argtypes = [ctypes.c_void_p]
    return lib


def print_split(label, buf, teams, names):
    b = buf[:teams]
    tot = b[:, :len(names)].sum(1)
    busy = tot[tot > 0]
    print(f"[{label}] cycles per team: mean {busy.mean():.0f}, max {busy.max()} ({busy.max() / busy.mean():.2f}x"
          f" the mean) over {len(busy)} teams; tiles mean {b[:, 9].mean():.1f}, max {b[:, 9].max()}")
    for k, name in enumerate(names):
        print(f"[{label}]   {name:38s} {100 * b[:, k].sum() / tot.sum():5.1f}%,"
              f" {b[:, k].sum() / max(1, b[:, 9].sum()):8.0f} cycles per tile")


def probe_big(smoke, torch, sizes):
    from torch.profiler import ProfilerActivity, profile

    from conan_fgw_tpu_torch.ops.cuda import _build
    from conan_fgw_tpu_torch.ops.cuda import cfconv as k12

    lib = build_big(_build, _build.CSRC_DIR)
    print(f"[big] instrumented {BIG_SOURCE}")
    held = (_build.CSRC_DIR / BIG_SOURCE).read_text()
    shapes = {n: (label, heavy) for label, heavy, n in smoke.BIG_SHAPES}
    package = _build.load_library
    gen = torch.Generator().manual_seed(smoke.SEED + 18)
    for N in sizes:
        label, heavy = shapes.get(N, (f"N{N}", (N // 2 + 8, N // 2 + 16)))
        for seed, F, Gs in ((5000, smoke.F, smoke.GAUSS), (6000, smoke.F_CLS, smoke.GAUSS_CLS)):
            pos, mask = smoke.packed_geometry(smoke.SEED + seed + N, smoke.B_CLS, heavy, N, "cuda")
            maskf = mask.float().contiguous()
            x, w1, b1, w2, b2, cot = smoke.cfconv_params(pos.shape[0], N, gen, "cuda", F, Gs)
            args = (pos, maskf, x, w1, b1, w2, b2)
            tag = f"{label} F{F}"
            fwd = smoke.cuda_ms(lambda: k12.cfconv_forward(*args, smoke.CUTOFF, smoke.CAP), reps=20)
            bwd = smoke.cuda_ms(lambda: k12.cfconv_backward(*args, cot, smoke.CUTOFF, smoke.CAP), reps=20)
            print(f"[{tag}] G={pos.shape[0]} edges={smoke.count_edges(pos, mask, smoke.CAP)}: K1 {fwd:.4f} ms,"
                  f" K2 {bwd:.4f} ms (events, the package's wrappers)")
            if F == smoke.F:  # phase 18a's other K2 rows at this width
                extra = {"nearest": smoke.cuda_ms(lambda: k12.cfconv_backward(
                    *args, cot, smoke.CUTOFF, smoke.CAP, "nearest"), reps=20)}
                for dtype in (torch.bfloat16, torch.float16):
                    narrow = (pos, maskf, x.to(dtype), *args[3:])
                    extra[str(dtype).split(".")[1]] = smoke.cuda_ms(lambda: k12.cfconv_backward(
                        *narrow, cot.to(dtype), smoke.CUTOFF, smoke.CAP), reps=20)
                print(f"[{tag}] K2 at the nearest cap, in bf16, in f16: " + ", ".join(
                    f"{k} {v:.4f} ms" for k, v in extra.items()) + " (events, the package's wrappers)")
            leaves = [t.clone().requires_grad_(True) for t in args[2:]]
            ref = k12._cfconv_plain(pos, maskf, *leaves, smoke.CUTOFF, Gs, smoke.CAP)
            refs = (ref.detach(), *torch.autograd.grad(ref, leaves, cot))
            got = (k12.cfconv_forward(*args, smoke.CUTOFF, smoke.CAP),
                   *k12.cfconv_backward(*args, cot, smoke.CUTOFF, smoke.CAP))
            print(f"[{tag}] largest distance from the plain version, of the largest element: " + " ".join(
                f"{n} {float((a - b).abs().max() / b.abs().max()):.3e}"
                for n, a, b in zip(("out", "dx", "dw1", "db1", "dw2", "db2"), got, refs)))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    k12.cfconv_forward(*args, smoke.CUTOFF, smoke.CAP)
                    k12.cfconv_backward(*args, cot, smoke.CUTOFF, smoke.CAP)
                torch.cuda.synchronize()
            for e in prof.key_averages():
                if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                    kname = e.key.replace("(anonymous namespace)::", "").split("(")[0]
                    print(f"[{tag}]   device {kname[:60]:60s} {e.self_device_time_total / e.count / 1e3:.4f} ms"
                          f" a launch (x{e.count})")
            try:
                for kind, call in (("K1", lambda: k12.cfconv_forward(*args, smoke.CUTOFF, smoke.CAP)),
                                   ("K2", lambda: k12.cfconv_backward(*args, cot, smoke.CUTOFF, smoke.CAP))):
                    k12._build.load_library = lambda: lib
                    call()
                    torch.cuda.synchronize()
                    for kernel, serves, array, names, _ in BIG_PHASES:
                        # the kernels this call ran: at F=256 the wgmma route's K2
                        # is the message body (dx) and the weight-gradient kernel
                        if kernel not in held or not {kind, f"{kind}@{F}"} & set(serves):
                            continue
                        buf = np.zeros((MAX_TEAMS, 10), np.int64)
                        if getattr(lib, array.replace("g_phase", "phase_dump"))(buf.ctypes.data) != 0:
                            raise SystemExit("reading the phase counters failed")
                        print_split(f"{tag} {kind} {kernel.rstrip('(')}", buf, MAX_TEAMS, names)
            finally:
                k12._build.load_library = package


VARIANTS = {
    "base": [],
    "no_mma": [("  static_assert(K % 8 == 0, \"mma.m16n8k8 steps\");\n",
                "  static_assert(K % 8 == 0, \"mma.m16n8k8 steps\");\n  if (K > 0) return;\n")],
    "one_pass": [(f"mma_tf32(acc[mt][nt], {a}, {b});", ";")
                 for a, b in (("as[mt]", "bb[nt]"), ("ab[mt]", "bs[nt]"), ("as[mt]", "bb"), ("ab[mt]", "bs"))],
    "phases": [
        ("namespace {\n", "namespace {\n__device__ long long g_phase[1024][8], g_phase2[1024][10];\n"
         "#define TICK(k) { long long n_ = clock64(); T[k] += n_ - tc; tc = n_; }\n"),
        ("                                 C::TEAMS * member + team());\n",
         "                                 C::TEAMS * member + team());\n"
         "  long long T[8] = {}; long long tc = clock64();\n"),
        ("    const int E = build_edges<false, R1>(s, n, cutoff, i0);\n",
         "    const int E = build_edges<false, R1>(s, n, cutoff, i0);\n    TICK(0); T[6] += 1;\n"),
        ("      gather_rows<FO, F>(xg, s.ej, e0, ne, xv);\n      rbf_tile<C>(s, e0, ne, gs, cutoff, step, coeff);\n"
         "      team_sync();\n",
         "      gather_rows<FO, F>(xg, s.ej, e0, ne, xv);\n      rbf_tile<C>(s, e0, ne, gs, cutoff, step, coeff);\n"
         "      team_sync();\n      TICK(1); T[7] += 1;\n"),
        ("        store_h<C>(s, acc);\n      }\n      team_sync();\n",
         "        store_h<C>(s, acc);\n      }\n      team_sync();\n      TICK(2);\n"),
        ("      team_sync();\n      scatter_rows<FO, C::SX>(s.xs, s.ei, i0, e0, ne, rows);\n",
         "      team_sync();\n      TICK(3);\n      scatter_rows<FO, C::SX>(s.xs, s.ei, i0, e0, ne, rows);\n"
         "      TICK(4);\n"),
        ("first > 0 || last < tiles);\n  }\n}\n\n// ------------------------------------------------------------ K2",
         "first > 0 || last < tiles);\n    TICK(5);\n  }\n"
         "  if (tid() == 0) for (int k = 0; k < 8; ++k) g_phase[C::TEAMS * blockIdx.x + team()][k] = T[k];\n"
         "}\n\n// ------------------------------------------------------------ K2"),
        ("extern \"C\" {\n", "extern \"C\" {\n"
         "int phase_dump(void* dst) { return (int)cudaMemcpyFromSymbol(dst, g_phase, sizeof(g_phase)); }\n"
         "int phase_dump2(void* dst) { return (int)cudaMemcpyFromSymbol(dst, g_phase2, sizeof(g_phase2)); }\n"),
        # K2
        ("  const TileRun run = plan_tiles(s.cnt, item_tiles, G * per_graph, members, member);",
         "  long long T[10] = {};\n"
         "  const TileRun run = plan_tiles(s.cnt, item_tiles, G * per_graph, members, member);\n"
         "  long long tc = clock64();"),
        ("    const int E = build_edges<true, R2>(s, n, cutoff, j0);\n",
         "    const int E = build_edges<true, R2>(s, n, cutoff, j0);\n    TICK(0); T[8] += 1;\n"),
        ("      __syncthreads();\n      float acc[1][SC / 32][4], sig[SC / 32][4];\n",
         "      __syncthreads();\n      TICK(1); T[9] += 1;\n      float acc[1][SC / 32][4], sig[SC / 32][4];\n"),
        ("      __syncthreads();\n      {\n        // the dx message",
         "      __syncthreads();\n      TICK(2);\n      {\n        // the dx message"),
        ("      __syncthreads();\n      scatter_rows<F, C::SX>(s.xs, s.ej, j0, e0, ne, rows);\n",
         "      __syncthreads();\n      TICK(3);\n      scatter_rows<F, C::SX>(s.xs, s.ej, j0, e0, ne, rows);\n"),
        ("      // P3: dh = dW W2[slab, :]^T", "      TICK(4);\n      // P3: dh = dW W2[slab, :]^T"),
        ("      __syncthreads();  // the dx sums are done with the message tile\n",
         "      __syncthreads();  // the dx sums are done with the message tile\n      TICK(5);\n"),
        ("      // P5: dW1[:, slab]^T += dpre^T rbf\n", "      TICK(6);\n      // P5: dW1[:, slab]^T += dpre^T rbf\n"),
        ("      __syncthreads();  // rbf and the dpre tile are rewritten by the next tile\n",
         "      __syncthreads();  // rbf and the dpre tile are rewritten by the next tile\n      TICK(7);\n"),
        ("    store_rows<F, F>(rows, dxs + (size_t)g * n * F, j0, R2, n, first > 0 || last < tiles);\n  }\n",
         "    store_rows<F, F>(rows, dxs + (size_t)g * n * F, j0, R2, n, first > 0 || last < tiles);\n  }\n"
         "  if (threadIdx.x == 0) for (int k = 0; k < 10; ++k) g_phase2[blockIdx.x][k] = T[k];\n"),
    ],
}
PHASES = ["set-up", "gather+rbf+sync", "layer 1+ssp+sync", "layer 2+message+sync", "row sums",
          "row store"]
PHASES2 = ["set-up", "gather+rbf+sync", "layer 1+sig+dW+sync", "layer 2+message+sync",
           "row sums+db2", "P3+P4+sync", "dpre+sync", "P5+db1+sync"]


def build_variants(_build) -> dict[str, ctypes.CDLL]:
    src = (_build.CSRC_DIR / "cfconv.cu").read_text()
    OUT = _build.BUILD_DIR / "probe"
    OUT.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) < 1:
                raise SystemExit(f"variant {name}: the source no longer holds {old[:60]!r}")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", str(cu), str(_build.CSRC_DIR / "fgw.cu"),
             "-o", str(OUT / f"{name}.so")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} failed to build:\n{out}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        for fn, (restype, argtypes) in _build.SIGNATURES.items():
            if hasattr(lib, fn):  # the large-N route is not built here
                getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
        libs[name] = lib
    libs["phases"].phase_dump.argtypes = [ctypes.c_void_p]
    libs["phases"].phase_dump2.argtypes = [ctypes.c_void_p]
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pkg", default=str(ROOT), help="checkout whose conan_fgw_tpu_torch is measured")
    ap.add_argument("--big", nargs="*", type=int, metavar="N",
                    help="measure the route above 128 atoms alone, at these N (default 192)")
    opts = ap.parse_args()
    pkg = Path(opts.pkg).resolve()
    sys.path.insert(0, str(pkg))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import conan_fgw_tpu_torch
    from conan_fgw_tpu_torch.device import pin_full_f32
    from conan_fgw_tpu_torch.ops.cuda import _build
    from conan_fgw_tpu_torch.ops.cuda.cfconv import cfconv_backward, cfconv_forward

    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    if not torch.cuda.is_available():
        print("torch_cfconv_probe: no CUDA device is available", file=sys.stderr)
        return 2
    pin_full_f32()
    print(smoke.card_line())
    print(f"package {Path(conan_fgw_tpu_torch.__file__).parent}")
    if opts.big is not None:
        probe_big(smoke, torch, opts.big or (192,))
        return 0
    libs = build_variants(_build)
    gen = torch.Generator().manual_seed(smoke.SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, heavy, n in (("N32", (8, 13), 32), ("N64", (20, 26), 64)):
        pos, mask = smoke.packed_geometry(smoke.SEED + n, smoke.B, heavy, n, "cuda")
        G, F, Gs = pos.shape[0], smoke.F, smoke.GAUSS
        maskf = mask.float().contiguous()

        def rnd(*shape, scale=1.0):
            return (torch.randn(*shape, generator=gen) * scale).cuda()

        x, cot = rnd(G, n, F), rnd(G, n, F)
        w1, b1 = rnd(Gs, F, scale=(6 / (Gs + F)) ** 0.5), rnd(F, scale=0.1)
        w2, b2 = rnd(F, F, scale=(3 / F) ** 0.5), rnd(F, scale=0.1)
        args = (pos, maskf, x, w1, b1, w2, b2)
        for _ in range(3):
            cfconv_forward(*args, smoke.CUTOFF, smoke.CAP)
            cfconv_backward(*args, cot, smoke.CUTOFF, smoke.CAP)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                cfconv_forward(*args, smoke.CUTOFF, smoke.CAP)
                cfconv_backward(*args, cot, smoke.CUTOFF, smoke.CAP)
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
                name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
                print(f"[{label}] device {name:24s} {e.self_device_time_total / e.count / 1e3:.4f} ms"
                      f" per launch (x{e.count})")

        out, dx = torch.empty_like(x), torch.empty_like(x)
        grads = [torch.empty_like(t) for t in (w1, b1, w2, b2)]
        blocks = min(sms, G * -(-n // 8))  # F = 128: one slab
        part = torch.empty(blocks, libs["phases"].cfconv_partial_floats(F, Gs), device="cuda")
        item_tiles = torch.empty(G * -(-n // 4), dtype=torch.int32, device="cuda")  # K1's, the larger
        st = torch.cuda.current_stream().cuda_stream
        ptrs_f = [*(t.data_ptr() for t in (*args, out)), None, item_tiles.data_ptr()]
        ptrs_b = [t.data_ptr() for t in (*args, cot, dx, dx, grads[0], grads[1], grads[2], grads[3],
                                         part, item_tiles)]
        for name, lib in libs.items():
            fwd_ms = smoke.cuda_ms(lambda: lib.cfconv_fwd(*ptrs_f, G, n, F, Gs, smoke.CUTOFF, smoke.CAP, 0, blocks, 0, st), reps=20)
            bwd_ms = smoke.cuda_ms(lambda: lib.cfconv_bwd(*ptrs_b, G, n, F, Gs, smoke.CUTOFF, smoke.CAP, 0, blocks, 0, st), reps=20)
            print(f"[{label}] variant {name:8s} K1 {fwd_ms:.4f} ms, K2 {bwd_ms:.4f} ms (events)")

        lib = libs["phases"]
        lib.cfconv_fwd(*ptrs_f, G, n, F, Gs, smoke.CUTOFF, smoke.CAP, 0, blocks, 0, st)
        torch.cuda.synchronize()
        buf = np.zeros((1024, 8), np.int64)
        if lib.phase_dump(buf.ctypes.data) != 0:
            raise SystemExit("reading the phase counters failed")
        b = buf[:2 * blocks]  # K1 runs two teams a block
        tot = b[:, :6].sum(1)
        print(f"[{label}] K1 cycles per team: mean {tot.mean():.0f}, max {tot.max()}; items mean"
              f" {b[:, 6].mean():.2f}, max {b[:, 6].max()}; tiles mean {b[:, 7].mean():.2f}, max {b[:, 7].max()}")
        for k, name in enumerate(PHASES):
            print(f"[{label}]   {name:22s} {100 * b[:, k].sum() / tot.sum():5.1f}%,"
                  f" {b[:, k].sum() / max(1, b[:, 7].sum()):7.0f} cycles per tile,"
                  f" {b[:, k].sum() / max(1, b[:, 6].sum()):7.0f} per item")
        lib.cfconv_bwd(*ptrs_b, G, n, F, Gs, smoke.CUTOFF, smoke.CAP, 0, blocks, 0, st)
        torch.cuda.synchronize()
        buf2 = np.zeros((1024, 10), np.int64)
        if lib.phase_dump2(buf2.ctypes.data) != 0:
            raise SystemExit("reading the phase counters failed")
        b = buf2[:blocks]
        tot = b[:, :8].sum(1)
        print(f"[{label}] K2 cycles per block: mean {tot.mean():.0f}, max {tot.max()}; items mean"
              f" {b[:, 8].mean():.2f}, max {b[:, 8].max()}; tiles mean {b[:, 9].mean():.2f}, max {b[:, 9].max()}")
        for k, name in enumerate(PHASES2):
            print(f"[{label}]   {name:22s} {100 * b[:, k].sum() / tot.sum():5.1f}%,"
                  f" {b[:, k].sum() / max(1, b[:, 9].sum()):7.0f} cycles per tile,"
                  f" {b[:, k].sum() / max(1, b[:, 8].sum()):7.0f} per item")
    return 0


if __name__ == "__main__":
    sys.exit(main())
