#!/usr/bin/env python3
"""Where the FGW coupling kernel K3 (``conan_fgw_tpu_torch/csrc/fgw.cu``)
spends its time on one NVIDIA card, at ``chip_smoke.py``'s K3 inputs
(S = 120 solves at N = 32, 64, 96 and 128, and the barycenter's second outer
iteration at N = 32 and 64).

    python3 scripts/torch_fgw_probe.py [--pkg DIR]

``--pkg`` takes the port's package (kernel source and wrapper) from another
checkout, by default this one, so that two versions of K3 can be measured
in one run on one card. The inputs always come from this checkout's
``chip_smoke.py``. Prints, per input set:

1. K3's device time per launch (``torch.profiler``), the CUDA-event time
   per call of back-to-back wrapper calls, their difference (the host time
   the card waits for between calls), and the host time to issue one call
   (host clock over 20 calls issued behind a spin kernel, so that every
   call only enqueues whatever the kernel's own length: the median and the
   least of 20 such runs, the least being the cost without interference
   from other work on a shared host);
2. K3's cycles by phase. A copy of the source gets ``clock64`` reads at each
   phase boundary; thread 0 of every block sums them, so a phase includes
   its barrier's wait for the slowest warp: set-up (loads, marginals,
   c1p/c2q); the two products and the gradient assembly; the Sinkhorn
   log-sum-exp updates; the column-marginal checks; the candidate plan and
   its acceptance; the final store.

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
MAX_BLOCKS = 4096
SPIN_CYCLES = 10_000_000  # ~5 ms on the card, longer than issuing 20 calls


def _tick(k: int) -> str:
    return f"{{ long long n_ = clock64(); ph_[{k}] += n_ - tc_; tc_ = n_; }}\n"


# (anchor, replacement): every anchor is a line that both the CUDA-core K3
# and its tensor-core redesign carry, so the same split applies to either;
# each edit goes to the anchor's first copy, the <N, PAD> templates' (the
# global route for N > 128 comes after them and repeats some anchors)
EDITS = [
    ("namespace {\n", f"namespace {{\n__device__ long long g_phase[{MAX_BLOCKS}][8];\n"),
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


def instrumented(src: str) -> str:
    for old, new in EDITS:
        if old not in src:
            raise SystemExit(f"the source holds no copy of {old[:50]!r}")
        src = src.replace(old, new, 1)
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
    for fn in ("fgw_couplings", "fgw_smem"):
        getattr(lib, fn).restype, getattr(lib, fn).argtypes = build.SIGNATURES[fn]
    lib.phase_dump.argtypes = [ctypes.c_void_p]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pkg", default=str(ROOT), help="checkout whose conan_fgw_tpu_torch is measured")
    pkg = Path(ap.parse_args().pkg).resolve()
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
    _build.load_library()
    lib = build_phases(_build, _build.CSRC_DIR)
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
