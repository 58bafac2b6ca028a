#!/usr/bin/env python3
"""Where the cfconv kernels K1/K2 (``conan_fgw_tpu_torch/csrc/cfconv.cu``)
spend their time on one NVIDIA card, at ``chip_smoke.py``'s kernel-check
inputs (G = 120 graphs at N = 32 and at N = 64, F = 128, 50 Gaussians).

    PYTHONPATH=. python3 scripts/torch_cfconv_probe.py

Prints, per shape:
1. each kernel's device time per launch (``torch.profiler``);
2. the CUDA-event time of the source as it is (``base``) and of textual
   variants, each built into its own library: ``no_mma`` (the tensor-core
   products skipped),
   ``one_pass`` (only a_hi b_hi of the split kept). Their results are wrong;
   only the times say something;
3. K1's and K2's cycles by phase: thread 0 of every team reads ``clock64``
   at each phase boundary (for K1: set-up of an item; gather, RBF and the
   first barrier; layer 1; layer 2 and the message; the row sums; the row
   store; K2 has its backward products as phases too),
   with the items and tiles each team took.

Needs the CUDA toolkit and a card. Builds go to
``conan_fgw_tpu_torch/_build/probe``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as smoke
from conan_fgw_tpu_torch.device import pin_full_f32
from conan_fgw_tpu_torch.ops.cuda import _build
from conan_fgw_tpu_torch.ops.cuda.cfconv import cfconv_backward, cfconv_forward

OUT = _build.BUILD_DIR / "probe"
VARIANTS = {
    "base": [],
    "no_mma": [("  static_assert(K % 16 == 0, \"mma.m16n8k16 steps\");\n",
                "  static_assert(K % 16 == 0, \"mma.m16n8k16 steps\");\n  if (K > 0) return;\n")],
    "one_pass": [(f"mma_bf16(acc[mt][nt], {a}, {b});", ";")
                 for a, b in (("al[mt]", "bh[nt]"), ("ah[mt]", "bl[nt]"), ("al[mt]", "bh"), ("ah[mt]", "bl"))],
    "phases": [
        ("namespace {\n", "namespace {\n__device__ long long g_phase[1024][8], g_phase2[1024][10];\n"
         "#define TICK(k) { long long n_ = clock64(); T[k] += n_ - tc; tc = n_; }\n"),
        ("                                 C::TEAMS * member + team());\n",
         "                                 C::TEAMS * member + team());\n"
         "  long long T[8] = {}; long long tc = clock64();\n"),
        ("    const int E = build_edges<false, R1>(s, n, cutoff, i0);\n",
         "    const int E = build_edges<false, R1>(s, n, cutoff, i0);\n    TICK(0); T[6] += 1;\n"),
        ("      gather_rows<FO, F>(xg, s.ej, e0, ne, xv);\n      rbf_tile<C>(s, e0, ne, gs, step, coeff);\n"
         "      team_sync();\n",
         "      gather_rows<FO, F>(xg, s.ej, e0, ne, xv);\n      rbf_tile<C>(s, e0, ne, gs, step, coeff);\n"
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


def build_variants() -> dict[str, ctypes.CDLL]:
    src = (_build.CSRC_DIR / "cfconv.cu").read_text()
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
            getattr(lib, fn).restype, getattr(lib, fn).argtypes = restype, argtypes
        libs[name] = lib
    libs["phases"].phase_dump.argtypes = [ctypes.c_void_p]
    libs["phases"].phase_dump2.argtypes = [ctypes.c_void_p]
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_cfconv_probe: no CUDA device is available", file=sys.stderr)
        return 2
    pin_full_f32()
    print(smoke.card_line())
    libs = build_variants()
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
        ptrs_f = [t.data_ptr() for t in (*args, out, item_tiles)]
        ptrs_b = [t.data_ptr() for t in (*args, cot, dx, dx, grads[0], grads[1], grads[2], grads[3],
                                         part, item_tiles)]
        for name, lib in libs.items():
            fwd_ms = smoke.cuda_ms(lambda: lib.cfconv_fwd(*ptrs_f, G, n, F, Gs, smoke.CUTOFF, smoke.CAP, blocks, st), reps=20)
            bwd_ms = smoke.cuda_ms(lambda: lib.cfconv_bwd(*ptrs_b, G, n, F, Gs, smoke.CUTOFF, smoke.CAP, blocks, st), reps=20)
            print(f"[{label}] variant {name:8s} K1 {fwd_ms:.4f} ms, K2 {bwd_ms:.4f} ms (events)")

        lib = libs["phases"]
        lib.cfconv_fwd(*ptrs_f, G, n, F, Gs, smoke.CUTOFF, smoke.CAP, blocks, st)
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
        lib.cfconv_bwd(*ptrs_b, G, n, F, Gs, smoke.CUTOFF, smoke.CAP, blocks, st)
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
