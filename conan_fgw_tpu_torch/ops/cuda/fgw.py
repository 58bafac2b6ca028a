"""Batched FGW coupling solver: CUDA kernel K3.

Replaces ``conan_fgw_tpu/ops/pallas/fgw.py::pallas_fgw_couplings_flat``
(the Pallas ``_super_kernel`` with ``_sinkhorn_super``). The kernel lives in
``csrc/fgw.cu``, one CTA per solve; its header says what bounds it on this
card and how the design answers it. The plain version is
``ops/fgw/coupling.py::fgw_coupling``, reached here through
``fgw_couplings_plain``. Forward only: the barycenter solves its couplings
without gradient.
"""

from __future__ import annotations

import contextlib
import functools

import torch

from conan_fgw_tpu_torch.data.packing import DEFAULT_BUCKETS
from conan_fgw_tpu_torch.ops.cuda import _build, launches
from conan_fgw_tpu_torch.ops.fgw.coupling import fgw_coupling

MAX_ATOMS = DEFAULT_BUCKETS[-1]
_NAMES = ("Ms", "C1s", "C2s", "ps", "qs", "T0s")


def fgw_couplings_plain(Ms, C1s, C2s, ps, qs, T0s, **solver):
    """Plain PyTorch version: ``(T (S, N, N), diverged (S,) int32)``."""
    T, div = fgw_coupling(Ms, C1s, C2s, ps, qs, T0s, **solver)
    return T, div.to(torch.int32)


@functools.cache
def _resident(N: int) -> int:
    """1 where C1 and C2 fit in shared memory beside the solve's own
    matrices (N <= 96), else 0: the kernel then reads them through L2."""
    lib = _build.load_library()
    resident = int(lib.fgw_smem(N, 1) <= _build.MAX_SMEM_BYTES)
    if lib.fgw_smem(N, resident) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"fgw kernel: N={N} does not fit in shared memory")
    return resident


def _complaint(name, t, dev, want):
    if not t.is_cuda or t.device != dev:
        return f"{name} must lie on {dev}"
    if t.dtype != torch.float32:
        return f"{name} must be float32, got {t.dtype}"
    if not t.is_contiguous():
        return f"{name} must be contiguous"
    if tuple(t.shape) != want:
        return f"{name} has shape {tuple(t.shape)}, want {want}"
    return f"{name} must start on a 16-byte boundary"


def _launch(Ms, C1s, C2s, ps, qs, T0s, *, alpha, epsilon, pgd_iters, pgd_tol,
            sinkhorn_iters, sinkhorn_thr):
    """Launch K3: ``(T, diverged, sinkhorn_iters_run)``, the last an ``(S,)``
    int32 count of the Sinkhorn iterations each solve ran over all its PGD
    steps (a frozen solve leaves its Sinkhorn loop early). ``N`` must be a
    bucket size (a multiple of 32 up to ``MAX_ATOMS``)."""
    S, N, _ = Ms.shape
    dev = Ms.device
    idx = Ms.get_device()  # -1 off the card
    for name, t in zip(_NAMES, (Ms, C1s, C2s, ps, qs, T0s)):
        want = (S, N) if name in ("ps", "qs") else (S, N, N)
        if (idx < 0 or t.get_device() != idx or t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != want or t.data_ptr() % 16):
            raise ValueError(f"fgw kernel: {_complaint(name, t, dev, want)}")
    if N % 32 or N > MAX_ATOMS:
        raise ValueError(f"fgw kernel: N={N} is not a multiple of 32 up to {MAX_ATOMS}")
    resident = _resident(N)
    T = torch.empty_like(Ms)
    flags = torch.empty((2, S), dtype=torch.int32, device=dev)
    div, iters = flags[0], flags[1]
    switch = contextlib.nullcontext() if idx == torch.cuda.current_device() else torch.cuda.device(idx)
    with switch:
        code = _build.load_library().fgw_couplings(
            Ms.data_ptr(), C1s.data_ptr(), C2s.data_ptr(), ps.data_ptr(), qs.data_ptr(),
            T0s.data_ptr(), T.data_ptr(), div.data_ptr(), iters.data_ptr(), S, N, resident,
            float(alpha), float(epsilon), int(pgd_iters), float(pgd_tol),
            int(sinkhorn_iters), float(sinkhorn_thr),
            # the current stream's raw handle, without building a Stream object
            torch._C._cuda_getCurrentRawStream(idx),
        )
    _build.check(code, "fgw_couplings")
    launches["fgw_couplings"] += 1
    return T, div, iters


def fgw_couplings_flat(Ms, C1s, C2s, ps, qs, T0s, *, alpha, epsilon, pgd_iters, pgd_tol,
                       sinkhorn_iters, sinkhorn_thr):
    """Solve ``S`` independent FGW couplings.

    Args: ``Ms``/``C1s``/``C2s``/``T0s`` ``(S, N, N)``, ``ps``/``qs`` ``(S, N)``.
    Returns ``(T (S, N, N) f32, diverged (S,) int32 per-solve flags)``.
    CUDA tensors go to the kernel, CPU tensors to ``fgw_couplings_plain``;
    a mix of the two raises.
    """
    solver = dict(alpha=alpha, epsilon=epsilon, pgd_iters=pgd_iters, pgd_tol=pgd_tol,
                  sinkhorn_iters=sinkhorn_iters, sinkhorn_thr=sinkhorn_thr)
    if all(t.device.type == "cpu" for t in (Ms, C1s, C2s, ps, qs, T0s)):
        return fgw_couplings_plain(Ms, C1s, C2s, ps, qs, T0s, **solver)
    if Ms.is_cuda:
        T, div, _ = _launch(Ms, C1s, C2s, ps, qs, T0s, **solver)
        return T, div
    devices = sorted({str(t.device) for t in (Ms, C1s, C2s, ps, qs, T0s)})
    raise ValueError(f"fgw_couplings_flat: unsupported device {', '.join(devices)}")
