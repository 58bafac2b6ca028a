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

import torch

from conan_fgw_tpu_torch.data.packing import DEFAULT_BUCKETS
from conan_fgw_tpu_torch.ops.cuda import _build, launches
from conan_fgw_tpu_torch.ops.fgw.coupling import fgw_coupling

MAX_ATOMS = DEFAULT_BUCKETS[-1]


def fgw_couplings_plain(Ms, C1s, C2s, ps, qs, T0s, **solver):
    """Plain PyTorch version: ``(T (S, N, N), diverged (S,) int32)``."""
    T, div = fgw_coupling(Ms, C1s, C2s, ps, qs, T0s, **solver)
    return T, div.to(torch.int32)


def _launch(Ms, C1s, C2s, ps, qs, T0s, *, alpha, epsilon, pgd_iters, pgd_tol,
            sinkhorn_iters, sinkhorn_thr):
    """Launch K3: ``(T, diverged, sinkhorn_iters_run)``, the last an ``(S,)``
    int32 count of the Sinkhorn iterations each solve ran over all its PGD
    steps (a frozen solve leaves its Sinkhorn loop early)."""
    S, N, _ = Ms.shape
    named = dict(Ms=Ms, C1s=C1s, C2s=C2s, ps=ps, qs=qs, T0s=T0s)
    for name, t in named.items():
        if not t.is_cuda or t.device != Ms.device:
            raise ValueError(f"fgw kernel: {name} must lie on {Ms.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"fgw kernel: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"fgw kernel: {name} must be contiguous")
        want = (S, N) if name in ("ps", "qs") else (S, N, N)
        if tuple(t.shape) != want:
            raise ValueError(f"fgw kernel: {name} has shape {tuple(t.shape)}, want {want}")
    if N > MAX_ATOMS:
        raise ValueError(f"fgw kernel: N={N} exceeds the largest bucket {MAX_ATOMS}")
    lib = _build.load_library()
    resident = int(lib.fgw_smem(N, 1) <= _build.MAX_SMEM_BYTES)
    if lib.fgw_smem(N, resident) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"fgw kernel: N={N} does not fit in shared memory")
    T = torch.empty_like(Ms)
    div = torch.empty((S,), dtype=torch.int32, device=Ms.device)
    iters = torch.empty_like(div)
    with torch.cuda.device(Ms.device):
        stream = torch.cuda.current_stream(Ms.device).cuda_stream
        code = lib.fgw_couplings(
            Ms.data_ptr(), C1s.data_ptr(), C2s.data_ptr(), ps.data_ptr(), qs.data_ptr(),
            T0s.data_ptr(), T.data_ptr(), div.data_ptr(), iters.data_ptr(), S, N, resident,
            float(alpha), float(epsilon), int(pgd_iters), float(pgd_tol),
            int(sinkhorn_iters), float(sinkhorn_thr), stream,
        )
    _build.check(code, "fgw_couplings")
    launches["fgw_couplings"] += 1
    return T, div, iters


def fgw_couplings_flat(Ms, C1s, C2s, ps, qs, T0s, *, alpha, epsilon, pgd_iters, pgd_tol,
                       sinkhorn_iters, sinkhorn_thr):
    """Solve ``S`` independent FGW couplings.

    Args: ``Ms``/``C1s``/``C2s``/``T0s`` ``(S, N, N)``, ``ps``/``qs`` ``(S, N)``.
    Returns ``(T (S, N, N) f32, diverged (S,) int32 per-solve flags)``.
    CUDA tensors go to the kernel, CPU tensors to ``fgw_couplings_plain``.
    """
    solver = dict(alpha=alpha, epsilon=epsilon, pgd_iters=pgd_iters, pgd_tol=pgd_tol,
                  sinkhorn_iters=sinkhorn_iters, sinkhorn_thr=sinkhorn_thr)
    if Ms.device.type == "cpu":
        return fgw_couplings_plain(Ms, C1s, C2s, ps, qs, T0s, **solver)
    if Ms.is_cuda:
        T, div, _ = _launch(Ms, C1s, C2s, ps, qs, T0s, **solver)
        return T, div
    raise ValueError(f"fgw_couplings_flat: unsupported device {Ms.device}")
