"""Fused Gromov-Wasserstein couplings by entropic projected gradient
(port of ``conan_fgw_tpu/ops/fgw/coupling.py``, square loss, symmetric, PGD).

    repeat:  G = alpha * 2 * (constC - C1 @ T @ (2 C2)^T) + (1 - alpha) * M
             T = sinkhorn_log(p, q, G, epsilon)

with the update error checked on iterations ``it % 10 == 0`` against
``pgd_tol``. Batched over leading solve axes. This is the plain PyTorch
version of the CUDA kernel in ``ops/cuda/fgw.py``.
"""

from __future__ import annotations

import torch

from conan_fgw_tpu_torch.ops.fgw.sinkhorn import sinkhorn_log


def square_loss_const(C1, C2, p, q):
    """``constC[..., i, j] = (C1² p)_i + (C2² q)_j`` for the square GW loss."""
    c1p = ((C1 * C1) @ p[..., :, None])[..., 0]
    c2q = ((C2 * C2) @ q[..., :, None])[..., 0]
    return c1p[..., :, None] + c2q[..., None, :]


def fgw_coupling(
    M: torch.Tensor,
    C1: torch.Tensor,
    C2: torch.Tensor,
    p: torch.Tensor,
    q: torch.Tensor,
    T0: torch.Tensor | None = None,
    *,
    alpha: float = 0.5,
    epsilon: float = 0.1,
    pgd_iters: int = 5,
    pgd_tol: float = 1e-4,
    sinkhorn_iters: int = 5,
    sinkhorn_thr: float = 1e-2,
    mm=torch.matmul,
):
    """Solve FGW couplings between ``(C1, p)`` and ``(C2, q)``.

    Shapes: ``M, C1, C2, T0`` ``(..., N, N)``; ``p, q`` ``(..., N)``.
    Returns ``(T (..., N, N), diverged (...) bool)``: diverged is True where
    an inner Sinkhorn solve hit non-finite values and rolled back. ``mm``
    computes the two products of each PGD step, ``(C1 T) (2 C2)^T``; the
    CPU tests pass ``ops/cuda/cfconv.py::split_mm`` to emulate the kernel's
    tensor-core arithmetic.
    """
    constC = square_loss_const(C1, C2, p, q)
    hC2T = (2.0 * C2).transpose(-1, -2)
    T = p[..., :, None] * q[..., None, :] if T0 is None else T0
    batch = M.shape[:-2]
    frozen = torch.zeros(batch, dtype=torch.bool, device=M.device)
    diverged = torch.zeros_like(frozen)
    for it in range(pgd_iters):
        tens = alpha * (2.0 * (constC - mm(mm(C1, T), hC2T))) + (1.0 - alpha) * M
        T_new, div = sinkhorn_log(
            p, q, tens, epsilon, num_iters=sinkhorn_iters, stop_thr=sinkhorn_thr
        )
        # a non-finite plan also counts as a numerical failure
        bad = div | ~torch.isfinite(T_new).flatten(-2).all(-1)
        newly_frozen = bad
        if it % 10 == 0:
            err = torch.linalg.vector_norm((T_new - T).flatten(-2), dim=-1)
            newly_frozen = (err <= pgd_tol) | bad
        T = torch.where((frozen | bad)[..., None, None], T, T_new)
        frozen = frozen | newly_frozen
        diverged = diverged | bad
    return T, diverged
