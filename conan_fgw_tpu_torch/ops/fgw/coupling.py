"""Fused Gromov-Wasserstein couplings by entropic projected gradient
(port of ``conan_fgw_tpu/ops/fgw/coupling.py``).

    repeat:  G = alpha * 2 * (constC - hC1 @ T @ hC2^T) + (1 - alpha) * M
             T = sinkhorn_log(p, q, G, epsilon)

with the update error checked on iterations ``it % 10 == 0`` against
``pgd_tol``. Batched over leading solve axes. The square-loss, symmetric
PGD solve is the plain PyTorch version of the CUDA kernel in
``ops/cuda/fgw.py``.
"""

from __future__ import annotations

import torch

from conan_fgw_tpu_torch.ops.fgw.sinkhorn import sinkhorn_log

def _outer_const(a, b, p, q):
    """``constC[..., i, j] = (a p)_i + (b q)_j``."""
    return (a @ p[..., :, None]) + (b @ q[..., :, None]).transpose(-1, -2)


def square_loss_const(C1, C2, p, q):
    """``(constC, hC1, hC2)`` for the square GW loss:
    ``constC[..., i, j] = (C1² p)_i + (C2² q)_j``, ``hC1 = C1``, ``hC2 = 2 C2``."""
    return _outer_const(C1 * C1, C2 * C2, p, q), C1, 2.0 * C2


def kl_loss_const(C1, C2, p, q):
    """``(constC, hC1, hC2)`` for the KL GW loss: ``constC[..., i, j] =
    ((C1 log C1 - C1) p)_i + (C2 q)_j``, ``hC1 = C1``, ``hC2 = log C2``
    (each log of ``C + 1e-15``)."""
    f1 = C1 * torch.log(C1 + 1e-15) - C1
    return _outer_const(f1, C2, p, q), C1, torch.log(C2 + 1e-15)


def loss_const(loss_fun, C1, C2, p, q):
    if loss_fun == "square_loss":
        return square_loss_const(C1, C2, p, q)
    if loss_fun == "kl_loss":
        return kl_loss_const(C1, C2, p, q)
    raise ValueError(f"unknown loss_fun {loss_fun!r}")


def gw_grad(constC, hC1, hC2, T, mm=torch.matmul):
    """``2 (constC - hC1 @ T @ hC2^T)``: the gradient of the GW term."""
    return 2.0 * (constC - mm(mm(hC1, T), hC2.transpose(-1, -2)))


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
    loss_fun: str = "square_loss",
    symmetric: bool = True,
    solver: str = "PGD",
    mm=torch.matmul,
):
    """Solve FGW couplings between ``(C1, p)`` and ``(C2, q)``.

    Shapes: ``M, T0`` ``(..., N1, N2)``, ``C1`` ``(..., N1, N1)``, ``C2``
    ``(..., N2, N2)``; ``p, q`` ``(..., N1)``, ``(..., N2)``. ``T0`` defaults
    to ``p q^T``. ``loss_fun`` is ``"square_loss"`` or ``"kl_loss"``;
    ``symmetric=False`` averages in the gradient of the transposed
    structures; ``solver="PPA"`` (proximal point) adds ``-eps log T`` to
    each step's cost. Differentiable: autograd runs through every step.

    Returns ``(T (..., N1, N2), diverged (...) bool)``: diverged is True
    where an inner Sinkhorn solve hit non-finite values and rolled back.
    ``mm`` computes the two products of each step, ``(hC1 T) hC2^T``; the
    CPU tests pass ``ops/cuda/cfconv.py::split_mm`` to emulate the kernel's
    tensor-core arithmetic.
    """
    if solver not in ("PGD", "PPA"):
        raise ValueError(f"unknown solver {solver!r}; pick 'PGD' or 'PPA'")
    consts = [loss_const(loss_fun, C1, C2, p, q)]
    if not symmetric:
        consts.append(loss_const(loss_fun, C1.transpose(-1, -2), C2.transpose(-1, -2), p, q))
    T = p[..., :, None] * q[..., None, :] if T0 is None else T0
    batch = M.shape[:-2]
    frozen = torch.zeros(batch, dtype=torch.bool, device=M.device)
    diverged = torch.zeros_like(frozen)
    for it in range(pgd_iters):
        if symmetric:
            tens = alpha * gw_grad(*consts[0], T, mm) + (1.0 - alpha) * M
        else:
            tens = (alpha * 0.5) * (gw_grad(*consts[0], T, mm) + gw_grad(*consts[1], T, mm)) + (
                1.0 - alpha
            ) * M
        if solver == "PPA":
            tens = tens - epsilon * torch.log(torch.clamp(T, min=1e-30))
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
