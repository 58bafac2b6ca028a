"""Batched FGW barycenter of K conformer graphs
(port of ``conan_fgw_tpu/ops/fgw/barycenter.py``, the batched structure of
``_fgw_barycenter_batch_pallas``).

Block-coordinate descent over the whole batch: each outer iteration makes
one coupling call over all ``B*K`` solves (``ops/cuda/fgw.py``: the CUDA
kernel for tensors on the card, the plain solver on the CPU), then updates
every molecule's barycenter features ``Y`` and structure ``C``. Per-molecule
freeze flags stop molecules whose update fell below ``outer_tol``.

Gradients follow the reference: the couplings are solved without gradient
(its ``torch.no_grad``); the last applied feature update
``Y = diag(1/p) sum_k lambda_k T_k Ys_k`` is then re-applied differentiably
with respect to ``Ys``.
"""

from __future__ import annotations

import dataclasses

import torch

from conan_fgw_tpu_torch.ops.cuda.fgw import fgw_couplings_flat


@dataclasses.dataclass(frozen=True)
class FGWConfig:
    """Solver hyper-parameters; defaults are the reference's hardcoded
    training configuration (outer = PGD = Sinkhorn = 5, alpha = eps = 0.1).
    The port's solver is the square-loss PGD path with stop-gradient
    couplings."""

    alpha: float = 0.1
    epsilon: float = 0.1
    outer_iters: int = 5
    outer_tol: float = 1e-2
    pgd_iters: int = 5
    pgd_tol: float = 1e-4
    sinkhorn_iters: int = 5
    sinkhorn_thr: float = 1e-2


def normalize_minmax(x: torch.Tensor, a: float, b: float, eps: float = 0.0) -> torch.Tensor:
    """Min-max rescale each matrix ``x[..., :, :]`` into ``[a, b]``."""
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    return a + (x - lo) * (b - a) / (hi - lo + eps)


def sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Pairwise squared euclidean distances, clamped at 0."""
    d = (
        torch.sum(x * x, dim=-1)[..., :, None]
        + torch.sum(y * y, dim=-1)[..., None, :]
        - 2.0 * x @ y.transpose(-1, -2)
    )
    return torch.clamp(d, min=0.0)


def _frob(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=(-2, -1)))


def fgw_barycenter_batch(
    Ys: torch.Tensor,
    Cs: torch.Tensor,
    ps: torch.Tensor | None = None,
    p: torch.Tensor | None = None,
    lambdas: torch.Tensor | None = None,
    config: FGWConfig = FGWConfig(),
):
    """Barycenters for a batch: ``Ys (B, K, N, D)``, ``Cs (B, K, N, N)``.

    Marginals default to uniform over the padded node axis, weights to
    ``1/K``. Returns ``(Y (B, N, D), C (B, N, N), n_div)``: ``n_div`` is the
    batch-total count (an int64 tensor) of coupling solves that rolled back
    a Sinkhorn numerical failure while their molecule was not yet frozen.
    """
    B, K, N, D = Ys.shape
    S = B * K
    dt, dev = Ys.dtype, Ys.device
    if ps is None:
        ps = torch.full((B, K, N), 1.0 / N, dtype=dt, device=dev)
    if p is None:
        p = torch.full((B, N), 1.0 / N, dtype=dt, device=dev)
    if lambdas is None:
        lambdas = torch.full((B, K), 1.0 / K, dtype=dt, device=dev)
    has_mass = p > 0
    inv_p = torch.where(has_mass, 1.0 / torch.where(has_mass, p, torch.ones_like(p)), 0.0)
    ppt = p[:, :, None] * p[:, None, :]
    ppt_safe = torch.where(ppt > 0, ppt, torch.ones_like(ppt))

    with torch.no_grad():
        Ys_ng, Cs_ng = Ys.detach(), Cs.detach()
        ps, p, lambdas = ps.detach(), p.detach(), lambdas.detach()
        C = Cs_ng[:, 0]
        Y = torch.zeros((B, N, D), dtype=dt, device=dev)
        T = p[:, None, :, None] * ps[:, :, None, :]  # (B, K, N, N), warm-started after
        Ms = sqdist(Y[:, None], Ys_ng)
        frozen = torch.zeros((B,), dtype=torch.bool, device=dev)
        n_div = torch.zeros((), dtype=torch.int64, device=dev)
        p_flat = p[:, None, :].expand(B, K, N).reshape(S, N)
        ps_flat = ps.reshape(S, N)
        Cs_flat = Cs_ng.reshape(S, N, N)
        for _ in range(config.outer_iters):
            T_flat, div = fgw_couplings_flat(
                Ms.reshape(S, N, N).contiguous(),
                C[:, None].expand(B, K, N, N).reshape(S, N, N).contiguous(),
                Cs_flat.contiguous(),
                p_flat.contiguous(),
                ps_flat.contiguous(),
                T.reshape(S, N, N).contiguous(),
                alpha=config.alpha, epsilon=config.epsilon,
                pgd_iters=config.pgd_iters, pgd_tol=config.pgd_tol,
                sinkhorn_iters=config.sinkhorn_iters,
                sinkhorn_thr=config.sinkhorn_thr,
            )
            T_new = T_flat.reshape(B, K, N, N)
            div_b = div.reshape(B, K).to(torch.int64).sum(1)
            n_div = n_div + torch.where(frozen, 0, div_b).sum()
            # Y = diag(1/p) sum_k lambda_k T_k Ys_k
            Y_new = inv_p[:, :, None] * torch.einsum("bk,bknm,bkmd->bnd", lambdas, T_new, Ys_ng)
            Ms_new = sqdist(Y_new[:, None], Ys_ng)
            # C = sum_k lambda_k T_k C_k T_k^T / p p^T
            C_new = torch.where(
                ppt > 0,
                torch.einsum("bk,bknm,bkmj,bklj->bnl", lambdas, T_new, Cs_ng, T_new) / ppt_safe,
                0.0,
            )
            newly_frozen = (_frob(Y_new - Y) <= config.outer_tol) & (
                _frob(C_new - C) <= config.outer_tol
            )
            m3 = frozen[:, None, None]
            m4 = frozen[:, None, None, None]
            Y = torch.where(m3, Y, Y_new)
            C = torch.where(m3, C, C_new)
            T = torch.where(m4, T, T_new)
            Ms = torch.where(m4, Ms, Ms_new)
            frozen = frozen | newly_frozen
    # re-apply the last feature update differentiably w.r.t. Ys; T holds each
    # molecule's couplings of its last applied update (warm start is always on)
    Y = inv_p[:, :, None] * torch.einsum("bk,bknm,bkmd->bnd", lambdas, T, Ys)
    return Y, C, n_div
