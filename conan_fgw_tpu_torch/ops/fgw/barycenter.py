"""FGW barycenters of K conformer graphs
(port of ``conan_fgw_tpu/ops/fgw/barycenter.py``).

Block-coordinate descent: each outer iteration solves the K couplings of
every molecule against its current barycenter, then updates the
barycenter's features ``Y`` and structure ``C``. Per-molecule freeze flags
stop molecules whose update fell below ``outer_tol``.

Two routes, as the JAX package gates its Pallas solver
(``FGWConfig.wants_pallas_coupling``):

- the square loss with stop-gradient couplings runs each outer iteration's
  solves as one call of K3 (``ops/cuda/fgw.py``: the CUDA kernel for
  tensors on the card, its plain version on the CPU). The batched
  ``fgw_barycenter_batch`` makes one ``fgw_couplings_flat`` call over all
  ``B*K`` solves, the per-molecule ``fgw_barycenter`` one
  ``fgw_couplings`` call over its K. Gradients follow the reference: the
  couplings are solved without gradient (its ``torch.no_grad``), and the
  last applied feature update ``Y = diag(1/p) sum_k lambda_k T_k Ys_k`` is
  re-applied differentiably with respect to ``Ys``. The JAX package's TPU
  auto mode would take its XLA solver at budgets above 30 PGD x Sinkhorn
  iterations (a VMEM limit of the TPU kernel); the port keeps K3 at every
  budget, and ``chip_smoke.py`` holds K3 at the deep 10 x 10 budget.
- ``loss_fun="kl_loss"`` or ``stop_grad_couplings=False`` run the plain
  solver (``ops/fgw/coupling.py``, JAX's XLA route) on any device; without
  stop-gradient, autograd runs through every solve.

The descent counts, as a ``(2,)`` int64 ``n_div``, the solves that rolled
back a Sinkhorn failure while their molecule was not yet frozen, and the
Sinkhorn iterations of all solves (every solve of every outer iteration, a
frozen molecule's too, as both routes solve them all): K3 returns both per
solve in one buffer, and one reduction sums them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools

import torch

# the module, not its names: ops/cuda/fgw.py imports this package's coupling
from conan_fgw_tpu_torch.ops.cuda import fgw as k3
from conan_fgw_tpu_torch.ops.fgw.coupling import fgw_coupling


@dataclasses.dataclass(frozen=True)
class FGWConfig:
    """Solver hyper-parameters; defaults are the reference's hardcoded
    training configuration (outer = PGD = Sinkhorn = 5, alpha = eps = 0.1,
    square loss, warm-started couplings solved without gradient).
    ``fixed_structure`` keeps the barycenter's structure at its initial
    value (the first conformer's) for every outer iteration (DimeNet's
    barycenter, with alpha 0.5); ``fixed_features`` keeps its features."""

    alpha: float = 0.1
    epsilon: float = 0.1
    outer_iters: int = 5
    outer_tol: float = 1e-2
    pgd_iters: int = 5
    pgd_tol: float = 1e-4
    sinkhorn_iters: int = 5
    sinkhorn_thr: float = 1e-2
    loss_fun: str = "square_loss"
    warmstart: bool = True
    fixed_structure: bool = False
    fixed_features: bool = False
    stop_grad_couplings: bool = True

    def uses_kernel(self) -> bool:
        """True where the couplings go to K3: the square loss with
        stop-gradient couplings (JAX's gating of its Pallas solver)."""
        return self.loss_fun == "square_loss" and self.stop_grad_couplings

    def solver(self) -> dict:
        return dict(alpha=self.alpha, epsilon=self.epsilon, pgd_iters=self.pgd_iters,
                    pgd_tol=self.pgd_tol, sinkhorn_iters=self.sinkhorn_iters,
                    sinkhorn_thr=self.sinkhorn_thr)


def normalize_minmax(x: torch.Tensor, a: float, b: float, eps: float = 0.0) -> torch.Tensor:
    """Min-max rescale the whole tensor into ``[a, b]``."""
    lo, hi = x.min(), x.max()
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


def _plain_solve(config, p, ps):
    """The plain solver over ``(B, K)`` solves: ``solve(Ms, C, Cs, T0) ->
    (T (B, K, N, N), flags (2, B, K))``, the diverged flags and Sinkhorn
    iterations."""

    def solve(Ms, C, Cs, T0):
        B, K, N, _ = Ms.shape
        T, div, iters = fgw_coupling(Ms, C[:, None].expand(B, K, N, N), Cs,
                                     p[:, None].expand(B, K, N), ps, T0,
                                     loss_fun=config.loss_fun, symmetric=True, **config.solver())
        return T, torch.stack([div.to(torch.int64), iters.to(torch.int64)])

    return solve


def _descent(Ys, Cs, ps, p, lambdas, config, C, Y, solve):
    """The block-coordinate descent over ``B`` molecules: ``Ys (B, K, N, D)``,
    ``Cs (B, K, N, N)``, ``ps (B, K, N)``, ``p (B, N)``, ``lambdas (B, K)``,
    the initial barycenter ``C (B, N, N)``, ``Y (B, N, D)``. ``solve(Ms, C,
    Cs, T0)`` solves the couplings of one outer iteration: ``(T (B, K, N,
    N), flags (2, B, K))``, each solve's diverged flag and Sinkhorn
    iterations. Returns ``(Y, C, n_div)``, ``n_div`` ``(2,)`` int64: the
    solves that rolled back a Sinkhorn numerical failure while their
    molecule was not yet frozen, and the Sinkhorn iterations of all
    solves."""
    B, K, N, D = Ys.shape
    has_mass = p > 0
    inv_p = torch.where(has_mass, 1.0 / torch.where(has_mass, p, torch.ones_like(p)), 0.0)
    ppt = p[:, :, None] * p[:, None, :]
    ppt_safe = torch.where(ppt > 0, ppt, torch.ones_like(ppt))
    sg = config.stop_grad_couplings
    with torch.no_grad() if sg else contextlib.nullcontext():
        Ys_ng, Cs_ng = (Ys.detach(), Cs.detach()) if sg else (Ys, Cs)
        if config.loss_fun == "kl_loss":
            log_Cs = torch.log(torch.clamp(Cs_ng, min=1e-15))
        if sg:
            C, Y = C.detach(), Y.detach()
        T_indep = p[:, None, :, None] * ps[:, :, None, :]  # (B, K, N, N)
        T = T_indep
        Ms = sqdist(Y[:, None], Ys_ng)
        # row 0: each molecule's freeze flag; row 1 stays False, so that the
        # iterations row sums every solve
        masks = torch.zeros((2, B), dtype=torch.bool, device=Ys.device)
        frozen = masks[0]
        n_div = torch.zeros((2,), dtype=torch.int64, device=Ys.device)
        for _ in range(config.outer_iters):
            T_new, flags = solve(Ms, C, Cs_ng, T if config.warmstart else T_indep)
            n_div = n_div + torch.where(masks, 0, flags.sum(2)).sum(1)
            settled = []  # per molecule: an update moved by at most outer_tol
            if config.fixed_features:
                Y_new, Ms_new = Y, Ms
            else:
                # Y = diag(1/p) sum_k lambda_k T_k Ys_k
                Y_new = inv_p[:, :, None] * torch.einsum("bk,bknm,bkmd->bnd", lambdas, T_new, Ys_ng)
                Ms_new = sqdist(Y_new[:, None], Ys_ng)
                settled.append(_frob(Y_new - Y) <= config.outer_tol)
            if config.fixed_structure:
                C_new = C
            else:
                if config.loss_fun == "square_loss":
                    # C = sum_k lambda_k T_k C_k T_k^T / p p^T
                    upd = torch.einsum("bk,bknm,bkmj,bklj->bnl", lambdas, T_new, Cs_ng, T_new) / ppt_safe
                else:
                    # C = exp(sum_k lambda_k T_k log(C_k) T_k^T / p p^T)
                    upd = torch.exp(
                        torch.einsum("bk,bknm,bkmj,bklj->bnl", lambdas, T_new, log_Cs, T_new)
                        / ppt_safe)
                C_new = torch.where(ppt > 0, upd, 0.0)
                settled.append(_frob(C_new - C) <= config.outer_tol)
            # a fixed part counts as settled
            newly_frozen = (functools.reduce(torch.logical_and, settled) if settled
                            else torch.ones_like(frozen))
            m3 = frozen[:, None, None]
            m4 = frozen[:, None, None, None]
            Y = torch.where(m3, Y, Y_new)
            C = torch.where(m3, C, C_new)
            T = torch.where(m4, T, T_new)
            Ms = torch.where(m4, Ms, Ms_new)
            if sg:  # in place: under no_grad nothing keeps the old flags
                frozen.logical_or_(newly_frozen)
            else:  # autograd keeps them
                frozen = frozen | newly_frozen
                masks = torch.stack([frozen, torch.zeros_like(frozen)])
    if sg and not config.fixed_features:
        # re-apply the last feature update differentiably w.r.t. Ys; T holds
        # each molecule's couplings of its last applied update
        Y = inv_p[:, :, None] * torch.einsum("bk,bknm,bkmd->bnd", lambdas, T, Ys)
    return Y, C, n_div


def fgw_barycenter(
    Ys: torch.Tensor,
    Cs: torch.Tensor,
    ps: torch.Tensor,
    p: torch.Tensor,
    lambdas: torch.Tensor,
    config: FGWConfig = FGWConfig(),
    init_C: torch.Tensor | None = None,
    init_Y: torch.Tensor | None = None,
    return_diverged: bool = False,
):
    """FGW barycenter of one molecule's K graphs.

    Args:
      Ys: conformer node features ``(K, N, D)``.
      Cs: conformer structure matrices ``(K, N, N)``.
      ps: per-conformer marginals ``(K, N)``.
      p: barycenter marginal ``(N,)``.
      lambdas: barycenter weights ``(K,)``.
      init_C: initial barycenter structure; defaults to ``Cs[0]``.
      init_Y: initial features; defaults to zeros.

    Returns ``(Y (N, D), C (N, N))``, and with ``return_diverged`` also the
    number (an int64 0-d tensor) of coupling solves that hit a Sinkhorn
    numerical failure and rolled back. Any ``N`` on the card's K3 route
    (``fgw_couplings`` pads it to a multiple of 32; from 129 to 256 atoms
    K3's cluster route solves it, above 256 its global route).
    """
    K, N, D = Ys.shape
    C = Cs[0] if init_C is None else init_C
    Y = torch.zeros((N, D), dtype=Ys.dtype, device=Ys.device) if init_Y is None else init_Y
    if config.uses_kernel():
        def solve(Ms, Cb, Cks, T0):
            T, totals = k3.fgw_couplings(Ms[0], Cb[0], Cks[0], p, ps, T0[0], **config.solver())
            return T[None], totals.to(torch.int64).reshape(2, 1, 1)
    else:
        solve = _plain_solve(config, p[None], ps[None])
    Y, C, n_div = _descent(Ys[None], Cs[None], ps[None], p[None], lambdas[None], config,
                           C[None], Y[None], solve)
    if return_diverged:
        return Y[0], C[0], n_div[0]
    return Y[0], C[0]


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
    ``1/K``; each molecule starts from its first conformer's structure and
    zero features. On the K3 route (``config.uses_kernel()``) any ``N``
    (``fgw_couplings_flat`` pads it to a multiple of 32; from 129 to 256
    atoms K3's cluster route solves it, above 256 its global route).
    Returns ``(Y (B, N, D), C (B, N, N), n_div)``: ``n_div`` is ``(2,)``
    int64, the batch-total count of coupling solves that rolled back a
    Sinkhorn numerical failure while their molecule was not yet frozen,
    and the Sinkhorn iterations of all solves.
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
    C = Cs[:, 0]
    Y = torch.zeros((B, N, D), dtype=dt, device=dev)
    if config.uses_kernel():
        flat = lambda x: x.reshape(S, *x.shape[2:]).contiguous()  # noqa: E731
        p_flat = flat(p[:, None, :].expand(B, K, N).detach())
        ps_flat = flat(ps.detach())

        def solve(Ms, Cb, Cks, T0):
            T, flags = k3.fgw_couplings_flat(flat(Ms), flat(Cb[:, None].expand(B, K, N, N)),
                                             flat(Cks), p_flat, ps_flat, flat(T0),
                                             **config.solver())
            return T.reshape(B, K, N, N), flags.reshape(2, B, K).to(torch.int64)
    else:
        # JAX vmaps its per-molecule solver here: the same descent, batched
        solve = _plain_solve(config, p, ps)
    return _descent(Ys, Cs, ps, p, lambdas, config, C, Y, solve)
