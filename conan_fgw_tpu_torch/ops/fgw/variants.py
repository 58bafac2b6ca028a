"""Alternative OT/FGW solvers (port of ``conan_fgw_tpu/ops/fgw/variants.py``).

* ``sinkhorn_knopp`` — kernel-space scaling
* ``sinkhorn_stabilized`` — log-stabilised with tau-absorption
* ``sinkhorn_epsilon_scaling`` — outer epsilon annealing
* ``greenkhorn`` — greedy coordinate updates
* ``fgw_coupling_bapg`` / ``fgw_barycenter_bapg`` — Bregman alternating
  projected gradient
* ``fgw_coupling_bregman`` — direct Bregman row/column updates

Plain PyTorch on any device, one solve per call (``p (N,)``, ``q (M,)``,
``cost (N, M)``), with the JAX solvers' clamps and fixed iteration counts;
no data-dependent branch reaches the host, so a call on the card never
synchronises. The hot path uses ``sinkhorn_log``; these exist for API
parity and experimentation.
"""

from __future__ import annotations

import torch

from conan_fgw_tpu_torch.ops.fgw.barycenter import sqdist
from conan_fgw_tpu_torch.ops.fgw.coupling import square_loss_const
from conan_fgw_tpu_torch.ops.fgw.sinkhorn import sinkhorn_log


def sinkhorn_knopp(p, q, cost, epsilon, *, num_iters=100, stop_thr=1e-9):
    """Classic kernel-space Sinkhorn scaling.

    The stop test measures the row marginal right after the row update,
    where it holds to rounding: its residual is taken in float64 from the
    f32 factors, as XLA's fused multiply-subtract leaves it unrounded. In
    f32 it is 0 or an ulp (7e-9 at mass 1/9), so the default 1e-9 would
    stop a solve whenever every row happened to round exactly."""
    k = torch.exp(-cost / epsilon)
    u = torch.ones_like(p) / p.shape[-1]
    v = torch.ones_like(q) / q.shape[-1]
    frozen = torch.zeros((), dtype=torch.bool, device=cost.device)
    f64 = torch.float64
    for _ in range(num_iters):
        v_new = q / torch.clamp(k.T @ u, min=1e-38)
        u_new = p / torch.clamp(k @ v_new, min=1e-38)
        err = torch.linalg.vector_norm(u_new.to(f64) * (k @ v_new).to(f64) - p.to(f64))
        u = torch.where(frozen, u, u_new)
        v = torch.where(frozen, v, v_new)
        frozen = frozen | (err < stop_thr)
    return u[:, None] * k * v[None, :]


def sinkhorn_stabilized(p, q, cost, epsilon, *, num_iters=100, tau=1e3, stop_thr=1e-9):
    """Sinkhorn with log-domain absorption when scalings exceed ``tau``
    (``stop_thr`` is accepted and unused, as in the JAX solver)."""
    alpha = torch.zeros_like(p)
    beta = torch.zeros_like(q)
    u = torch.ones_like(p) / p.shape[-1]
    v = torch.ones_like(q) / q.shape[-1]

    def kernel(alpha, beta):
        return torch.exp(-(cost - alpha[:, None] - beta[None, :]) / epsilon)

    for _ in range(num_iters):
        k = kernel(alpha, beta)
        v_new = q / torch.clamp(k.T @ u, min=1e-300)
        u_new = p / torch.clamp(k @ v_new, min=1e-300)
        absorb = (u_new.abs().max() > tau) | (v_new.abs().max() > tau)
        alpha = torch.where(absorb, alpha + epsilon * torch.log(torch.clamp(u_new, min=1e-300)), alpha)
        beta = torch.where(absorb, beta + epsilon * torch.log(torch.clamp(v_new, min=1e-300)), beta)
        u = torch.where(absorb, torch.ones_like(u_new), u_new)
        v = torch.where(absorb, torch.ones_like(v_new), v_new)
    return u[:, None] * kernel(alpha, beta) * v[None, :]


def sinkhorn_epsilon_scaling(p, q, cost, epsilon, *, num_iters=100, num_outer=10, eps0=1e1):
    """Anneal epsilon geometrically toward the target, warm-starting the
    log potentials, then polish at the target epsilon."""
    u = torch.zeros_like(p)
    v = torch.zeros_like(q)
    for it in range(num_outer):
        eps_it = max(float(epsilon), float(eps0 * (epsilon / eps0) ** ((it + 1) / num_outer)))
        _, (u, v), _, _ = sinkhorn_log(p, q, cost, eps_it, num_iters=num_iters // num_outer + 1,
                                       u0=u, v0=v, return_potentials=True)
    T, _, _ = sinkhorn_log(p, q, cost, epsilon, num_iters=num_iters, u0=u, v0=v)
    return T


def greenkhorn(p, q, cost, epsilon, *, num_iters=1000):
    """Greedy coordinate Sinkhorn: each step rescales the single worst row
    or column. Sequential by nature: a loop of argmax picks, each a few
    small operations that stay on the tensors' device."""
    k = torch.exp(-cost / epsilon)
    u = torch.full_like(p, 1.0 / p.shape[-1])
    v = torch.full_like(q, 1.0 / q.shape[-1])
    for _ in range(num_iters):
        T = u[:, None] * k * v[None, :]
        row_gain = (T.sum(1) - p).abs()
        col_gain = (T.sum(0) - q).abs()
        i = torch.argmax(row_gain)
        j = torch.argmax(col_gain)
        do_row = row_gain[i] >= col_gain[j]
        u_new = u.index_put((i[None],), p[i] / torch.clamp((k @ v)[i], min=1e-38))
        v_new = v.index_put((j[None],), q[j] / torch.clamp((k.T @ u)[j], min=1e-38))
        u, v = torch.where(do_row, u_new, u), torch.where(do_row, v, v_new)
    return u[:, None] * k * v[None, :]


def fgw_coupling_bapg(M, C1, C2, p, q, T0=None, *, alpha=0.5, rho=0.1, num_iters=100):
    """Bregman alternating projected gradient coupling (exponentiated-gradient
    row and column updates)."""
    T = p[:, None] * q[None, :] if T0 is None else T0
    for _ in range(num_iters):
        T = T + 1e-10
        grad = 4.0 * alpha * C1 @ T @ C2 - (1.0 - alpha) * M
        T = torch.exp(grad / rho) * T
        T = T * (p / torch.clamp(T.sum(1), min=1e-38))[:, None]
        grad = 4.0 * alpha * C1 @ T @ C2 - (1.0 - alpha) * M
        T = torch.exp(grad / rho) * T
        T = T * (q / torch.clamp(T.sum(0), min=1e-38))[None, :]
    return T


def fgw_coupling_bregman(M, C1, C2, p, q, T0=None, *, alpha=0.5, epsilon=0.1, num_iters=100,
                         marginal_loss=False):
    """Direct Bregman row and column multiplicative updates."""
    constC, hC1, hC2 = square_loss_const(C1, C2, p, q)
    T = p[:, None] * q[None, :] if T0 is None else T0

    def df(T):
        if marginal_loss:
            return alpha * 2.0 * (constC - hC1 @ T @ hC2.T) + (1 - alpha) * M
        return 2.0 * alpha * (-(hC1 @ T @ hC2.T)) + (1 - alpha) * M

    for _ in range(num_iters):
        T = T * torch.exp(-df(T) / epsilon)
        T = (p / torch.clamp(T.sum(1), min=1e-38))[:, None] * T
        T = T * torch.exp(-df(T) / epsilon)
        T = T * (q / torch.clamp(T.sum(0), min=1e-38))[None, :]
    return T


def fgw_barycenter_bapg(Ys, Cs, ps, p, lambdas, *, alpha=0.5, rho=1.0, outer_iters=5,
                        coupling_iters=100, init_C=None):
    """BAPG barycenter: the block-coordinate descent of ``fgw_barycenter``
    with the BAPG coupling inside, solved without gradient; ``Y`` stays
    differentiable with respect to ``Ys`` through its last update."""
    K, N, D = Ys.shape
    C = Cs[0] if init_C is None else init_C
    Y = torch.zeros((N, D), dtype=Ys.dtype, device=Ys.device)
    inv_p = 1.0 / p
    ppt = p[:, None] * p[None, :]
    for _ in range(outer_iters):
        Ms = sqdist(Y[None], Ys)
        with torch.no_grad():
            T = torch.stack([
                fgw_coupling_bapg(Ms[k], C, Cs[k], p, ps[k], alpha=alpha, rho=rho,
                                  num_iters=coupling_iters)
                for k in range(K)
            ])
        Y = inv_p[:, None] * torch.einsum("k,knm,kmd->nd", lambdas, T, Ys)
        C = torch.einsum("k,knm,kmj,klj->nl", lambdas, T, Cs, T) / ppt
    return Y, C
