"""Log-domain Sinkhorn, batched over leading solve axes
(port of ``conan_fgw_tpu/ops/fgw/sinkhorn.py``).

Same policy as the JAX solver: a fixed iteration budget; on iterations with
``it % check_every == 0`` (every 10th by default, the reference's cadence)
the column-marginal error of the would-be plan is checked and a solve whose
error is below ``stop_thr`` freezes; an update that produces non-finite
potentials is rolled back, the solve freezes and is flagged as diverged.
"""

from __future__ import annotations

import torch

# guard for log(0) on empty-mass marginals; a normal float32 (1e-38 would be
# subnormal and flush to zero)
LOG_EPS = 1e-30


def sinkhorn_log(
    p: torch.Tensor,
    q: torch.Tensor,
    cost: torch.Tensor,
    epsilon: float,
    *,
    num_iters: int = 5,
    stop_thr: float = 1e-2,
    check_every: int = 10,
    u0: torch.Tensor | None = None,
    v0: torch.Tensor | None = None,
    return_potentials: bool = False,
):
    """Entropic OT plans ``T = exp(-cost/eps + u ⊕ v)``.

    Args:
      p: source marginals ``(..., N)``.
      q: target marginals ``(..., M)``.
      cost: cost matrices ``(..., N, M)``.
      check_every: the marginal check runs on iterations ``it % check_every == 0``.
      u0, v0: warm-start log potentials ``(..., N)``, ``(..., M)`` (default 0).
      return_potentials: also return the final log potentials.

    Returns:
      ``(T (..., N, M), diverged (...) bool)``, or with ``return_potentials``
      ``(T, (u, v), diverged)``.
    """
    mr = -cost / epsilon
    logp = torch.log(torch.clamp(p, min=LOG_EPS))
    logq = torch.log(torch.clamp(q, min=LOG_EPS))
    batch = cost.shape[:-2]
    u = torch.zeros(p.shape, dtype=cost.dtype, device=cost.device) if u0 is None else u0
    v = torch.zeros(q.shape, dtype=cost.dtype, device=cost.device) if v0 is None else v0
    frozen = torch.zeros(batch, dtype=torch.bool, device=cost.device)
    diverged = torch.zeros_like(frozen)
    for it in range(num_iters):
        v_new = logq - torch.logsumexp(mr + u[..., :, None], dim=-2)
        u_new = logp - torch.logsumexp(mr + v_new[..., None, :], dim=-1)
        finite = torch.isfinite(u_new).all(-1) & torch.isfinite(v_new).all(-1)
        newly_diverged = ~finite & ~frozen
        newly_frozen = newly_diverged
        if it % check_every == 0:
            col = torch.exp(mr + u_new[..., :, None] + v_new[..., None, :]).sum(-2)
            err = torch.linalg.vector_norm(col - q, dim=-1)
            newly_frozen = (err < stop_thr) | newly_diverged
        keep = (frozen | newly_diverged)[..., None]
        u = torch.where(keep, u, u_new)
        v = torch.where(keep, v, v_new)
        frozen = frozen | newly_frozen
        diverged = diverged | newly_diverged
    T = torch.exp(mr + u[..., :, None] + v[..., None, :])
    if return_potentials:
        return T, (u, v), diverged
    return T, diverged
