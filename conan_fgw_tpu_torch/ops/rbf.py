"""Radial basis expansions (SchNet's Gaussians, ViSNet's exponential-normal),
the cosine cutoff and SchNet's activation (port of ``conan_fgw_tpu/ops/rbf.py``)."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def gaussian_smearing(
    dist: torch.Tensor, num_gaussians: int, start: float = 0.0, stop: float = 10.0
) -> torch.Tensor:
    """``exp(-0.5/dx^2 * (d - mu_k)^2)`` over a linspace grid of centres."""
    offset = torch.linspace(start, stop, num_gaussians, dtype=dist.dtype, device=dist.device)
    coeff = -0.5 / (offset[1] - offset[0]) ** 2
    return torch.exp(coeff * (dist[..., None] - offset) ** 2)


def cosine_cutoff(dist: torch.Tensor, cutoff: float) -> torch.Tensor:
    """``0.5 * (cos(pi d / r_c) + 1)``, zero beyond the cutoff."""
    c = 0.5 * (torch.cos(dist * math.pi / cutoff) + 1.0)
    return torch.where(dist <= cutoff, c, torch.zeros_like(c))


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """``softplus(x) - log(2)``."""
    return F.softplus(x) - math.log(2.0)


def expnorm_smearing(dist: torch.Tensor, means: torch.Tensor, betas: torch.Tensor,
                     cutoff: float) -> torch.Tensor:
    """ViSNet's exponential-normal RBF with the cosine-cutoff envelope."""
    alpha = 5.0 / cutoff
    env = cosine_cutoff(dist, cutoff)
    return env[..., None] * torch.exp(-betas * (torch.exp(-alpha * dist[..., None]) - means) ** 2)


def expnorm_initial_params(num_rbf: int, cutoff: float,
                           dtype: torch.dtype = torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Initial ``(means, betas)`` as the vendored ViSNet computes them."""
    start_value = math.exp(-cutoff)
    means = torch.linspace(start_value, 1.0, num_rbf, dtype=dtype)
    betas = torch.full((num_rbf,), (2.0 / num_rbf * (1.0 - start_value)) ** -2, dtype=dtype)
    return means, betas
