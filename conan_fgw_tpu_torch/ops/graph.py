"""Dense masked graph primitives (port of ``conan_fgw_tpu/ops/graph.py``).

Per-molecule padded node axes and boolean neighbour masks: every
aggregation is a masked product over a dense ``(N, N)`` mask, and no shape
depends on the data.
"""

from __future__ import annotations

import torch


def pairwise_distances(pos: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Euclidean distance matrix ``(..., N, N)`` from positions ``(..., N, 3)``,
    in the Gram form, clamped at ``eps`` so the sqrt stays differentiable."""
    sq = torch.sum(pos * pos, dim=-1)
    d2 = sq[..., :, None] + sq[..., None, :] - 2.0 * pos @ pos.transpose(-1, -2)
    return torch.sqrt(torch.clamp(d2, min=eps))


def radius_graph_mask(
    dist: torch.Tensor,
    mask: torch.Tensor,
    cutoff: float,
    max_neighbors: int | None = 32,
) -> torch.Tensor:
    """Dense neighbour mask ``nbr[..., i, j]`` = "j is a message source for i".

    PyG ``radius_graph(pos, r=cutoff, max_num_neighbors=cap)`` semantics with
    torch-cluster's first-by-index cap: the first ``cap + 1`` candidates
    (self included) are kept, then the self loop is dropped.
    """
    n = dist.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    valid_pair = mask[..., :, None] & mask[..., None, :]
    within = valid_pair & (dist <= cutoff)
    nbr = within & ~eye
    if max_neighbors is None or max_neighbors >= n:
        return nbr
    cand = (within | (eye & valid_pair)).to(torch.int32)
    rank = torch.cumsum(cand, dim=-1) - cand
    return nbr & (rank < max_neighbors + 1)


def masked_sum(h: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Sum-readout over the node axis under a validity mask."""
    return torch.sum(h * mask[..., None].to(h.dtype), dim=dim)
