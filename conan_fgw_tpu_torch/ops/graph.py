"""Dense masked graph primitives (port of ``conan_fgw_tpu/ops/graph.py``).

Per-molecule padded node axes and boolean neighbour masks: every
aggregation is a masked product over a dense ``(N, N)`` mask, and no shape
depends on the data. The lookups (``embed_onehot``, ``gather_rows``) have
backward passes that sum in a fixed order, so that training on the card is
bit-reproducible across processes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
    cap_mode: str | None = "index",
) -> torch.Tensor:
    """Dense neighbour mask ``nbr[..., i, j]`` = "j is a message source for i".

    PyG ``radius_graph(pos, r=cutoff, max_num_neighbors=cap)`` semantics: for
    each target, the neighbours within ``cutoff``. Where more than
    ``max_neighbors`` qualify, ``cap_mode="index"`` keeps torch-cluster's
    first ones by index (the first ``cap + 1`` candidates, self included,
    then the self loop is dropped) and ``"nearest"`` the closest ones.
    ``max_neighbors=None`` keeps all of them; another ``cap_mode`` (None
    included, as in the JAX package) raises where the cap would bind.
    """
    n = dist.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    valid_pair = mask[..., :, None] & mask[..., None, :]
    within = valid_pair & (dist <= cutoff)
    nbr = within & ~eye
    if max_neighbors is None or max_neighbors >= n:
        return nbr
    if cap_mode == "index":
        cand = (within | (eye & valid_pair)).to(torch.int32)
        rank = torch.cumsum(cand, dim=-1) - cand
        return nbr & (rank < max_neighbors + 1)
    if cap_mode == "nearest":
        big = torch.where(nbr, dist, torch.full_like(dist, float("inf")))
        rank = torch.argsort(torch.argsort(big, dim=-1, stable=True), dim=-1, stable=True)
        return nbr & (rank < max_neighbors)
    raise ValueError(f"unknown cap_mode {cap_mode!r}")


def masked_sum(h: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Sum-readout over the node axis under a validity mask."""
    return torch.sum(h * mask[..., None].to(h.dtype), dim=dim)


def masked_mean(h: torch.Tensor, mask: torch.Tensor, dim: int = -2) -> torch.Tensor:
    """Mean-readout over the node axis under a validity mask (at least one
    node in the denominator)."""
    m = mask[..., None].to(h.dtype)
    return torch.sum(h * m, dim=dim) / torch.clamp(torch.sum(m, dim=dim), min=1.0)


def embed_onehot(z: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows ``table[z]`` as the product of the one-hot ``z`` with the table.

    The same rows bit for bit as a lookup (one 1 and zeros), but the
    backward is a matrix product, which sums in a fixed order; the lookup's
    backward on the card accumulates the table's gradient in an order that
    varies from process to process."""
    return F.one_hot(z.long(), table.shape[0]).to(table.dtype) @ table


def _take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[g, p] = table[g, idx[g, p]]`` for ``table (G, N, D)`` and
    ``idx (G, P)``, as one ``index_select`` of whole rows of the flattened
    table (a row copy; advanced indexing computes each element's offset)."""
    G, N = table.shape[:2]
    rows = idx + N * torch.arange(G, device=idx.device)[:, None]
    return table.reshape(G * N, -1).index_select(0, rows.reshape(-1)).reshape(G, idx.shape[1], -1)


class _GatherRows(torch.autograd.Function):
    """``_take_rows`` whose backward is the product of the one-hot
    ``idx``'s transpose with the output's gradient, so it sums the rows
    that gathered one entry in a fixed order (an indexed scatter-add on the
    card sums them in an order that varies from run to run)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[1]
        return _take_rows(table, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        onehot = F.one_hot(idx, ctx.n).to(grad.dtype)  # (G, P, N)
        return onehot.transpose(1, 2) @ grad, None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Batched row gather: ``out[g, *i] = table[g, idx[g, *i]]`` for
    ``table (G, N, *rest)`` and integer ``idx (G, *i)``; returns ``(G, *i,
    *rest)``. Its backward is deterministic (``_GatherRows``): of order
    ``G * N * P * D`` multiply-adds for ``P`` gathered rows of ``D`` values."""
    G, N = table.shape[:2]
    rest, inner = table.shape[2:], idx.shape[1:]
    flat = table.reshape(G, N, -1)
    flat_idx = idx.reshape(G, -1).long()
    return _GatherRows.apply(flat, flat_idx).reshape(G, *inner, *rest)
