"""Masked-dense SchNet backbone with dual (3D / barycenter) heads
(port of ``conan_fgw_tpu/models/schnet.py``).

Atom embedding -> radius graph -> continuous-filter convolution blocks with
residual adds -> two small heads sharing the trunk (``lin1/lin2`` for the 3D
branch, ``lin1_bary/lin2_bary`` for the barycenter branch; the activation
comes after both linears, a quirk of the reference kept here).

The cfconv of every block goes through ``ops/cuda/cfconv.py::cfconv``: the
CUDA kernels K1/K2 for tensors on the card, the plain PyTorch formulation on
the CPU. Both read the same raw filter parameters ``filter_w1/b1/w2/b2``.
"""

from __future__ import annotations

import torch
from torch import nn

from conan_fgw_tpu_torch.ops.cuda.cfconv import cfconv
from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask
from conan_fgw_tpu_torch.ops.rbf import shifted_softplus


class InteractionBlock(nn.Module):
    """One continuous-filter convolution block (PyG ``InteractionBlock``)."""

    def __init__(self, hidden_channels: int, num_filters: int, cutoff: float,
                 num_gaussians: int = 50, max_neighbors: int | None = 32):
        super().__init__()
        self.cutoff = cutoff
        self.num_gaussians = num_gaussians
        self.max_neighbors = max_neighbors
        self.filter_w1 = nn.Parameter(torch.empty(num_gaussians, num_filters))
        self.filter_b1 = nn.Parameter(torch.empty(num_filters))
        self.filter_w2 = nn.Parameter(torch.empty(num_filters, num_filters))
        self.filter_b2 = nn.Parameter(torch.empty(num_filters))
        self.lin1 = nn.Linear(hidden_channels, num_filters, bias=False)
        self.lin2 = nn.Linear(num_filters, hidden_channels)
        self.lin = nn.Linear(hidden_channels, hidden_channels)

    def forward(self, h, pos, mask):
        """``h (G, N, H)``, ``pos (G, N, 3)``, ``mask (G, N)`` bool."""
        x = self.lin1(h)
        m = cfconv(
            pos.contiguous(), mask.to(torch.float32).contiguous(), x.contiguous(),
            self.filter_w1, self.filter_b1, self.filter_w2, self.filter_b2,
            self.cutoff, self.num_gaussians, self.max_neighbors,
        )
        return self.lin(shifted_softplus(self.lin2(m)))


class SchNet3D(nn.Module):
    """SchNet trunk + dual heads over padded conformer point clouds.

    Defaults follow the reference regression configuration: hidden=128,
    filters=128, gaussians=50, interactions=3, cutoff=10, 32 neighbours.
    """

    def __init__(self, hidden_channels: int = 128, num_filters: int = 128,
                 num_interactions: int = 3, num_gaussians: int = 50, cutoff: float = 10.0,
                 max_neighbors: int | None = 32):
        super().__init__()
        self.cutoff = cutoff
        self.max_neighbors = max_neighbors
        self.embedding = nn.Embedding(100, hidden_channels)
        self.blocks = nn.ModuleList(
            InteractionBlock(hidden_channels, num_filters, cutoff, num_gaussians, max_neighbors)
            for _ in range(num_interactions)
        )
        half = hidden_channels // 2
        self.lin1 = nn.Linear(hidden_channels, half)
        self.lin2 = nn.Linear(half, half)
        self.lin1_bary = nn.Linear(hidden_channels, half)
        self.lin2_bary = nn.Linear(half, half)

    def trunk(self, z, pos, mask):
        h = self.embedding(z.long()) * mask[..., None].to(torch.float32)
        for blk in self.blocks:
            h = h + blk(h, pos, mask)
        return h

    def forward(self, z, pos, mask):
        """3D branch only (stage 1): per-node features ``(..., N, hidden//2)``."""
        return shifted_softplus(self.lin2(self.lin1(self.trunk(z, pos, mask))))

    def embed_dual(self, z, pos, mask):
        """Both heads off the shared trunk: ``(h_3d, h_bary, nbr_mask)``; the
        neighbour mask doubles as the conformer structure graph for FGW."""
        h = self.trunk(z, pos, mask)
        nbr = radius_graph_mask(pairwise_distances(pos), mask, self.cutoff, self.max_neighbors)
        h3 = shifted_softplus(self.lin2(self.lin1(h)))
        hb = shifted_softplus(self.lin2_bary(self.lin1_bary(h)))
        return h3, hb, nbr
