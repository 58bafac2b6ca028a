"""Dense masked GAT over the 2D covalent graph (port of
``conan_fgw_tpu/models/gat.py``).

Two PyG ``GATConv`` layers with 3-dim bond attributes (no activation in
between, a reference quirk) and a sum readout. Self-loops carry the mean of
the incoming edges' attributes; masked logits are -1e9, never -inf, so fully
masked rows stay NaN-free under softmax and its gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class DenseGATConv(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, edge_dim: int = 3,
                 negative_slope: float = 0.2):
        super().__init__()
        self.negative_slope = negative_slope
        self.lin = nn.Linear(in_channels, out_channels, bias=False)
        self.lin_edge = nn.Linear(edge_dim, out_channels, bias=False)
        self.att_src = nn.Parameter(torch.empty(1, out_channels))
        self.att_dst = nn.Parameter(torch.empty(1, out_channels))
        self.att_edge = nn.Parameter(torch.empty(1, out_channels))
        self.bias = nn.Parameter(torch.empty(out_channels))

    def forward(self, x, adj, edge_attr, mask):
        """x: (..., N, F); adj: (..., N, N) bool (symmetric, no self loops);
        edge_attr: (..., N, N, E); mask: (..., N) node validity."""
        n = x.shape[-2]
        xs = self.lin(x)
        adj_f = adj.to(x.dtype)
        deg = adj_f.sum(-1, keepdim=True)
        loop_attr = torch.einsum("...ji,...jie->...ie", adj_f, edge_attr) / torch.clamp(deg, min=1.0)
        eye = torch.eye(n, dtype=torch.bool, device=x.device)
        edge_attr = torch.where(eye[..., None], loop_attr[..., None, :, :], edge_attr)
        e_proj = self.lin_edge(edge_attr)

        a_src = (xs * self.att_src).sum(-1)
        a_dst = (xs * self.att_dst).sum(-1)
        a_edge = (e_proj * self.att_edge).sum(-1)
        logits = a_src[..., None, :] + a_dst[..., :, None] + a_edge
        logits = F.leaky_relu(logits, self.negative_slope)

        attend = (adj | eye) & mask[..., None, :] & mask[..., :, None]
        logits = torch.where(attend, logits, torch.full_like(logits, -1e9))
        alpha = torch.softmax(logits, dim=-1)
        alpha = torch.where(attend, alpha, torch.zeros_like(alpha))
        out = alpha @ xs + self.bias
        return out * mask[..., None].to(x.dtype)


class GAT2D(nn.Module):
    """Two-layer GAT + masked sum readout (``GATBased.forward``)."""

    def __init__(self, in_channels: int = 9, out_channels: int = 64, edge_dim: int = 3):
        super().__init__()
        self.convs = nn.ModuleList([
            DenseGATConv(in_channels, out_channels, edge_dim),
            DenseGATConv(out_channels, out_channels, edge_dim),
        ])

    def forward(self, x2d, adj, edge_attr, mask):
        dt = self.convs[0].lin.weight.dtype  # float32 but in a float64 reference step
        h = x2d.to(dt)
        e = edge_attr.to(dt)
        for conv in self.convs:
            h = conv(h, adj, e, mask)
        return torch.sum(h * mask[..., None].to(h.dtype), dim=-2)
