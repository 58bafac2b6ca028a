"""ESAN conformer-subgraph aggregation networks, dense masked form (port of
``conan_fgw_tpu/models/esan.py``).

A siamese SchNet encodes each conformer, an "info-sharing" SchNet encodes
the average conformer (the mean of the positions over K: the atoms are the
same in every conformer), and DeepSets sums over the conformers. The
geometry-induced variants add GAT branches over the covalent graph and over
each conformer's radius graph, with its Gaussian edge features
(``GeometryInducedESAN``) or the bond attributes masked to it
(``Geometry2DInducedESAN``). Every variant takes a ``PackedBatch`` and
returns molecule embeddings ``(B, hidden // 2)``.

Every SchNet here has 6 interactions of 128 filters and 50 Gaussians whatever
``hidden_channels`` is; their blocks run through the cfconv kernels K1/K2 on
the card. The GATs are 64 wide whatever ``hidden_channels`` is.
"""

from __future__ import annotations

import torch
from torch import nn

from conan_fgw_tpu_torch.data.vocab import NUM_ATOM_FEATURES, NUM_BOND_FEATURES
from conan_fgw_tpu_torch.models.gat import GAT2D
from conan_fgw_tpu_torch.models.schnet import SchNet3D
from conan_fgw_tpu_torch.ops.graph import masked_sum, pairwise_distances, radius_graph_mask

# the SchNet of every ESAN constructor (the reference's SchNetNoSum defaults)
SCHNET = dict(num_filters=128, num_gaussians=50, num_interactions=6, cutoff=10.0)
GAT_WIDTH = 64
# Geometry2DInducedESAN's radius graph: the SchNets' cutoff and this
# neighbour cap (the JAX module's defaults)
MAX_NEIGHBORS = 32


def flatten(batch):
    """``(z, pos, mask)`` of the batch's ``B * K`` conformer graphs and
    ``(B, K, N)``."""
    B, K, N = batch.z.shape
    return (batch.z.reshape(B * K, N), batch.pos.reshape(B * K, N, 3),
            batch.atom_mask.repeat_interleave(K, dim=0), (B, K, N))


def shared(batch):
    """The info-sharing SchNet's input: each molecule's first conformer's
    atoms, the average conformer's positions and the atom mask."""
    return batch.z[:, 0], batch.pos.mean(1), batch.atom_mask


class DeepSets(nn.Module):
    """``sum_k lin(h_k)``: DeepSets aggregation with a linear local net
    (the bias is summed over K too)."""

    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.lin = nn.Linear(in_channels, channels)

    def forward(self, h_conf):  # (B, K, C)
        return self.lin(h_conf).sum(1)


class AverageConformerESAN(nn.Module):
    """Siamese SchNet per conformer + SchNet on the average conformer."""

    def __init__(self, hidden_channels: int = 128):
        super().__init__()
        half = hidden_channels // 2
        self.siamese = SchNet3D(hidden_channels, **SCHNET)
        self.info_sharing = SchNet3D(hidden_channels, **SCHNET)
        self.deep_sets = DeepSets(half, half)

    def forward(self, batch):
        zf, posf, maskf, (B, K, N) = flatten(batch)
        h = self.siamese(zf, posf, maskf)
        out = self.deep_sets(masked_sum(h, maskf).reshape(B, K, -1))
        z, pos_avg, mask = shared(batch)
        return out + masked_sum(self.info_sharing(z, pos_avg, mask), mask)


class GeometryInducedESAN(nn.Module):
    """3D siamese SchNet (its one-linear head) + a GAT on the covalent graph
    + a GAT on each conformer's radius graph with its Gaussian edge
    features, + the average-conformer SchNet."""

    def __init__(self, hidden_channels: int = 128):
        super().__init__()
        half = hidden_channels // 2
        self.siamese = SchNet3D(hidden_channels, heads="simple", **SCHNET)
        self.info_sharing = SchNet3D(hidden_channels, **SCHNET)
        self.gat_2d = GAT2D(NUM_ATOM_FEATURES, GAT_WIDTH, NUM_BOND_FEATURES)
        self.gat_rbf = GAT2D(NUM_ATOM_FEATURES, GAT_WIDTH, SCHNET["num_gaussians"])
        self.transformation = nn.Linear(GAT_WIDTH, half)
        self.deep_sets = DeepSets(half, half)

    def forward(self, batch):
        zf, posf, maskf, (B, K, N) = flatten(batch)
        h, nbr, rbf = self.siamese.embed_simple(zf, posf, maskf)
        h3d = masked_sum(h, maskf).reshape(B, K, -1)
        x2d_bond = self.gat_2d(batch.x2d, batch.bond_adj, batch.bond_attr, batch.atom_mask)
        x2df = batch.x2d.repeat_interleave(K, dim=0)
        x2d_sub = self.gat_rbf(x2df, nbr, rbf, maskf).reshape(B, K, -1)
        out = self.deep_sets(h3d + self.transformation(x2d_bond[:, None, :] + x2d_sub))
        z, pos_avg, mask = shared(batch)
        return out + masked_sum(self.info_sharing(z, pos_avg, mask), mask)


class Geometry2DInducedESAN(nn.Module):
    """GATs only: the covalent graph, and the bond attributes masked to each
    conformer's radius graph, + the average-conformer SchNet (the JAX
    module computes no siamese SchNet: the reference's output of it is
    unused)."""

    def __init__(self, hidden_channels: int = 128):
        super().__init__()
        half = hidden_channels // 2
        self.info_sharing = SchNet3D(hidden_channels, **SCHNET)
        self.gat_2d = GAT2D(NUM_ATOM_FEATURES, GAT_WIDTH, NUM_BOND_FEATURES)
        self.gat_sub = GAT2D(NUM_ATOM_FEATURES, GAT_WIDTH, NUM_BOND_FEATURES)
        self.transformation = nn.Linear(half, half)
        self.deep_sets = DeepSets(GAT_WIDTH, half)

    def forward(self, batch):
        zf, posf, maskf, (B, K, N) = flatten(batch)
        nbr = radius_graph_mask(pairwise_distances(posf), maskf, SCHNET["cutoff"], MAX_NEIGHBORS)
        x2d_bond = self.gat_2d(batch.x2d, batch.bond_adj, batch.bond_attr, batch.atom_mask)
        x2df = batch.x2d.repeat_interleave(K, dim=0)
        battrf = batch.bond_attr.repeat_interleave(K, dim=0) * nbr[..., None].to(torch.float32)
        x2d_sub = self.gat_sub(x2df, nbr, battrf, maskf).reshape(B, K, -1)
        out = self.transformation(self.deep_sets(x2d_bond[:, None, :] + x2d_sub))
        z, pos_avg, mask = shared(batch)
        return out + masked_sum(self.info_sharing(z, pos_avg, mask), mask)


VARIANTS = {
    "avg_conf_esan": AverageConformerESAN,
    "geometry_induced_esan": GeometryInducedESAN,
    "geometry_2d_induced_esan": Geometry2DInducedESAN,
}
