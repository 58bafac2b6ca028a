"""Masked-dense SchNet backbone with dual (3D / barycenter) heads
(port of ``conan_fgw_tpu/models/schnet.py``).

Atom embedding -> radius graph -> continuous-filter convolution blocks with
residual adds -> two small heads sharing the trunk (``lin1/lin2`` for the 3D
branch, ``lin1_bary/lin2_bary`` for the barycenter branch; the activation
comes after both linears, a quirk of the reference kept here).

The cfconv of every block goes through ``ops/cuda/cfconv.py::cfconv``: the
CUDA kernels K1/K2 for tensors on the card, the plain PyTorch formulation on
the CPU. Both read the same raw filter parameters ``filter_w1/b1/w2/b2``.

``use_covalent`` adds the parallel stack of ``CovalentInteractionBlock``s
over the covalent bond graph (the JAX module's ``blocks_cov``), whose output
is concatenated to the radius stack's before the heads. ``heads="simple"``
keeps ``lin1`` alone, for a SchNet reached only through ``embed_simple``
(the flax module then creates no other head).

``compute_dtype`` bf16 (a config's ``compute_dtype: bfloat16``) runs the
interaction blocks as the JAX module's ``dtype=bfloat16`` blocks do: ``h``
cast to bf16, ``lin1``/``lin2``/``lin`` as flax's ``Dense(dtype=bf16)``
(``dense``), the activation on bf16, and the cfconv on bf16 node features
through the kernels' bf16 variants, which give what the JAX model's cast to
f32, f32 kernel and cast back give. The residual sum promotes to f32 again;
the parameters, the heads and the covalent stack stay f32. ``float16`` runs
the same way in f16; there the JAX module takes its XLA cfconv, which the
plain version follows on the CPU, while the card's f16 kernels compute in
f32 and round once (``ops/cuda/cfconv.py``). A float64 name computes in
float32, as JAX without x64 does (``device.py::compute_dtype``).

``neighbor_cap_mode`` ("index" or "nearest") picks the neighbours a binding
cap keeps, for the FGW structure graph (``neighbor_graph``) and every
block's cfconv alike. ``remat=True`` recomputes each interaction block in
the backward (``torch.utils.checkpoint``), as the JAX module's
``nn.remat`` does: the cfconv's forward kernel then runs twice a block a
train step, and the gradients are bit-identical to ``remat=False``.

The atom embedding is a product of the one-hot atomic numbers with the
table (``ops/graph.py::embed_onehot``), not ``nn.Embedding``'s lookup: the
lookup's backward on the card accumulates the table's gradient in an order
that varies from process to process, so two runs of the same seeded
training differed in their last bits.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from conan_fgw_tpu_torch.data.vocab import NUM_BOND_FEATURES
from conan_fgw_tpu_torch.device import compute_dtype as resolve_compute_dtype
from conan_fgw_tpu_torch.ops.cuda.cfconv import cfconv
from conan_fgw_tpu_torch.ops.graph import embed_onehot, pairwise_distances, radius_graph_mask
from conan_fgw_tpu_torch.ops.rbf import gaussian_smearing, shifted_softplus


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
    """``lin(x)`` as flax's ``Dense(dtype=dtype)`` computes it: the input and
    the f32 parameters cast to ``dtype`` per call, the product rounded to
    ``dtype`` (f32 sums), then the bias added in ``dtype``, a second
    rounding (``F.linear`` with the bias fuses it and rounds once). With
    ``dtype`` None, ``lin(x)``."""
    if dtype is None:
        return lin(x)
    y = F.linear(x.to(dtype), lin.weight.to(dtype))
    return y if lin.bias is None else y + lin.bias.to(dtype)


class InteractionBlock(nn.Module):
    """One continuous-filter convolution block (PyG ``InteractionBlock``),
    computed in ``compute_dtype`` (bf16, f16, or None: the parameters'
    type), its neighbours capped by ``cap_mode``."""

    def __init__(self, hidden_channels: int, num_filters: int, cutoff: float,
                 num_gaussians: int = 50, max_neighbors: int | None = 32,
                 compute_dtype: torch.dtype | None = None, cap_mode: str = "index"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.cap_mode = cap_mode
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
        """``h (G, N, H)``, ``pos (G, N, 3)``, ``mask (G, N)`` bool; the
        block's output is in ``compute_dtype``."""
        dt = self.compute_dtype
        x = dense(self.lin1, h if dt is None else h.to(dt), dt)
        m = cfconv(
            pos.contiguous(), mask.to(torch.float32).contiguous(), x.contiguous(),
            self.filter_w1, self.filter_b1, self.filter_w2, self.filter_b2,
            self.cutoff, self.num_gaussians, self.max_neighbors, cap_mode=self.cap_mode,
        )
        return dense(self.lin, shifted_softplus(dense(self.lin2, m, dt)), dt)


class CovalentInteractionBlock(nn.Module):
    """One block of the covalent stack: a cfconv whose "RBF" is the bond
    attributes, whose neighbours are the bonds (no cap) and whose distances
    are all one, so its cosine envelope is the constant ``0.5 (cos(pi /
    cutoff) + 1)``.

    The JAX package runs this block outside any Pallas kernel (its covalent
    blocks always take the XLA formulation), so here it is plain PyTorch on
    the card as on the CPU: a masked product over a materialised filter.
    The filter depends on the molecule alone, so it is computed once per
    molecule, ``(M, N, N, F)``, and applied to the molecule's ``G / M``
    conformers, not repeated for each."""

    def __init__(self, hidden_channels: int, num_filters: int, cutoff: float):
        super().__init__()
        self.envelope = 0.5 * (math.cos(math.pi / cutoff) + 1.0)
        self.filter_w1 = nn.Parameter(torch.empty(NUM_BOND_FEATURES, num_filters))
        self.filter_b1 = nn.Parameter(torch.empty(num_filters))
        self.filter_w2 = nn.Parameter(torch.empty(num_filters, num_filters))
        self.filter_b2 = nn.Parameter(torch.empty(num_filters))
        self.lin1 = nn.Linear(hidden_channels, num_filters, bias=False)
        self.lin2 = nn.Linear(num_filters, hidden_channels)
        self.lin = nn.Linear(hidden_channels, hidden_channels)

    def forward(self, h, bond_adj, bond_attr):
        """``h (G, N, H)``; ``bond_adj (M, N, N)`` bool and ``bond_attr (M,
        N, N, 3)`` of the ``M`` molecules whose conformers ``h`` holds, each
        molecule's ``G / M`` in a row."""
        M, N = bond_adj.shape[:2]
        x = self.lin1(h)
        w = shifted_softplus(bond_attr.to(x.dtype) @ self.filter_w1 + self.filter_b1)
        w = w @ self.filter_w2 + self.filter_b2
        w = w * (self.envelope * bond_adj.to(x.dtype))[..., None]
        m = torch.einsum("mijf,mkjf->mkif", w, x.reshape(M, -1, N, x.shape[-1]))
        return self.lin(shifted_softplus(self.lin2(m.reshape(x.shape))))


class SchNet3D(nn.Module):
    """SchNet trunk + dual heads over padded conformer point clouds.

    Defaults follow the reference regression configuration: hidden=128,
    filters=128, gaussians=50, interactions=3, cutoff=10, 32 neighbours.
    ``heads``: "dual" (``lin1/lin2`` and ``lin1_bary/lin2_bary``) or
    "simple" (``lin1`` alone, for ``embed_simple``). ``compute_dtype``:
    the interaction blocks' type, a name ``device.py::compute_dtype``
    takes. ``neighbor_cap_mode`` and ``remat`` as in the module docstring.
    """

    def __init__(self, hidden_channels: int = 128, num_filters: int = 128,
                 num_interactions: int = 3, num_gaussians: int = 50, cutoff: float = 10.0,
                 max_neighbors: int | None = 32, use_covalent: bool = False,
                 heads: str = "dual", compute_dtype: str = "float32",
                 neighbor_cap_mode: str = "index", remat: bool = False):
        super().__init__()
        if heads not in ("dual", "simple"):
            raise ValueError(f"unknown heads {heads!r}")
        if neighbor_cap_mode not in ("index", "nearest"):
            raise ValueError(f"unknown neighbor_cap_mode {neighbor_cap_mode!r}")
        self.cutoff = cutoff
        self.num_gaussians = num_gaussians
        self.max_neighbors = max_neighbors
        self.neighbor_cap_mode = neighbor_cap_mode
        self.remat = remat
        self.use_covalent = use_covalent
        self.embedding = nn.Embedding(100, hidden_channels)
        self.blocks = nn.ModuleList(
            InteractionBlock(hidden_channels, num_filters, cutoff, num_gaussians, max_neighbors,
                             resolve_compute_dtype(compute_dtype), neighbor_cap_mode)
            for _ in range(num_interactions)
        )
        if use_covalent:
            self.blocks_cov = nn.ModuleList(
                CovalentInteractionBlock(hidden_channels, num_filters, cutoff)
                for _ in range(num_interactions)
            )
        width = 2 * hidden_channels if use_covalent else hidden_channels
        half = hidden_channels // 2
        self.lin1 = nn.Linear(width, half)
        if heads == "dual":
            self.lin2 = nn.Linear(half, half)
            self.lin1_bary = nn.Linear(width, half)
            self.lin2_bary = nn.Linear(half, half)

    def _embed(self, z, mask):
        return embed_onehot(z, self.embedding.weight) * mask[..., None].to(torch.float32)

    def _block(self, blk, *args):
        """``blk(*args)``; with ``remat``, while gradients are recorded,
        recomputed in the backward. Nothing in a block draws random numbers,
        and reading the RNG state would break a graph capture."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(blk, *args, use_reentrant=False, preserve_rng_state=False)
        return blk(*args)

    def neighbor_graph(self, pos, mask):
        """Distances and the capped neighbour mask; also the FGW structure
        graph's source."""
        dist = pairwise_distances(pos)
        nbr = radius_graph_mask(dist, mask, self.cutoff, self.max_neighbors,
                                self.neighbor_cap_mode)
        return dist, nbr

    def trunk(self, z, pos, mask, bond_adj=None, bond_attr=None):
        """Per-node features of the interaction stacks; with ``use_covalent``
        the covalent stack's over ``bond_adj``/``bond_attr`` (one per
        molecule, see ``CovalentInteractionBlock``) are concatenated."""
        h = self._embed(z, mask)
        for blk in self.blocks:
            h = h + self._block(blk, h, pos, mask)
        if not self.use_covalent:
            return h
        if bond_adj is None or bond_attr is None:
            raise ValueError("use_covalent=True requires bond_adj and bond_attr")
        h_cov = self._embed(z, mask)
        for blk in self.blocks_cov:
            h_cov = h_cov + self._block(blk, h_cov, bond_adj, bond_attr)
        return torch.cat([h, h_cov], dim=-1)

    def forward(self, z, pos, mask, bond_adj=None, bond_attr=None):
        """3D branch only (stage 1): per-node features ``(..., N, hidden//2)``."""
        h = self.trunk(z, pos, mask, bond_adj, bond_attr)
        return shifted_softplus(self.lin2(self.lin1(h)))

    def embed_dual(self, z, pos, mask):
        """Both heads off the shared trunk: ``(h_3d, h_bary, nbr_mask)``; the
        neighbour mask doubles as the conformer structure graph for FGW."""
        h = self.trunk(z, pos, mask)
        _, nbr = self.neighbor_graph(pos, mask)
        h3 = shifted_softplus(self.lin2(self.lin1(h)))
        hb = shifted_softplus(self.lin2_bary(self.lin1_bary(h)))
        return h3, hb, nbr

    def embed_simple(self, z, pos, mask):
        """The one-linear head (the JAX module's ``embed_simple``):
        ``(ssp(lin1(h)) (..., N, hidden//2), nbr_mask, rbf * nbr)``, the last
        the radius graph's Gaussian edge features ``(..., N, N, gaussians)``
        for a GAT over it. The blocks run through the cfconv kernels, which
        compute the radius graph, RBF and envelope of the JAX function's
        XLA formulation."""
        h = shifted_softplus(self.lin1(self.trunk(z, pos, mask)))
        dist, nbr = self.neighbor_graph(pos, mask)
        rbf = gaussian_smearing(dist, self.num_gaussians, 0.0, self.cutoff)
        return h, nbr, rbf * nbr[..., None].to(rbf.dtype)
