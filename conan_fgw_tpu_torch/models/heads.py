"""Regression fusion model: 3D SchNet + 2D GAT + FGW-barycenter branch
(port of ``conan_fgw_tpu/models/heads.py``, regression with the SchNet
backbone).

The barycenter stage is a call-time flag (``use_barycenter``), so stage 1 and
stage 2 share one parameter set and the warm start is the same module.
Affine transforms commute with the conformer mean, so ``T(mean_k x_k)``
replaces the reference's per-conformer ``T(x_k)`` + mean; the GAT runs once
per molecule.
"""

from __future__ import annotations

import torch
from torch import nn

from conan_fgw_tpu_torch.data.vocab import NUM_ATOM_FEATURES, NUM_BOND_FEATURES
from conan_fgw_tpu_torch.device import resolve_device
from conan_fgw_tpu_torch.models.gat import GAT2D
from conan_fgw_tpu_torch.models.schnet import SchNet3D
from conan_fgw_tpu_torch.ops.fgw.barycenter import FGWConfig, fgw_barycenter_batch, normalize_minmax
from conan_fgw_tpu_torch.ops.graph import masked_sum


def init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise as the flax model does: xavier-uniform kernels and
    attention vectors, zero biases, N(0, 1) embeddings."""
    with torch.no_grad():
        for mod in module.modules():
            for name, p in mod.named_parameters(recurse=False):
                if isinstance(mod, nn.Embedding):
                    nn.init.normal_(p, 0.0, 1.0, generator=generator)
                elif name in ("bias", "filter_b1", "filter_b2"):
                    nn.init.zeros_(p)
                else:
                    nn.init.xavier_uniform_(p, generator=generator)


class ConanModel(nn.Module):
    """Conformer aggregation network with an optional FGW-barycenter branch.

    ``forward(batch, use_barycenter)`` returns ``(pred (B, 1), n_div)``:
    ``n_div`` counts the coupling solves that rolled back a Sinkhorn
    numerical failure (0 without the barycenter branch).

    ``bary_pad_mode``: "reference" keeps the reference's padding semantics
    (pad rows carry uniform mass with zero adjacency); "masked" excludes
    padding from marginals and normalisation.
    """

    def __init__(self, hidden_channels: int = 128, num_filters: int = 128,
                 num_gaussians: int = 50, num_interactions: int = 3, cutoff: float = 10.0,
                 max_neighbors: int = 32, agg_weight: float = 0.2,
                 fgw: FGWConfig = FGWConfig(), bary_shift: float = 0.5,
                 bary_norm: tuple[float, float] = (0.1, 2.0),
                 bary_pad_mode: str = "reference", seed: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        if bary_pad_mode not in ("reference", "masked"):
            raise ValueError(f"unknown bary_pad_mode {bary_pad_mode!r}")
        dev = resolve_device(device)
        half = hidden_channels // 2
        self.agg_weight = agg_weight
        self.fgw = fgw
        self.bary_shift = bary_shift
        self.bary_norm = bary_norm
        self.bary_pad_mode = bary_pad_mode
        self.backbone = SchNet3D(hidden_channels, num_filters, num_interactions,
                                 num_gaussians, cutoff, max_neighbors)
        self.gat = GAT2D(NUM_ATOM_FEATURES, half, NUM_BOND_FEATURES)
        self.t3d = nn.Linear(half, half)
        self.tcov = nn.Linear(half, half)
        self.tbary = nn.Linear(half, half)
        self.head = nn.Linear(half, 1)
        init_like_flax(self, torch.Generator().manual_seed(seed))
        self.to(dev)

    def _barycenter_readout(self, hb, nbr, atom_mask):
        """Molecule-level barycenter readout ``(B, C)`` and ``n_div``."""
        B, K, N, C = hb.shape
        a, b = self.bary_norm
        shifted = hb + self.bary_shift
        if self.bary_pad_mode == "reference":
            # per-conformer min-max over the full padded matrix, pads included;
            # eps keeps fully padded (batch-filler) molecules NaN-free
            ys = normalize_minmax(shifted, a, b, eps=1e-12)
            ps = p = None
        else:
            node_mask = atom_mask[:, None, :, None]
            inf = torch.full_like(shifted, float("inf"))
            lo = torch.where(node_mask, shifted, inf).amin(dim=(-2, -1), keepdim=True)
            hi = torch.where(node_mask, shifted, -inf).amax(dim=(-2, -1), keepdim=True)
            # where(), not multiply-by-mask: filler molecules have lo=inf, hi=-inf
            ys = torch.where(node_mask, a + (shifted - lo) * (b - a) / (hi - lo + 1e-12),
                             torch.zeros_like(shifted))
            counts = atom_mask.sum(-1, keepdim=True)
            p = atom_mask.to(hb.dtype) / torch.clamp(counts, min=1)
            ps = p[:, None, :].expand(B, K, N)
        # structure graph: dense adjacency of the radius graph, A[j, i] = j -> i
        cs = nbr.transpose(-1, -2).to(hb.dtype).reshape(B, K, N, N)
        y_bary, _, n_div = fgw_barycenter_batch(ys, cs, ps=ps, p=p, config=self.fgw)
        return y_bary.sum(-2), n_div  # sum-readout (pads included, as the reference)

    def _readouts(self, batch, use_barycenter: bool):
        """Per-conformer 3D readouts ``x3d (B, K, C)``, the barycenter
        readout ``x_bary (B, C)`` (None without the branch) and ``n_div``."""
        B, K, N = batch.z.shape
        zf = batch.z.reshape(B * K, N)
        posf = batch.pos.reshape(B * K, N, 3)
        maskf = batch.atom_mask.repeat_interleave(K, dim=0)
        if use_barycenter:
            h3, hb, nbr = self.backbone.embed_dual(zf, posf, maskf)
            hb = hb * maskf[..., None].to(hb.dtype)  # zero pad rows
            x_bary, n_div = self._barycenter_readout(
                hb.reshape(B, K, N, -1), nbr, batch.atom_mask
            )
        else:
            h3 = self.backbone(zf, posf, maskf)
            x_bary = None
            n_div = torch.zeros((), dtype=torch.int64, device=posf.device)
        return masked_sum(h3, maskf).reshape(B, K, -1), x_bary, n_div

    def embeddings(self, batch) -> dict:
        """The branches' embeddings before fusion, for visualisation (the
        reference's ``EmbeddingsVisualizationBaryCenter``,
        ``schnet_based_models.py:372-417``): ``{"x3d": (B, K, C), "x_bary":
        (B, C), "x_cov": (B, C)}``."""
        x3d, x_bary, _ = self._readouts(batch, use_barycenter=True)
        x_cov = self.gat(batch.x2d, batch.bond_adj, batch.bond_attr, batch.atom_mask)
        return {"x3d": x3d, "x_bary": x_bary, "x_cov": x_cov}

    def forward(self, batch, use_barycenter: bool = False):
        x3d, x_bary, n_div = self._readouts(batch, use_barycenter)
        x_cov = self.gat(batch.x2d, batch.bond_adj, batch.bond_attr, batch.atom_mask)
        x = self.t3d(x3d.mean(1)) + self.tcov(x_cov)
        if use_barycenter:
            x = x + self.agg_weight * self.tbary(x_bary)
        return self.head(x), n_div
