"""Fusion model: 3D backbone (SchNet, ViSNet or DimeNet) + 2D GAT +
FGW-barycenter branch (port of ``conan_fgw_tpu/models/heads.py``, regression
and classification).

The barycenter stage is a call-time flag (``use_barycenter``), so stage 1 and
stage 2 share one parameter set and the warm start is the same module.
Affine transforms commute with the conformer mean, so ``T(mean_k x_k)``
replaces the reference's per-conformer ``T(x_k)`` + mean; the GAT runs once
per molecule. Classification's stage 1 runs self-attention per conformer
before the mean, so there the transforms run per conformer.
"""

from __future__ import annotations

import torch
from torch import nn

from conan_fgw_tpu_torch.data.vocab import NUM_ATOM_FEATURES, NUM_BOND_FEATURES
from conan_fgw_tpu_torch.device import resolve_device
from conan_fgw_tpu_torch.models.attention import SelfAttention
from conan_fgw_tpu_torch.models.dimenet import DimeNet3D
from conan_fgw_tpu_torch.models.gat import GAT2D
from conan_fgw_tpu_torch.models.schnet import SchNet3D
from conan_fgw_tpu_torch.models.visnet import ViSNet3D
from conan_fgw_tpu_torch.ops.fgw.barycenter import FGWConfig, fgw_barycenter_batch
from conan_fgw_tpu_torch.ops.graph import masked_sum


def _minmax_per_matrix(x: torch.Tensor, a: float, b: float, eps: float = 0.0) -> torch.Tensor:
    """Min-max rescale each matrix ``x[..., :, :]`` into ``[a, b]``: the JAX
    model's ``normalize_minmax`` vmapped over molecules and conformers."""
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    return a + (x - lo) * (b - a) / (hi - lo + eps)


def init_like_flax(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise as the flax model does: xavier-uniform kernels and
    attention vectors, zero biases, N(0, 1) embeddings, LayerNorm scales of
    one. A module with initialisers of its own (a ``flax_init(generator)``
    method: DimeNet, ViSNet's ``Atomref``) draws its parameters itself. All
    draws come from ``generator``, module by module in order."""
    with torch.no_grad():
        _init_module(module, generator)


def _init_module(mod: nn.Module, generator: torch.Generator) -> None:
    own = getattr(mod, "flax_init", None)
    if own is not None:
        own(generator)
        return
    for name, p in mod.named_parameters(recurse=False):
        if isinstance(mod, nn.Embedding):
            nn.init.normal_(p, 0.0, 1.0, generator=generator)
        elif isinstance(mod, nn.LayerNorm) and name == "weight":
            nn.init.ones_(p)
        elif name in ("bias", "filter_b1", "filter_b2"):
            nn.init.zeros_(p)
        else:
            nn.init.xavier_uniform_(p, generator=generator)
    for child in mod.children():
        _init_module(child, generator)


class RegressionHead(nn.Linear):
    """One Linear to a single output (the JAX package's ``RegressionHead``,
    flax's ``Dense_0``); ``weight``/``bias`` as ``nn.Linear``'s."""

    def __init__(self, in_features: int):
        super().__init__(in_features, 1)


class ClassificationHead(nn.Module):
    """Linear -> ReLU -> Linear(channels // 2) -> ReLU -> Linear(1) (the JAX
    package's ``ClassificationHead``; ``lins.0/1/2`` are flax's
    ``Dense_0/1/2``)."""

    def __init__(self, channels: int):
        super().__init__()
        self.lins = nn.ModuleList([nn.Linear(channels, channels),
                                   nn.Linear(channels, channels // 2),
                                   nn.Linear(channels // 2, 1)])

    def forward(self, x):
        x = torch.relu(self.lins[0](x))
        x = torch.relu(self.lins[1](x))
        return self.lins[2](x)


class ConanModel(nn.Module):
    """Conformer aggregation network with an optional FGW-barycenter branch.

    ``forward(batch, use_barycenter)`` returns ``(pred (B, 1), n_div)``:
    ``n_div`` is ``(2,)`` int64, the coupling solves that rolled back a
    Sinkhorn numerical failure and the Sinkhorn iterations of the
    barycenter's solves (0 and 0 without the barycenter branch). ``task``
    "regression" predicts with one Linear; "classification" returns logits
    of a three-layer head, with self-attention per conformer in stage 1.

    ``backbone_name``: "schnet" (``num_filters``, ``num_gaussians`` and
    ``num_interactions`` are its), "visnet" or "dimenet" (its node outputs
    ``hidden_channels // 2`` wide), each at the backbone's default depth.
    ``bary_pad_mode``: "reference" keeps the reference's padding semantics
    (pad rows carry uniform mass with zero adjacency); "masked" excludes
    padding from marginals and normalisation. ``bary_postnorm`` "l2col"
    (ViSNet's wrapper) zeroes a non-finite barycenter and normalises each
    feature column of the barycenter to unit L2 norm before the readout.
    ``compute_dtype`` (a name ``device.py::compute_dtype`` takes) reaches
    the SchNet and DimeNet backbones only, as in the JAX model: ViSNet, the
    heads, the GAT and the FGW solver stay f32. ``neighbor_cap_mode`` and
    ``remat`` reach the SchNet backbone (``models/schnet.py::SchNet3D``);
    the JAX model leaves them at their defaults.
    """

    def __init__(self, task: str = "regression", backbone_name: str = "schnet",
                 hidden_channels: int = 128, num_filters: int = 128,
                 num_gaussians: int = 50, num_interactions: int = 3, cutoff: float = 10.0,
                 max_neighbors: int = 32, agg_weight: float = 0.2,
                 fgw: FGWConfig = FGWConfig(), bary_shift: float = 0.5,
                 bary_norm: tuple[float, float] = (0.1, 2.0),
                 bary_pad_mode: str = "reference", bary_postnorm: str = "none", seed: int = 0,
                 device: str | torch.device = "cuda", compute_dtype: str = "float32",
                 neighbor_cap_mode: str = "index", remat: bool = False):
        super().__init__()
        if bary_pad_mode not in ("reference", "masked"):
            raise ValueError(f"unknown bary_pad_mode {bary_pad_mode!r}")
        if bary_postnorm not in ("none", "l2col"):
            raise ValueError(f"unknown bary_postnorm {bary_postnorm!r}")
        if task not in ("regression", "classification"):
            raise ValueError(f"unknown task {task!r}")
        dev = resolve_device(device)
        half = hidden_channels // 2
        self.task = task
        self.agg_weight = agg_weight
        self.fgw = fgw
        self.bary_shift = bary_shift
        self.bary_norm = bary_norm
        self.bary_pad_mode = bary_pad_mode
        self.bary_postnorm = bary_postnorm
        if backbone_name == "schnet":
            self.backbone = SchNet3D(hidden_channels, num_filters, num_interactions,
                                     num_gaussians, cutoff, max_neighbors,
                                     compute_dtype=compute_dtype,
                                     neighbor_cap_mode=neighbor_cap_mode, remat=remat)
        elif backbone_name == "visnet":
            self.backbone = ViSNet3D(hidden_channels, cutoff=cutoff, max_neighbors=max_neighbors)
        elif backbone_name == "dimenet":
            self.backbone = DimeNet3D(hidden_channels, out_channels=half, cutoff=cutoff,
                                      max_neighbors=max_neighbors, compute_dtype=compute_dtype)
        else:
            raise ValueError(f"unknown backbone {backbone_name!r}")
        self.gat = GAT2D(NUM_ATOM_FEATURES, half, NUM_BOND_FEATURES)
        self.t3d = nn.Linear(half, half)
        self.tcov = nn.Linear(half, half)
        self.tbary = nn.Linear(half, half)
        if task == "classification":
            self.head = ClassificationHead(half)
            self.self_attention = SelfAttention(half)
        else:
            self.head = RegressionHead(half)
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
            ys = _minmax_per_matrix(shifted, a, b, eps=1e-12)
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
        if self.bary_postnorm == "l2col":
            finite = torch.isfinite(y_bary).flatten(-2).all(-1)[:, None, None]
            y_bary = torch.where(finite, y_bary, torch.zeros_like(y_bary))
            y_bary = y_bary / torch.sqrt(torch.sum(y_bary * y_bary, dim=-2, keepdim=True) + 1e-16)
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
            n_div = torch.zeros((2,), dtype=torch.int64, device=posf.device)
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
        if self.task == "classification" and not use_barycenter:
            # attention per conformer before the K-mean, on the fused
            # embedding T3d(x3d_k) + Tcov(x_cov), a sequence of length 1
            xk = self.t3d(x3d) + self.tcov(x_cov)[:, None, :]
            x = self.self_attention(xk[..., None, :])[..., 0, :].mean(1)
        else:
            x = self.t3d(x3d.mean(1)) + self.tcov(x_cov)
            if use_barycenter:
                x = x + self.agg_weight * self.tbary(x_bary)
        return self.head(x), n_div
