"""The auxiliary head families and the ESAN head (port of
``conan_fgw_tpu/models/aux_heads.py``).

The reference model zoo's simpler heads (``ScalarsAggregation``,
``EmbeddingsAggregation``, ``CovalentEmbeddingsAggregation``,
``AttentionEmbeddingsAggregation``, ``EmbeddingsWithGAT``) and a regression
head over an ESAN variant. Each keeps the port's model contract:
``forward(batch, use_barycenter=False)`` returns ``(pred (B, 1), n_div)``,
``n_div`` an int64 zero (no head has a barycenter branch), so each drops into
``train/loop.py`` as ``ConanModel`` does. Each is initialised as the flax
model is (``init_like_flax``) from a generator seeded with ``seed`` and
moved to ``device``. The runner builds them from ``ExperimentSpec.model``
(``train/runner.py::build_aux_model``).
"""

from __future__ import annotations

import torch
from torch import nn

from conan_fgw_tpu_torch.data.vocab import NUM_ATOM_FEATURES, NUM_BOND_FEATURES
from conan_fgw_tpu_torch.device import resolve_device
from conan_fgw_tpu_torch.models import esan as esan_lib
from conan_fgw_tpu_torch.models.gat import GAT2D
from conan_fgw_tpu_torch.models.heads import init_like_flax
from conan_fgw_tpu_torch.models.schnet import SchNet3D
from conan_fgw_tpu_torch.ops.graph import masked_sum


class _Head(nn.Module):
    """What every head shares: the seeded flax-like initialisation, the
    device, and the zero ``n_div``."""

    def _finish(self, seed: int, device) -> None:
        init_like_flax(self, torch.Generator().manual_seed(seed))
        self.to(resolve_device(device))

    @staticmethod
    def _no_div(batch) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int64, device=batch.pos.device)


class ScalarsAggregation(_Head):
    """A per-atom scalar off a plain SchNet (hidden, 128 filters, 50
    Gaussians, 6 interactions), summed per conformer and averaged over the
    conformers (the reference's ``simple_schnet``)."""

    def __init__(self, hidden_channels: int = 128, *, seed: int = 0, device="cuda"):
        super().__init__()
        self.schnet = SchNet3D(hidden_channels, num_interactions=6)
        self.head = nn.Linear(hidden_channels // 2, 1)
        self._finish(seed, device)

    def forward(self, batch, use_barycenter: bool = False):
        zf, posf, maskf, (B, K, N) = esan_lib.flatten(batch)
        e = self.head(self.schnet(zf, posf, maskf))  # per-atom scalar energies
        return masked_sum(e, maskf).reshape(B, K, 1).mean(1), self._no_div(batch)


class EmbeddingsAggregation(_Head):
    """SchNet embeddings (3 interactions), summed per conformer, averaged
    over the conformers, then a Linear."""

    def __init__(self, hidden_channels: int = 128, *, seed: int = 0, device="cuda"):
        super().__init__()
        self.schnet = SchNet3D(hidden_channels, num_interactions=3)
        self.head = nn.Linear(hidden_channels // 2, 1)
        self._finish(seed, device)

    def forward(self, batch, use_barycenter: bool = False):
        zf, posf, maskf, (B, K, N) = esan_lib.flatten(batch)
        x = masked_sum(self.schnet(zf, posf, maskf), maskf).reshape(B, K, -1).mean(1)
        return self.head(x), self._no_div(batch)


class CovalentEmbeddingsAggregation(_Head):
    """SchNet with the parallel covalent interaction stack (6 + 6 blocks;
    the reference's ``schnet_covalent``), a Linear per conformer, then the
    mean over the conformers."""

    def __init__(self, hidden_channels: int = 128, *, seed: int = 0, device="cuda"):
        super().__init__()
        self.schnet = SchNet3D(hidden_channels, num_interactions=6, use_covalent=True)
        self.head = nn.Linear(hidden_channels // 2, 1)
        self._finish(seed, device)

    def forward(self, batch, use_barycenter: bool = False):
        zf, posf, maskf, (B, K, N) = esan_lib.flatten(batch)
        # the bond graph once per molecule: the covalent blocks share it
        # over the molecule's K conformers
        h = self.schnet(zf, posf, maskf, batch.bond_adj, batch.bond_attr)
        x = self.head(masked_sum(h, maskf).reshape(B, K, -1))
        return x.mean(1), self._no_div(batch)


class AttentionEmbeddingsAggregation(_Head):
    """Dot-product attention across the whole flat conformer batch before the
    conformer mean. As in the reference, the softmax runs over all ``B * K``
    conformers of the batch, other molecules' and padding molecules'
    included, so a molecule's prediction depends on its batch."""

    def __init__(self, hidden_channels: int = 128, *, seed: int = 0, device="cuda"):
        super().__init__()
        half = hidden_channels // 2
        self.schnet = SchNet3D(hidden_channels, num_interactions=3)
        self.q, self.k, self.v = (nn.Linear(half, half) for _ in range(3))
        self.head = nn.Linear(half, 1)
        self._finish(seed, device)

    def forward(self, batch, use_barycenter: bool = False):
        zf, posf, maskf, (B, K, N) = esan_lib.flatten(batch)
        x = masked_sum(self.schnet(zf, posf, maskf), maskf)  # (B * K, C)
        sim = torch.softmax(self.q(x) @ self.k(x).T, dim=1)
        x = (sim @ self.v(x)).reshape(B, K, -1).mean(1)
        return self.head(x), self._no_div(batch)


class EmbeddingsWithGAT(_Head):
    """The 2D-only GAT head (the reference's ``GATExperiment``)."""

    def __init__(self, hidden_channels: int = 128, *, seed: int = 0, device="cuda"):
        super().__init__()
        self.gat = GAT2D(NUM_ATOM_FEATURES, hidden_channels // 2, NUM_BOND_FEATURES)
        self.head = nn.Linear(hidden_channels // 2, 1)
        self._finish(seed, device)

    def forward(self, batch, use_barycenter: bool = False):
        x = self.gat(batch.x2d, batch.bond_adj, batch.bond_attr, batch.atom_mask)
        return self.head(x), self._no_div(batch)


class ESANAggregation(_Head):
    """An ESAN variant (``models/esan.py::VARIANTS``) and a Linear."""

    def __init__(self, variant: str = "avg_conf_esan", hidden_channels: int = 128, *,
                 seed: int = 0, device="cuda"):
        super().__init__()
        if variant not in esan_lib.VARIANTS:
            raise ValueError(f"unknown ESAN variant {variant!r}; known: {sorted(esan_lib.VARIANTS)}")
        self.variant = variant
        self.net = esan_lib.VARIANTS[variant](hidden_channels)
        self.head = nn.Linear(hidden_channels // 2, 1)
        self._finish(seed, device)

    def forward(self, batch, use_barycenter: bool = False):
        return self.head(self.net(batch)), self._no_div(batch)


HEADS = {
    "gat_only": EmbeddingsWithGAT,
    "scalars": ScalarsAggregation,
    "embeddings": EmbeddingsAggregation,
    "covalent": CovalentEmbeddingsAggregation,
    "attention": AttentionEmbeddingsAggregation,
}
