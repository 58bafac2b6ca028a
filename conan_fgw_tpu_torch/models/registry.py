"""Backbone factory (the port's counterpart of
``conan_fgw_tpu/models/registry.py``): the names and hyper-parameter presets
of the reference's ``EquivModelsHolder.get_model``
(``conan_fgw/src/model/common.py:469-547``), each built as the port's
module, initialised as the flax module is (``init_like_flax``) from a
generator seeded with ``seed`` and placed on ``device``."""

from __future__ import annotations

import torch

from conan_fgw_tpu_torch.device import resolve_device
from conan_fgw_tpu_torch.models.dimenet import DimeNet3D
from conan_fgw_tpu_torch.models.esan import (
    AverageConformerESAN,
    Geometry2DInducedESAN,
    GeometryInducedESAN,
)
from conan_fgw_tpu_torch.models.gat import GAT2D
from conan_fgw_tpu_torch.models.heads import init_like_flax
from conan_fgw_tpu_torch.models.schnet import SchNet3D
from conan_fgw_tpu_torch.models.visnet import ViSNet3D


def _build(name: str, feat_dim: int, cutoff: float | None) -> torch.nn.Module:
    if name == "simple_schnet":
        return SchNet3D(hidden_channels=128, num_filters=128, num_gaussians=50,
                        num_interactions=6)
    if name == "schnet":
        if cutoff is not None:
            return SchNet3D(hidden_channels=feat_dim, cutoff=cutoff, num_gaussians=10,
                            num_filters=256, num_interactions=3)
        return SchNet3D(hidden_channels=feat_dim, num_interactions=3)
    if name == "schnet_covalent":
        return SchNet3D(use_covalent=True, num_interactions=6)
    if name == "simple_dimenet":
        return DimeNet3D(hidden_channels=3, out_channels=1, num_blocks=1, num_bilinear=1,
                         num_spherical=2, num_radial=1, cutoff=5.0, envelope_exponent=1,
                         num_before_skip=1, num_after_skip=1, num_output_layers=1)
    if name == "dimenet":
        return DimeNet3D(hidden_channels=feat_dim, out_channels=feat_dim // 2, num_blocks=6,
                         num_bilinear=8, num_spherical=2, num_radial=3, cutoff=5.0,
                         envelope_exponent=5, num_before_skip=1, num_after_skip=2,
                         num_output_layers=3)
    if name == "gat":
        return GAT2D(out_channels=feat_dim // 2)
    if name == "visnet":
        return ViSNet3D(hidden_channels=feat_dim)
    if name == "avg_conf_esan":
        return AverageConformerESAN()
    if name == "geometry_induced_esan":
        return GeometryInducedESAN()
    if name == "geometry_2d_induced_esan":
        return Geometry2DInducedESAN()
    raise ValueError(f"unknown model {name!r}")


def get_model(name: str, *, feat_dim: int = 128, cutoff: float | None = None, seed: int = 0,
              device: str | torch.device = "cuda") -> torch.nn.Module:
    """The backbone ``name`` with the reference registry's presets
    (``feat_dim`` its hidden width; ``cutoff`` given, ``schnet`` is the
    classification trunk: 256 filters, 10 Gaussians)."""
    dev = resolve_device(device)
    model = _build(name, feat_dim, cutoff)
    init_like_flax(model, torch.Generator().manual_seed(seed))
    return model.to(dev)
