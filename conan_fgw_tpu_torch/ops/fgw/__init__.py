"""Fused Gromov-Wasserstein solvers: log-domain Sinkhorn (``sinkhorn``),
PGD/PPA couplings (``coupling``), barycenters per molecule and batched
(``barycenter``), and the alternative OT solvers (``variants``)."""

from conan_fgw_tpu_torch.ops.fgw.barycenter import (
    FGWConfig,
    fgw_barycenter,
    fgw_barycenter_batch,
    normalize_minmax,
)
from conan_fgw_tpu_torch.ops.fgw.coupling import fgw_coupling
from conan_fgw_tpu_torch.ops.fgw.sinkhorn import sinkhorn_log

__all__ = [
    "sinkhorn_log",
    "fgw_coupling",
    "FGWConfig",
    "fgw_barycenter",
    "fgw_barycenter_batch",
    "normalize_minmax",
]
