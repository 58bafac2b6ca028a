"""Fused Gromov-Wasserstein solver: Sinkhorn (``sinkhorn``), PGD couplings
(``coupling``) and batched barycenters (``barycenter``)."""
