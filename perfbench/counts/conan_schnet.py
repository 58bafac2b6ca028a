"""Operations and bytes of the ConAN SchNet stage-2 training step, for the
configurations whose ``counts`` is ``conan_schnet``.

Everything is counted on real atoms and on the capped radius edges of each
conformer graph, never on the padding, and a product of an ``a x b`` by a
``b x c`` matrix is ``2 a b c`` operations.

- ``step_flops``: what one train step needs, forward and backward, without
  recomputation: every dense layer (backward twice the forward, once for
  the first layer of the filter MLP and of the GAT, whose inputs need no
  gradient), the messages, the FGW barycenter's solves and updates
  (forward only: the couplings take no gradient) with its last feature
  update again with gradient, and the softplus, RBF and softmax element
  work. Adam and the clip are left out (about 13 operations a weight).
- ``cfconv_least_s``: K1 and K2's least time in a step, ``chip_smoke.py``'s
  count (``check_cfconv``) copied: the filter MLP's products on the tensor
  cores (forward ``2 E (G F + F F)``, backward ``E (4 G F + 6 F F)``) and
  ``2 E F`` / ``4 E F`` more; its bytes (positions and mask, ``x`` and
  ``out``, the cotangent and ``dx``, the weights) on real rows only, where
  the copy counted the padded ``G N F``.
- ``fgw_least_s``: K3's least time in a step, ``chip_smoke.py``'s
  ``fgw_bound`` copied with each solve's real ``n`` in place of the padded
  ``N``, and the Sinkhorn sweeps counted at the budget (every PGD step runs
  all its Sinkhorn iterations) where the copy took the kernel's own count.
  A solve of a batch-padding molecule (n = 0) counts nothing. In the
  configurations' padding mode the padded rows carry mass, so the kernel
  solves the padded ``N``: this count is a lower bound of that work.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench.peaks import bound
from perfbench.references.conan_schnet import neighbours, pad_batch

ELEMENTWISE_RBF = 4   # (d - mu)^2 scaled, exp: per edge and Gaussian
ELEMENTWISE_SSP = 4   # softplus and shift, per element
GW_STEP, SINKHORN_SWEEP = 15, 10  # fgw_bound's operations per element


def edges(mols, cfg: dict, device) -> list[np.ndarray]:
    """Each molecule's capped radius edges, one count per conformer."""
    m = cfg["model"]
    out = [None] * len(mols)
    by_size: dict[int, list[int]] = {}
    for i, mol in enumerate(mols):
        by_size.setdefault(mol.n, []).append(i)
    for n, idx in by_size.items():
        _, _, pos32, valid = pad_batch([mols[i] for i in idx], n, device, torch.float32)
        B, K = pos32.shape[:2]
        v = valid[:, None].expand(B, K, n).reshape(B * K, n)
        nbr = neighbours(pos32.reshape(B * K, n, 3), v, m["cutoff"], m["max_neighbors"])
        counts = nbr.sum((1, 2)).reshape(B, K).cpu().numpy()
        for j, i in enumerate(idx):
            out[i] = counts[j]
    return out


def _widths(cfg):
    m = cfg["model"]
    H, F, G, L = m["hidden_channels"], m["num_filters"], m["num_gaussians"], m["num_interactions"]
    return H, F, G, L, H // 2


def step_flops(batch, cfg: dict) -> float:
    """Forward and backward operations of one train step on ``batch`` (``[(n
    atoms, bonds, conformer edge counts), ...]`` of its real molecules)."""
    H, F, G, L, C = _widths(cfg)
    fgw = cfg["fgw"]
    total = 0.0
    for n, bonds, E in batch:
        K = len(E)
        E = float(np.sum(E))  # over the molecule's conformers
        atoms = K * n
        fwd_dense = L * (2 * atoms * H * F + 2 * atoms * F * H + 2 * atoms * H * H)
        fwd_dense += 2 * (2 * atoms * H * C + 2 * atoms * C * C)   # the two heads
        filt_l1 = L * 2 * E * G * F
        filt_l2 = L * 2 * E * F * F
        messages = L * 3 * E * F
        elem = L * (E * G * ELEMENTWISE_RBF + E * F * ELEMENTWISE_SSP + atoms * H * ELEMENTWISE_SSP)
        total += 3 * (fwd_dense + filt_l2 + messages) + 2 * filt_l1 + 2 * elem
        # the GAT: 2 layers over n atoms and 2 * bonds + n directed edges
        e2 = 2 * bonds + n
        gat_l1, gat_l2 = 2 * n * 9 * C, 2 * n * C * C
        gat_rest = 2 * (2 * e2 * 3 * C + 6 * e2 + 2 * e2 * C)
        total += 2 * gat_l1 + 3 * gat_l2 + 3 * gat_rest
        # the barycenter: K solves an outer iteration, each PGD step two
        # n^3 products and the Sinkhorn budget; then Y = T Ys, C = T Cs T^T
        # and M for each conformer
        solve = fgw["pgd_iters"] * (4 * n ** 3 + GW_STEP * n * n
                                    + fgw["sinkhorn_iters"] * SINKHORN_SWEEP * n * n)
        update = 2 * n * n * C + 4 * n ** 3 + 2 * n * n * C
        total += fgw["outer_iters"] * K * (solve + update) + 3 * K * 2 * n * n * C
    B = len(batch)
    total += 3 * B * (3 * 2 * C * C)  # t3d, tcov, tbary
    return total


def cfconv_least_s(batch, cfg: dict, dtype_bytes: int = 4) -> float:
    """K1 and K2's least seconds in one train step (``num_interactions`` of
    each) on ``batch`` (as ``step_flops``)."""
    H, F, G, L, C = _widths(cfg)
    rows = sum(len(E) * n for n, _, E in batch)
    E = float(sum(np.sum(E) for _, _, E in batch))
    w_bytes = 4 * (G * F + F * F + 2 * F)
    io_fwd = 4 * (rows * 3 + rows) + dtype_bytes * 2 * rows * F + w_bytes
    io_bwd = 4 * (rows * 3 + rows) + dtype_bytes * 3 * rows * F + 2 * w_bytes
    mlp_fwd, mlp_bwd = E * 2 * (G * F + F * F), E * (4 * G * F + 6 * F * F)
    fwd, _ = bound(io_fwd, mlp_fwd + E * 2 * F, mlp_fwd)
    bwd, _ = bound(io_bwd, mlp_bwd + E * 4 * F, mlp_bwd)
    return L * (fwd + bwd)


def fgw_least_s(batch, cfg: dict) -> float:
    """K3's least seconds in one train step: ``outer_iters`` launches, each
    of the batch's ``B K`` solves at its real atom count."""
    fgw = cfg["fgw"]
    products = flops = nbytes = 0.0
    for n, _, E in batch:
        S = len(E)
        products += S * fgw["pgd_iters"] * 4 * n ** 3
        flops += (S * fgw["pgd_iters"] * (4 * n ** 3 + GW_STEP * n * n)
                  + S * fgw["pgd_iters"] * fgw["sinkhorn_iters"] * SINKHORN_SWEEP * n * n)
        nbytes += 4 * (5 * S * n * n + 2 * S * n) + 2 * 4 * S
    return fgw["outer_iters"] * bound(nbytes, flops, products)[0]
