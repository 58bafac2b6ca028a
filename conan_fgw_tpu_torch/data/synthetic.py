"""Synthetic molecule generator — deterministic test/bench data without RDKit.

The port's own copy of ``conan_fgw_tpu/data/synthetic.py``: the same seed gives
bit-identical records.

Produces chemically-plausible ``MoleculeRecord``s: random trees with optional
rings over C/N/O/F heavy atoms, hydrogens to fill valence, 3D coordinates
from a spring-relaxed embedding, and K conformers obtained by jittering the
base geometry. Used by the tests and by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np

import torch

from conan_fgw_tpu_torch.data import vocab
from conan_fgw_tpu_torch.data.packing import MoleculeRecord
from conan_fgw_tpu_torch.device import resolve_device

_HEAVY = [(6, 4), (7, 3), (8, 2), (9, 1)]  # (Z, valence)


def _embed_3d(n_atoms: int, bonds: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Cheap distance-geometry: random init + spring relaxation to ~1.5 Å bonds."""
    pos = rng.standard_normal((n_atoms, 3)) * 2.0
    for _ in range(60):
        grad = np.zeros_like(pos)
        for i, j in bonds:
            d = pos[i] - pos[j]
            dist = np.linalg.norm(d) + 1e-9
            f = (dist - 1.5) * d / dist
            grad[i] -= f
            grad[j] += f
        # weak repulsion to avoid collapse
        diff = pos[:, None, :] - pos[None, :, :]
        dist = np.linalg.norm(diff, axis=-1) + 1e-9
        rep = np.where(dist < 1.2, (1.2 - dist) / dist, 0.0)[..., None] * diff
        grad += rep.sum(axis=1) * 0.5
        pos += 0.3 * grad
    return pos.astype(np.float32)


def random_molecule(
    rng: np.random.Generator, num_heavy: int = 8, num_conformers: int = 3
) -> MoleculeRecord:
    """One random molecule with hydrogens and K jittered conformers; the
    target is a smooth function of composition and geometry."""
    kinds = rng.integers(0, len(_HEAVY), size=num_heavy)
    z = [int(_HEAVY[k][0]) for k in kinds]
    cap = [int(_HEAVY[k][1]) for k in kinds]
    bonds: list[tuple[int, int]] = []
    deg = [0] * num_heavy
    for i in range(1, num_heavy):
        choices = [j for j in range(i) if deg[j] < cap[j]]
        j = int(rng.choice(choices)) if choices else int(rng.integers(0, i))
        bonds.append((j, i))
        deg[i] += 1
        deg[j] += 1
    # occasionally close a ring
    if num_heavy >= 5 and rng.random() < 0.5:
        i, j = sorted(rng.choice(num_heavy, size=2, replace=False).tolist())
        if (i, j) not in bonds and deg[i] < cap[i] and deg[j] < cap[j]:
            bonds.append((i, j))
            deg[i] += 1
            deg[j] += 1

    nh = [cap[i] - deg[i] for i in range(num_heavy)]
    for i in range(num_heavy):
        for _ in range(nh[i]):
            h = len(z)
            z.append(1)
            cap.append(1)
            deg.append(1)
            bonds.append((i, h))
            deg[i] += 1

    n = len(z)
    bonds_arr = np.asarray(bonds, np.int32).reshape(-1, 2)
    base = _embed_3d(n, bonds_arr, rng)
    pos = np.stack(
        [
            base + rng.standard_normal(base.shape).astype(np.float32) * 0.15
            for _ in range(num_conformers)
        ]
    )

    heavy_deg = np.asarray(deg, np.int32)
    x2d = np.asarray(
        [
            vocab.atom_features(
                z[i],
                degree=int(heavy_deg[i]),
                num_hs=sum(1 for (a, b) in bonds if (a == i and z[b] == 1) or (b == i and z[a] == 1)),
                hybridization=4 if z[i] != 1 else 0,  # SP3 | UNSPECIFIED
            )
            for i in range(n)
        ],
        np.int32,
    )
    battr = np.asarray(
        [vocab.bond_features(vocab.BOND_SINGLE) for _ in bonds], np.float32
    ).reshape(-1, 3)

    # smooth, learnable synthetic property: composition + mean pair distance
    y = float(
        0.1 * sum(z) / n
        + 0.5 * np.tanh(np.mean(np.linalg.norm(base - base.mean(0), axis=1)))
        + 0.05 * len(bonds)
    )

    return MoleculeRecord(
        z=np.asarray(z, np.int32),
        pos=pos,
        x2d=x2d,
        bonds=bonds_arr,
        bond_attr=battr,
        y=y,
        smiles=f"synthetic-{n}",
        mol_id=f"syn{rng.integers(1 << 30)}",
    )


def random_dataset(
    seed: int,
    size: int,
    num_conformers: int = 3,
    heavy_range: tuple[int, int] = (4, 10),
    device: str | torch.device = "cuda",
) -> list[MoleculeRecord]:
    """``size`` random molecules from ``seed``. The records stay on the host;
    ``device`` names where they will be trained and is checked up front, so a
    run meant for the card fails here when there is none."""
    resolve_device(device)
    rng = np.random.default_rng(seed)
    records = []
    for _ in range(size):
        nh = int(rng.integers(heavy_range[0], heavy_range[1] + 1))
        records.append(random_molecule(rng, num_heavy=nh, num_conformers=num_conformers))
    return records
