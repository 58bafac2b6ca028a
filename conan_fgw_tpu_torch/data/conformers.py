"""Conformer stores: offline generation, loading, and generation for
molecules without one (the port's own copy of
``conan_fgw_tpu/data/conformers.py``).

The reference generates conformers offline with RDKit ETKDG
(``conan_fgw/src/data/conformers/generators.py:119-130``). Here:

* When RDKit is installed, ``rdkit_generate`` reproduces that path exactly
  (``EmbedMultipleConfs`` with optional ``pruneRmsThresh=0.5``).
* Otherwise ``dg_generate`` provides a built-in distance-geometry embedder:
  bond lengths from covalent radii, 1-3 distances from ideal hybridisation
  angles, soft non-bonded repulsion, randomized initialisation per conformer
  (the ETKDG role of torsional sampling). Plain numpy, so it gives the JAX
  package's positions bit for bit.

Stores are ``.npz`` files per molecule (``positions (C, n, 3)``), resampled
to exactly K conformers at featurise time (``data/datasets.py``).
"""

from __future__ import annotations

import multiprocessing
import os
import random
import re
from concurrent.futures import ProcessPoolExecutor, as_completed

import numpy as np

from conan_fgw_tpu_torch.data import smiles as smi
from conan_fgw_tpu_torch.data.vocab import HYBRIDIZATION

try:  # pragma: no cover - exercised only when rdkit is installed
    from rdkit import Chem  # type: ignore
    from rdkit.Chem import AllChem  # type: ignore

    HAVE_RDKIT = True
except Exception:  # pragma: no cover
    HAVE_RDKIT = False

_RCOV = {1: 0.31, 5: 0.84, 6: 0.76, 7: 0.71, 8: 0.66, 9: 0.57, 14: 1.11,
         15: 1.07, 16: 1.05, 17: 1.02, 34: 1.2, 35: 1.2, 53: 1.39}
_ORDER_SCALE = {1.0: 1.0, 1.5: 0.93, 2.0: 0.87, 3.0: 0.81, 4.0: 0.78}
_ANGLE = {"SP": np.pi, "SP2": 2 * np.pi / 3, "SP3": np.deg2rad(109.47)}


def _bond_length(zi: int, zj: int, order: float) -> float:
    return (_RCOV.get(zi, 1.0) + _RCOV.get(zj, 1.0)) * _ORDER_SCALE.get(order, 1.0)


def _constraints(mol: smi.Molecule):
    """(pairs, targets, weights) distance constraints for the embedder."""
    n = mol.num_atoms
    pairs, targets, weights = [], [], []
    blen = {}
    for b in mol.bonds:
        l = _bond_length(mol.atoms[b.i].z, mol.atoms[b.j].z, b.order)
        blen[(b.i, b.j)] = blen[(b.j, b.i)] = l
        pairs.append((b.i, b.j))
        targets.append(l)
        weights.append(4.0)
    # 1-3 constraints from ideal angles at the central atom
    for c in range(n):
        nbrs = [j for j, _ in mol.neighbors(c)]
        hyb = HYBRIDIZATION[smi._hybridization(mol, c)]
        theta = _ANGLE.get(hyb, _ANGLE["SP3"])
        for a in range(len(nbrs)):
            for b2 in range(a + 1, len(nbrs)):
                i, j = nbrs[a], nbrs[b2]
                la, lb = blen[(c, i)], blen[(c, j)]
                d13 = np.sqrt(la * la + lb * lb - 2 * la * lb * np.cos(theta))
                pairs.append((i, j))
                targets.append(float(d13))
                weights.append(1.0)
    return (
        np.asarray(pairs, np.int32).reshape(-1, 2),
        np.asarray(targets, np.float32),
        np.asarray(weights, np.float32),
    )


def _embed_once(
    n: int, pairs: np.ndarray, targets: np.ndarray, weights: np.ndarray,
    rng: np.random.Generator, iters: int = 300,
) -> np.ndarray:
    """SMACOF-style stress majorisation: monotone, step-size-free updates.

    X_i ← (1/W_i) Σ_j w_ij [ X_j + t_ij (X_i − X_j)/d_ij ] over the constraint
    pairs, with lower-bound repulsion pairs (non-bonded atoms closer than
    1.8 Å) refreshed periodically.
    """
    pos = rng.standard_normal((n, 3)).astype(np.float64) * max(1.5, 0.4 * n ** 0.5)
    base_ii, base_jj = pairs[:, 0], pairs[:, 1]
    constrained = set(map(tuple, np.sort(pairs, axis=1).tolist()))
    rep_ii = rep_jj = np.zeros((0,), np.int64)
    for it in range(iters):
        if it % 20 == 0 and n > 2:
            diff = pos[:, None, :] - pos[None, :, :]
            dd = np.linalg.norm(diff, axis=-1)
            iu, ju = np.triu_indices(n, k=1)
            close = dd[iu, ju] < 1.8
            keep = [
                k for k in np.nonzero(close)[0]
                if (min(iu[k], ju[k]), max(iu[k], ju[k])) not in constrained
            ]
            rep_ii, rep_jj = iu[keep], ju[keep]
        ii = np.concatenate([base_ii, rep_ii])
        jj = np.concatenate([base_jj, rep_jj])
        tt = np.concatenate([targets, np.full(rep_ii.shape, 1.8, np.float32)])
        ww = np.concatenate([weights, np.full(rep_ii.shape, 0.5, np.float32)])
        d = pos[ii] - pos[jj]
        dist = np.linalg.norm(d, axis=1) + 1e-9
        unit = d / dist[:, None]
        # Guttman transform contributions in both directions
        contrib = np.zeros_like(pos)
        wsum = np.zeros((n, 1))
        np.add.at(contrib, ii, ww[:, None] * (pos[jj] + tt[:, None] * unit))
        np.add.at(contrib, jj, ww[:, None] * (pos[ii] - tt[:, None] * unit))
        np.add.at(wsum, ii, ww[:, None])
        np.add.at(wsum, jj, ww[:, None])
        pos = np.where(wsum > 0, contrib / np.maximum(wsum, 1e-9), pos)
    return (pos - pos.mean(axis=0)).astype(np.float32)


def dg_generate(mol: smi.Molecule, num_conformers: int, seed: int = 1) -> np.ndarray:
    """K conformers ``(K, n, 3)`` via randomized distance-geometry embeddings."""
    pairs, targets, weights = _constraints(mol)
    rng = np.random.default_rng(seed)
    return np.stack([
        _embed_once(mol.num_atoms, pairs, targets, weights, rng)
        for _ in range(num_conformers)
    ])


def rdkit_generate(smiles: str, num_conformers: int, prune: bool = False):
    """RDKit ETKDG path, mirroring ``generators.py:119-130``. Requires rdkit."""
    if not HAVE_RDKIT:
        raise RuntimeError("rdkit is not installed; use dg_generate")
    molecule = Chem.MolFromSmiles(smiles)
    molecule = Chem.AddHs(molecule)
    if prune:
        AllChem.EmbedMultipleConfs(molecule, numConfs=num_conformers, pruneRmsThresh=0.5)
    else:
        AllChem.EmbedMultipleConfs(molecule, numConfs=num_conformers)
    confs = molecule.GetConformers()
    return np.stack([c.GetPositions() for c in confs]).astype(np.float32)


def kabsch_rmsd(a: np.ndarray, b: np.ndarray) -> float:
    """RMSD after optimal rigid superposition (Kabsch) — the RDKit-free analog
    of ``rdMolAlign.GetBestRMS`` used for diversity selection
    (``features.py:128-146``; no atom-permutation search)."""
    a = a - a.mean(0)
    b = b - b.mean(0)
    h = a.T @ b
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(u @ vt))
    r = u @ np.diag([1.0, 1.0, d]) @ vt
    return float(np.sqrt(np.mean(np.sum((a @ r - b) ** 2, axis=1))))


def pairwise_rmsd(positions: np.ndarray) -> np.ndarray:
    c = positions.shape[0]
    out = np.zeros((c, c))
    for i in range(c):
        for j in range(i + 1, c):
            out[i, j] = out[j, i] = kabsch_rmsd(positions[i], positions[j])
    return out


def select_diverse(positions: np.ndarray, k: int, seed: int = 0) -> list[int]:
    """Max-min greedy diversity selection (``features.py:148-163``)."""
    c = positions.shape[0]
    d = pairwise_rmsd(positions)
    rng = np.random.default_rng(seed)
    chosen = {int(rng.integers(c))}
    while len(chosen) < min(k, c):
        rest = [i for i in range(c) if i not in chosen]
        nxt = max(rest, key=lambda i: min(d[i, j] for j in chosen))
        chosen.add(nxt)
    return sorted(chosen)


def select_diverse_kmedoids(positions: np.ndarray, k: int, iters: int = 20) -> list[int]:
    """K-medoids over the RMSD matrix (``features.py:101-120``'s KMedoids)."""
    c = positions.shape[0]
    d = pairwise_rmsd(positions)
    medoids = list(np.random.default_rng(42).choice(c, size=min(k, c), replace=False))
    for _ in range(iters):
        assign = np.argmin(d[:, medoids], axis=1)
        new = []
        for m in range(len(medoids)):
            members = np.nonzero(assign == m)[0]
            if len(members) == 0:
                new.append(medoids[m])
                continue
            costs = d[np.ix_(members, members)].sum(axis=1)
            new.append(int(members[np.argmin(costs)]))
        if new == medoids:
            break
        medoids = new
    return sorted(medoids)


def resample_indices(available: int, k: int, seed: int = 1) -> list[int]:
    """Exactly the reference's K-resampling (``generators.py:25-34``)."""
    idx = list(range(available))
    if available == 0:
        raise ValueError("no conformers")
    random.seed(seed)
    if k > available:
        return random.choices(idx, k=k)
    if k < available:
        return random.sample(idx, k=k)
    return idx


def store_path(conformers_dir: str, mol_id: str) -> str:
    safe = re.sub(r"[!@#$%^&*(){};:,./<>?|`~=_+]", "_", str(mol_id).strip())
    return os.path.join(conformers_dir, f"{safe}.npz")


def generate_store(
    smiles_list, mol_ids, conformers_dir: str, num_conformers: int,
    prune: bool = False, max_workers: int | None = None, seed: int = 1,
):
    """Write one store a molecule into ``conformers_dir``, in a pool of
    ``max_workers`` spawned processes (the reference's
    ``RDKitConformersGenerator.generate`` fan-out). A molecule whose store
    exists is skipped; returns the ``(mol_id, repr(error))`` of each
    molecule that failed, the others' stores written."""
    os.makedirs(conformers_dir, exist_ok=True)
    failed = []
    jobs = {}
    spawn = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=max_workers, mp_context=spawn) as ex:
        for s, mid in zip(smiles_list, mol_ids):
            path = store_path(conformers_dir, mid)
            if os.path.exists(path):
                continue
            jobs[ex.submit(_generate_one, s, path, num_conformers, prune, seed)] = mid
        for fut in as_completed(jobs):
            try:
                fut.result()
            except Exception as e:  # noqa: BLE001 - a molecule's failure is reported, not raised
                failed.append((jobs[fut], repr(e)))
    return failed


def _generate_one(smiles: str, path: str, num_conformers: int, prune: bool, seed: int):
    """Write the store of one molecule: RDKit's conformers where RDKit is
    installed, else ``dg_generate``'s."""
    if HAVE_RDKIT:
        positions = rdkit_generate(smiles, num_conformers, prune)
    else:
        mol = smi.add_hydrogens(smi.parse_smiles(smiles))
        positions = dg_generate(mol, num_conformers, seed=seed)
    np.savez_compressed(path, positions=positions, smiles=np.str_(smiles))
    return path


def load_store(conformers_dir: str, mol_id: str) -> np.ndarray:
    path = store_path(conformers_dir, mol_id)
    if not os.path.exists(path):
        raise FileNotFoundError(f"conformers for molecule {mol_id} not found at {path}")
    with np.load(path, allow_pickle=False) as z:
        return z["positions"]
