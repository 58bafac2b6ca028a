"""Dataset splitters: Bemis-Murcko scaffold split + random split (the
port's own copy of ``conan_fgw_tpu/data/splitters.py``).

Equivalent of ``conan_fgw/src/data/splitters.py:32-108`` (deepchem-derived):
group molecules by scaffold, sort scaffold sets largest-first, and greedily
fill train/valid/test up to the requested fractions. Scaffolds come from
RDKit's MurckoScaffoldSmiles when available; otherwise from a built-in
approximation (iteratively strip terminal atoms from the parsed graph, then
hash the remaining ring-and-linker framework with a Weisfeiler-Lehman
refinement) — grouping-equivalent for most drug-like molecules, though not
string-identical to RDKit's canonical SMILES.
"""

from __future__ import annotations

import hashlib
from collections import Counter

import numpy as np

try:  # pragma: no cover
    from rdkit.Chem.Scaffolds import MurckoScaffold  # type: ignore

    HAVE_RDKIT = True
except Exception:  # pragma: no cover
    HAVE_RDKIT = False

from conan_fgw_tpu_torch.data import smiles as smi


def generate_scaffold(smiles: str, include_chirality: bool = False) -> str:
    if HAVE_RDKIT:
        return MurckoScaffold.MurckoScaffoldSmiles(
            smiles=smiles, includeChirality=include_chirality
        )
    return _approx_scaffold(smiles)


def _approx_scaffold(smiles: str) -> str:
    """Murcko-ish framework hash: strip terminal atoms, WL-hash the rest."""
    mol = smi.parse_smiles(smiles)
    n = mol.num_atoms
    alive = [True] * n
    adj: list[list[tuple[int, float]]] = [[] for _ in range(n)]
    for b in mol.bonds:
        adj[b.i].append((b.j, b.order))
        adj[b.j].append((b.i, b.order))

    def degree(i):
        return sum(1 for j, _ in adj[i] if alive[j])

    changed = True
    while changed:
        changed = False
        for i in range(n):
            if alive[i] and degree(i) <= 1:
                alive[i] = False
                changed = True
    atoms = [i for i in range(n) if alive[i]]
    if not atoms:
        return ""  # acyclic molecule: empty scaffold, like Murcko
    # WL refinement over the surviving framework
    label = {i: f"{mol.atoms[i].z}|{int(mol.atoms[i].aromatic)}" for i in atoms}
    for _ in range(3):
        new = {}
        for i in atoms:
            neigh = sorted(
                f"{o}:{label[j]}" for j, o in adj[i] if alive[j]
            )
            new[i] = hashlib.sha1((label[i] + ";" + ",".join(neigh)).encode()).hexdigest()[:12]
        label = new
    fingerprint = ",".join(sorted(Counter(label.values()).elements()))
    return hashlib.sha1(fingerprint.encode()).hexdigest()[:16]


class ScaffoldSplitter:
    """Largest-scaffold-first greedy split (reference semantics)."""

    def split(self, smiles_list, frac_train=0.8, frac_valid=0.1, frac_test=0.1):
        np.testing.assert_almost_equal(frac_train + frac_valid + frac_test, 1.0)
        n = len(smiles_list)
        groups: dict[str, list[int]] = {}
        for i, s in enumerate(smiles_list):
            groups.setdefault(generate_scaffold(s, include_chirality=True), []).append(i)
        sets = [
            sorted(v)
            for _, v in sorted(groups.items(), key=lambda kv: (len(kv[1]), kv[1][0]), reverse=True)
        ]
        train_cut, valid_cut = frac_train * n, (frac_train + frac_valid) * n
        train, valid, test = [], [], []
        for s in sets:
            if len(train) + len(s) > train_cut:
                if len(train) + len(valid) + len(s) > valid_cut:
                    test.extend(s)
                else:
                    valid.extend(s)
            else:
                train.extend(s)
        return train, valid, test


class RandomSplitter:
    def split(self, smiles_list, frac_train=0.8, frac_valid=0.1, frac_test=0.1, seed=42):
        n = len(smiles_list)
        idx = np.random.default_rng(seed).permutation(n)
        a, b = int(frac_train * n), int((frac_train + frac_valid) * n)
        return list(idx[:a]), list(idx[a:b]), list(idx[b:])
