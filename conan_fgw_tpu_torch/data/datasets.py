"""CSV-driven conformer datasets (the port's own copy of
``conan_fgw_tpu/data/datasets.py``).

Layout matches the reference (``conan_fgw/src/data/datasets.py:107-220``):
``{data_dir}/{dataset}/{mode}.csv`` with columns ``smiles``, target,
``mol_id``; per-molecule conformer stores under
``{data_dir}/{dataset}/conformers_{mode}/``. Featurisation resamples exactly
K conformers per access (so each epoch sees a fresh conformer subset when the
store holds more than K, like the reference's per-``get`` random sampling).
"""

from __future__ import annotations

import csv
import os
import zlib
from typing import Sequence

import numpy as np

from conan_fgw_tpu_torch.data import conformers as conf_lib
from conan_fgw_tpu_torch.data import smiles as smi
from conan_fgw_tpu_torch.data.packing import MoleculeRecord


def resample_rng(seed: int, epoch: int, mol_id: str, trial: int = 0) -> np.random.Generator:
    """Deterministic per-(seed, epoch, molecule) generator for K-subset
    conformer resampling. The reference resamples via the global ``random``
    module (``generators.py:25-34``); here the draw is reproducible, so a
    resumed run redraws any epoch's subsets and the JAX package draws the
    same ones."""
    return np.random.default_rng([seed, epoch, zlib.crc32(mol_id.encode()), trial])


def draw_k_subset(rng: np.random.Generator, available: int, k: int) -> np.ndarray:
    """K indices from ``available`` stores: with replacement when k > available
    (the reference's ``random.choices``), without otherwise (``random.sample``)."""
    return rng.choice(available, size=k, replace=k > available)


def read_csv_rows(path: str, target: str):
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        rows = []
        for row in reader:
            if not row.get("smiles"):
                continue
            rows.append(
                {
                    "smiles": row["smiles"].strip(),
                    "y": float(row[target]),
                    "mol_id": str(row.get("mol_id", row["smiles"])).strip(),
                }
            )
    return rows


class ConformerDataset:
    """Random-access dataset yielding ``MoleculeRecord``s with K conformers."""

    def __init__(
        self,
        mode: str,
        data_dir: str,
        dataset_name: str,
        target: str,
        num_conformers: int,
        *,
        generate_missing: bool = True,
        store_conformers: int | None = None,
        prune_conformers: bool = False,
    ):
        self.mode = mode
        self.num_conformers = num_conformers
        self.dataset_dir = os.path.join(data_dir, dataset_name)
        self.conformers_dir = os.path.join(self.dataset_dir, f"conformers_{mode}")
        self.csv_path = os.path.join(self.dataset_dir, f"{mode}.csv")
        self.rows = read_csv_rows(self.csv_path, target)
        self.generate_missing = generate_missing
        self.store_conformers = store_conformers or num_conformers
        self.prune_conformers = prune_conformers
        self._feature_cache: dict[str, tuple] = {}
        # full conformer stores cached in RAM: per-epoch records() refreshes
        # (K-subset resampling) then cost one np indexing per molecule, not a
        # disk read
        self._store_cache: dict[str, np.ndarray] = {}
        self._epoch = 0
        os.makedirs(self.conformers_dir, exist_ok=True)

    def set_epoch(self, epoch: int) -> None:
        """Advance the resampling epoch: the next ``records()`` draws a fresh
        (but deterministic) K-subset per molecule."""
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.rows)

    def _features(self, smiles: str):
        if smiles not in self._feature_cache:
            mol = smi.add_hydrogens(smi.parse_smiles(smiles))
            self._feature_cache[smiles] = smi.featurize(mol)
        return self._feature_cache[smiles]

    def _positions(self, row) -> np.ndarray:
        if row["mol_id"] in self._store_cache:
            return self._store_cache[row["mol_id"]]
        path = conf_lib.store_path(self.conformers_dir, row["mol_id"])
        if not os.path.exists(path):
            if not self.generate_missing:
                raise FileNotFoundError(path)
            conf_lib._generate_one(
                row["smiles"], path, self.store_conformers, self.prune_conformers, seed=1
            )
        positions = conf_lib.load_store(self.conformers_dir, row["mol_id"])
        self._store_cache[row["mol_id"]] = positions
        return positions

    def __getitem__(self, idx: int) -> MoleculeRecord:
        row = self.rows[idx]
        x2d, bonds, battr, z = self._features(row["smiles"])
        positions = self._positions(row)
        k = self.num_conformers
        if positions.shape[0] != k:
            # the JAX package's draw: seed 1, keyed on the epoch and molecule
            rng = resample_rng(1, self._epoch, row["mol_id"])
            positions = positions[draw_k_subset(rng, positions.shape[0], k)]
        n = z.shape[0]
        if positions.shape[1] != n:
            raise ValueError(
                f"conformer store for {row['mol_id']} has {positions.shape[1]} atoms, "
                f"featuriser produced {n} — regenerate the store"
            )
        return MoleculeRecord(
            z=z, pos=positions.astype(np.float32), x2d=x2d, bonds=bonds,
            bond_attr=battr, y=row["y"], smiles=row["smiles"], mol_id=row["mol_id"],
        )

    def records(self) -> list[MoleculeRecord]:
        return [self[i] for i in range(len(self))]


class NTrialsConformerDataset(ConformerDataset):
    """Per-item repeated conformer resamplings for variance studies
    (``LargeConformerBasedDatasetNTrials``, datasets.py:263-285): each access
    returns ``n_trials`` independently resampled K-subsets."""

    def __init__(self, *args, n_trials: int = 10, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_trials = n_trials

    def __getitem__(self, idx: int) -> list[MoleculeRecord]:
        row = self.rows[idx]
        x2d, bonds, battr, z = self._features(row["smiles"])
        positions = self._positions(row)
        out = []
        for trial in range(self.n_trials):
            # the JAX package's draw: seed 1, keyed on the epoch, molecule and trial
            rng = resample_rng(1, self._epoch, row["mol_id"], trial)
            sel = draw_k_subset(rng, positions.shape[0], self.num_conformers)
            out.append(MoleculeRecord(
                z=z, pos=positions[sel].astype(np.float32), x2d=x2d, bonds=bonds,
                bond_attr=battr, y=row["y"], smiles=row["smiles"], mol_id=row["mol_id"],
            ))
        return out


class BDEDataset(ConformerDataset):
    """Bond-dissociation-energy dataset (``BDEDataset``, reference
    ``datasets.py:223-260``).

    Reference semantics kept: conformer stores must pre-exist (the reference
    raises when ``{mol_id}.pkl`` is absent: BDE geometries come from an
    external pipeline, not SMILES embedding), and the molecule identity used
    for featurisation is taken from the *store* (``Chem.MolToSmiles(mol)``)
    rather than the CSV column when the store recorded one. The reference
    class is unrunnable upstream (its ``MolGraphFeaturizerBDE`` is defined
    nowhere); the standard 3D featuriser stands in, as in the JAX package.
    """

    def __init__(self, *args, **kwargs):
        kwargs.setdefault("generate_missing", False)
        super().__init__(*args, **kwargs)

    def _store_smiles(self, mol_id: str) -> str | None:
        path = conf_lib.store_path(self.conformers_dir, mol_id)
        if not os.path.exists(path):
            raise ValueError(f"Conformers for molecule {mol_id} not found")
        with np.load(path, allow_pickle=False) as z:
            if "smiles" in z.files:
                return str(z["smiles"])
        return None

    def __getitem__(self, idx: int) -> MoleculeRecord:
        row = self.rows[idx]
        stored = self._store_smiles(row["mol_id"])
        if stored:
            self.rows[idx] = dict(row, smiles=stored)
        return super().__getitem__(idx)


class SmilesDataset:
    """2D-only dataset (``SmilesBasedDataset``, datasets.py:67-83): featurises
    the covalent graph without conformers (K=1, zero positions, no
    hydrogens)."""

    def __init__(self, mode: str, data_dir: str, dataset_name: str, target: str):
        self.csv_path = os.path.join(data_dir, dataset_name, f"{mode}.csv")
        self.rows = read_csv_rows(self.csv_path, target)
        self._cache: dict[str, tuple] = {}

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int) -> MoleculeRecord:
        row = self.rows[idx]
        if row["smiles"] not in self._cache:
            self._cache[row["smiles"]] = smi.featurize(smi.parse_smiles(row["smiles"]))
        x2d, bonds, battr, z = self._cache[row["smiles"]]
        return MoleculeRecord(
            z=z, pos=np.zeros((1, z.shape[0], 3), np.float32), x2d=x2d, bonds=bonds,
            bond_attr=battr, y=row["y"], smiles=row["smiles"], mol_id=row["mol_id"],
        )

    def records(self) -> list[MoleculeRecord]:
        return [self[i] for i in range(len(self))]


def class_weight_ratio(rows: Sequence[dict]) -> float:
    """``balanced`` class-weight ratio cw[1]/cw[0] = n0/n1 — the scalar the
    reference passes as the BCE ``weight`` (``train_val.py:56-62``)."""
    y = np.asarray([r["y"] for r in rows])
    n1 = max(int((y == 1).sum()), 1)
    n0 = max(int((y == 0).sum()), 1)
    return n0 / n1


def write_csv(path: str, rows: Sequence[dict], target: str = "target"):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["smiles", target, "mol_id"])
        for r in rows:
            w.writerow([r["smiles"], r["y"], r["mol_id"]])
