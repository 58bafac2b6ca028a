"""GEOM-Drugs-style conformer datasets, the CoV-2 / SARS classification sets
(the port's own copy of ``conan_fgw_tpu/data/geom.py``).

Layout per the reference ``GEOMDataset`` (``conan_fgw/src/data/datasets.py:288-349``):
``{data_dir}/{dataset}/{mode}.csv`` plus ``summary.json`` mapping each SMILES
to a per-molecule pickle of GEOM conformer dicts (``conf["rd_mol"]``).
Reading those pickles requires RDKit; ``convert_geom_store`` turns them into
``.npz`` position stores on an RDKit-enabled host, after which
``GEOMDataset`` runs RDKit-free.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

from conan_fgw_tpu_torch.data import conformers as conf_lib
from conan_fgw_tpu_torch.data import smiles as smi
from conan_fgw_tpu_torch.data.datasets import draw_k_subset, read_csv_rows, resample_rng
from conan_fgw_tpu_torch.data.packing import MoleculeRecord


def load_geom_positions(data_dir: str, pickle_path: str) -> np.ndarray:
    """(C, n, 3) positions from a GEOM per-molecule pickle. Unpickling its
    ``rd_mol`` objects imports RDKit, so this raises where RDKit is absent."""
    with open(os.path.join(data_dir, pickle_path), "rb") as f:
        conf_dic = pickle.load(f)
    return np.stack(
        [
            np.asarray(c["rd_mol"].GetConformers()[0].GetPositions(), np.float32)
            for c in conf_dic["conformers"]
        ]
    )


def convert_geom_store(data_dir: str, dataset_name: str, out_subdir: str = "conformers_npz"):
    """One-time conversion of GEOM pickles to ``.npz`` stores (RDKit host)."""
    ddir = os.path.join(data_dir, dataset_name)
    with open(os.path.join(ddir, "summary.json")) as f:
        summary = json.load(f)
    out = os.path.join(ddir, out_subdir)
    os.makedirs(out, exist_ok=True)
    for smiles, meta in summary.items():
        pos = load_geom_positions(data_dir, meta["pickle_path"])
        key = conf_lib.store_path(out, smiles)
        np.savez_compressed(key, positions=pos, smiles=np.str_(smiles))
    return out


class GEOMDataset:
    """CSV + GEOM conformer stores to ``MoleculeRecord``s.

    Prefers the converted ``.npz`` stores; falls back to the raw GEOM pickles
    (requires RDKit); finally generates conformers with the built-in
    embedder when neither exists (again at every access, as the JAX class
    does).
    """

    def __init__(
        self,
        mode: str,
        data_dir: str,
        dataset_name: str,
        target: str,
        num_conformers: int,
        npz_subdir: str = "conformers_npz",
        resample_seed: int = 1,
    ):
        self.data_dir = data_dir
        self.dataset_dir = os.path.join(data_dir, dataset_name)
        self.csv_path = os.path.join(self.dataset_dir, f"{mode}.csv")
        self.rows = read_csv_rows(self.csv_path, target)
        self.num_conformers = num_conformers
        self.npz_dir = os.path.join(self.dataset_dir, npz_subdir)
        summary_path = os.path.join(self.dataset_dir, "summary.json")
        self.summary = {}
        if os.path.exists(summary_path):
            with open(summary_path) as f:
                self.summary = json.load(f)
        self._feature_cache: dict[str, tuple] = {}
        self.resample_seed = resample_seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Advance the resampling epoch: the next ``records()`` draws a fresh
        (but deterministic) K-subset per molecule (``datasets.resample_rng``)."""
        self._epoch = int(epoch)

    def __len__(self):
        return len(self.rows)

    def _positions(self, smiles: str) -> np.ndarray:
        npz = conf_lib.store_path(self.npz_dir, smiles)
        if os.path.exists(npz):
            with np.load(npz, allow_pickle=False) as zf:
                return zf["positions"]
        meta = self.summary.get(smiles)
        if meta is not None and os.path.exists(
            os.path.join(self.data_dir, meta["pickle_path"])
        ):
            return load_geom_positions(self.data_dir, meta["pickle_path"])
        # last resort: embed with the built-in DG generator
        mol = smi.add_hydrogens(smi.parse_smiles(smiles))
        return conf_lib.dg_generate(mol, self.num_conformers, seed=1)

    def __getitem__(self, idx: int) -> MoleculeRecord:
        row = self.rows[idx]
        smiles = row["smiles"]
        if smiles not in self._feature_cache:
            mol = smi.add_hydrogens(smi.parse_smiles(smiles))
            self._feature_cache[smiles] = smi.featurize(mol)
        x2d, bonds, battr, z = self._feature_cache[smiles]
        positions = self._positions(smiles)
        k = self.num_conformers
        avail = positions.shape[0]
        if avail != k:
            rng = resample_rng(self.resample_seed, self._epoch, row["mol_id"])
            positions = positions[draw_k_subset(rng, avail, k)]
        if positions.shape[1] != z.shape[0]:
            raise ValueError(
                f"GEOM store for {smiles!r}: {positions.shape[1]} atoms vs "
                f"featuriser {z.shape[0]} — atom ordering/H conventions differ; "
                "regenerate the store with convert_geom_store"
            )
        return MoleculeRecord(
            z=z, pos=positions.astype(np.float32), x2d=x2d, bonds=bonds,
            bond_attr=battr, y=row["y"], smiles=smiles, mol_id=row["mol_id"],
        )

    def records(self) -> list[MoleculeRecord]:
        return [self[i] for i in range(len(self))]
