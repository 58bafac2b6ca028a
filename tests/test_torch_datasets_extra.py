"""The rest of the port's data layer against the JAX package:
``NTrialsConformerDataset`` (``n_trials`` independent K-subsets a molecule,
keyed on the trial and the epoch), ``BDEDataset`` (stores must exist, the
SMILES comes from the store) and ``SmilesDataset`` (K=1 zero positions, no
hydrogens), on ``data/sol250``'s molecules and stores. Records must be
equal, positions bit for bit."""

import os
import shutil
from pathlib import Path

import numpy as np
import pytest

from conan_fgw_tpu.data import datasets as jdata
from conan_fgw_tpu_torch.data import datasets as tdata
from conan_fgw_tpu_torch.data.conformers import store_path

SOL250 = Path(__file__).resolve().parents[1] / "data" / "sol250"
TARGET = "logS_surrogate"


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """``root/tiny``: 8 train and 4 test sol250 molecules with their stores
    of 10 conformers; returns ``root``."""
    root = tmp_path_factory.mktemp("extra")
    rows = tdata.read_csv_rows(str(SOL250 / "train.csv"), TARGET)[3:15]
    for mode, part in (("train", rows[:8]), ("test", rows[8:])):
        tdata.write_csv(str(root / "tiny" / f"{mode}.csv"), part, target=TARGET)
        os.makedirs(root / "tiny" / f"conformers_{mode}")
        for r in part:
            shutil.copy(store_path(str(SOL250 / "conformers_train"), r["mol_id"]),
                        store_path(str(root / "tiny" / f"conformers_{mode}"), r["mol_id"]))
    return root


def assert_same(got, want):
    for field in ("z", "pos", "x2d", "bonds", "bond_attr"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), field
    assert (got.y, got.smiles, got.mol_id) == (want.y, want.smiles, want.mol_id)


@pytest.mark.parametrize("epoch", [0, 3])
@pytest.mark.parametrize("k", [3, 12])
def test_n_trials_matches_jax(tiny, epoch, k):
    """Four trials of K=3 from 10 stored conformers (without replacement)
    and of K=12 (with), in two epochs."""
    args = ("train", str(tiny), "tiny", TARGET, k)
    tds = tdata.NTrialsConformerDataset(*args, n_trials=4)
    jds = jdata.NTrialsConformerDataset(*args, n_trials=4)
    tds.set_epoch(epoch)
    jds.set_epoch(epoch)
    for i in range(len(tds)):
        got, want = tds[i], jds[i]
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            assert g.pos.shape[0] == k
            assert_same(g, w)
        assert not np.array_equal(got[0].pos, got[1].pos)  # independent draws


@pytest.mark.parametrize("mode", ["train", "test"])
def test_bde_takes_the_smiles_from_the_store(tiny, tmp_path, mode):
    """The CSV names each molecule by a placeholder SMILES; both packages
    featurise the SMILES its store recorded."""
    shutil.copytree(tiny / "tiny", tmp_path / "tiny")
    rows = tdata.read_csv_rows(str(tmp_path / "tiny" / f"{mode}.csv"), TARGET)
    tdata.write_csv(str(tmp_path / "tiny" / f"{mode}.csv"),
                    [dict(r, smiles="C") for r in rows], target=TARGET)
    args = (mode, str(tmp_path), "tiny", TARGET, 3)
    tds, jds = tdata.BDEDataset(*args), jdata.BDEDataset(*args)
    assert not tds.generate_missing
    for i in range(len(tds)):
        got = tds[i]
        assert_same(got, jds[i])
        assert got.smiles == rows[i]["smiles"] != "C"


def test_bde_without_a_store_raises_as_in_jax(tiny, tmp_path):
    shutil.copytree(tiny / "tiny", tmp_path / "tiny")
    rows = tdata.read_csv_rows(str(tmp_path / "tiny" / "test.csv"), TARGET)
    os.remove(store_path(str(tmp_path / "tiny" / "conformers_test"), rows[1]["mol_id"]))
    for cls in (tdata.BDEDataset, jdata.BDEDataset):
        ds = cls("test", str(tmp_path), "tiny", TARGET, 3)
        ds[0]
        with pytest.raises(ValueError, match=f"Conformers for molecule {rows[1]['mol_id']}"):
            ds[1]


@pytest.mark.parametrize("mode", ["train", "test"])
def test_smiles_dataset_matches_jax(tiny, mode):
    tds = tdata.SmilesDataset(mode, str(tiny), "tiny", TARGET)
    jds = jdata.SmilesDataset(mode, str(tiny), "tiny", TARGET)
    got = tds.records()
    assert len(got) == len(jds) > 0
    for g, w in zip(got, jds.records()):
        assert_same(g, w)
        assert g.pos.shape == (1, g.z.shape[0], 3) and not g.pos.any()
        assert 1 not in g.z  # no hydrogens
