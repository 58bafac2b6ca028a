"""Port parity: the data layer against the JAX package's numpy modules, on
the repo's ``data/sol250`` (and ``data/sol1k_class`` for the class weights).

SMILES featurisation, conformer stores, the distance-geometry generator,
the diverse-selection helpers and ``ConformerDataset`` records (epochs 0
and 1, so the per-epoch K-subset resampling too) must be equal exactly:
both sides run the same numpy arithmetic."""

from pathlib import Path

import numpy as np
import pytest

from conan_fgw_tpu.data import conformers as jconf
from conan_fgw_tpu.data import datasets as jds
from conan_fgw_tpu.data import loader as jloader
from conan_fgw_tpu.data import smiles as jsmi
from conan_fgw_tpu_torch.data import conformers as tconf
from conan_fgw_tpu_torch.data import datasets as tds
from conan_fgw_tpu_torch.data import loader as tloader
from conan_fgw_tpu_torch.data import smiles as tsmi

DATA = str(Path(__file__).resolve().parents[1] / "data")
SPLITS = ("train", "valid", "test")
FIELDS = ("z", "pos", "x2d", "bonds", "bond_attr")


def _equal_arrays(a, b, what):
    assert a.dtype == b.dtype and a.shape == b.shape, what
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("split", SPLITS)
def test_featurize_matches_on_sol250(split):
    rows = jds.read_csv_rows(f"{DATA}/sol250/{split}.csv", "logS_surrogate")
    assert rows == tds.read_csv_rows(f"{DATA}/sol250/{split}.csv", "logS_surrogate")
    for r in rows:
        ja = jsmi.featurize(jsmi.add_hydrogens(jsmi.parse_smiles(r["smiles"])))
        ta = tsmi.featurize(tsmi.add_hydrogens(tsmi.parse_smiles(r["smiles"])))
        for name, a, b in zip(("x2d", "bonds", "bond_attr", "z"), ja, ta):
            _equal_arrays(a, b, f"{r['smiles']}: {name}")


@pytest.mark.parametrize("split", SPLITS)
def test_conformer_dataset_matches_on_sol250(split):
    args = (split, DATA, "sol250", "logS_surrogate", 5)
    jd = jds.ConformerDataset(*args, generate_missing=False)
    td = tds.ConformerDataset(*args, generate_missing=False)
    by_epoch = []
    for epoch in (0, 1):
        jd.set_epoch(epoch)
        td.set_epoch(epoch)
        recs = td.records()
        for a, b in zip(jd.records(), recs, strict=True):
            for f in FIELDS:
                _equal_arrays(getattr(a, f), getattr(b, f), f"{b.mol_id} epoch {epoch}: {f}")
            assert (a.y, a.smiles, a.mol_id) == (b.y, b.smiles, b.mol_id)
            assert b.pos.shape[0] == 5
        by_epoch.append(recs)
    # stores hold 10 conformers: epoch 1 draws other subsets than epoch 0
    assert any(not np.array_equal(a.pos, b.pos) for a, b in zip(*by_epoch))


def test_sol250_reaches_the_n64_bucket():
    """With hydrogens, sol250 molecules have 3 to 53 atoms, so the runner's
    steps run in the N=32 and the N=64 buckets."""
    sizes = [r.num_atoms for s in SPLITS
             for r in tds.ConformerDataset(s, DATA, "sol250", "logS_surrogate", 5,
                                           generate_missing=False).records()]
    assert (min(sizes), max(sizes)) == (3, 53)
    assert any(n > 32 for n in sizes) and any(n <= 32 for n in sizes)


def test_class_weight_ratio_matches():
    rows = tds.read_csv_rows(f"{DATA}/sol1k_class/train.csv", "Class")
    assert tds.class_weight_ratio(rows) == jds.class_weight_ratio(rows)
    assert tds.class_weight_ratio(rows) != 1.0


def test_csv_without_stores_generates_the_same_conformers(tmp_path, monkeypatch):
    """A CSV without conformer stores: both packages embed with the numpy
    distance-geometry route and write identical stores; ``write_csv`` and
    ``read_csv_rows`` round-trip across the packages."""
    monkeypatch.setattr(jconf, "HAVE_RDKIT", False)
    monkeypatch.setattr(tconf, "HAVE_RDKIT", False)
    rows = [{"smiles": s, "y": float(i), "mol_id": f"m{i}"}
            for i, s in enumerate(("CCO", "c1ccncc1", "CC(=O)N"))]
    for side, mod in (("j", jds), ("t", tds)):
        mod.write_csv(str(tmp_path / side / "mini" / "train.csv"), rows, target="y")
    assert jds.read_csv_rows(str(tmp_path / "t" / "mini" / "train.csv"), "y") == rows
    jd = jds.ConformerDataset("train", str(tmp_path / "j"), "mini", "y", 2, store_conformers=3)
    td = tds.ConformerDataset("train", str(tmp_path / "t"), "mini", "y", 2, store_conformers=3)
    for a, b in zip(jd.records(), td.records(), strict=True):
        for f in FIELDS:
            _equal_arrays(getattr(a, f), getattr(b, f), f"{b.smiles}: {f}")
    for r in rows:
        _equal_arrays(jconf.load_store(jd.conformers_dir, r["mol_id"]),
                      tconf.load_store(td.conformers_dir, r["mol_id"]), r["smiles"])
    with pytest.raises(FileNotFoundError):
        tconf.load_store(td.conformers_dir, "absent")


def test_selection_helpers_match():
    mol = tsmi.add_hydrogens(tsmi.parse_smiles("CCCCO"))
    pos = tconf.dg_generate(mol, 6, seed=3)
    _equal_arrays(pos, jconf.dg_generate(jsmi.add_hydrogens(jsmi.parse_smiles("CCCCO")), 6, seed=3),
                  "dg_generate")
    np.testing.assert_array_equal(tconf.pairwise_rmsd(pos), jconf.pairwise_rmsd(pos))
    assert tconf.select_diverse(pos, 3, seed=1) == jconf.select_diverse(pos, 3, seed=1)
    assert tconf.select_diverse_kmedoids(pos, 3) == jconf.select_diverse_kmedoids(pos, 3)
    for k in (4, 10, 12):
        assert tconf.resample_indices(10, k, seed=2) == jconf.resample_indices(10, k, seed=2)
    assert tconf.store_path("d", "a/b.c") == jconf.store_path("d", "a/b.c")


def test_bucket_order_matches_the_loader():
    td = tds.ConformerDataset("test", DATA, "sol250", "logS_surrogate", 5, generate_missing=False)
    recs = td.records()
    order = tloader.bucket_order(recs, buckets=(32, 64))
    assert order == jloader.bucket_order(recs, buckets=(32, 64))
    packed = [pb for pb in tloader.bucketed_batches(recs, 8, buckets=(32, 64))]
    ids = [recs[i].mol_id for i in order]
    np.testing.assert_array_equal(np.concatenate([pb.y[pb.mol_mask] for pb in packed]),
                                  np.asarray([recs[i].y for i in order], np.float32))
    assert sorted(ids) == sorted(r.mol_id for r in recs)
