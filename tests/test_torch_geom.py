"""The port's GEOM path against the JAX package, on the CPU:
``data/geom.py`` (``GEOMDataset`` through its ``.npz``, pickle and
``dg_generate`` routes, K-subset resampling by epoch, oversampling, the
atom-count check; ``convert_geom_store``), the runner's ``dataset: geom``
(the CoV-2 configs' two stages and predict, ``DimeNetGEOMExperiment``'s
stage 1) and one classification stage-2 train step at the N=96 and N=128
buckets, which GEOM-size molecules reach.

Records must be equal: positions bit for bit, as both packages draw the
same K-subsets with numpy and embed with the same numpy code. The train
step is held as ``tests/test_torch_classification.py`` holds its stage-2
step, the loss and each parameter's gradient in norm to 1e-4 relative,
with the floor of ``tests/test_torch_aux_heads.py``: 1e-7 of the norm of
all the gradients, float32's rounding at their scale. At these sizes the
second GAT layer's attention vectors get gradients of 1e-13 to 1 against
a global norm of 4e3 to 1.4e4, and JAX's own f32 gradients of them lie up
to 1.6e-4 (relative) and 1e-8 of the global norm (absolute) from a
float64 step; the port's lie as far."""

import csv
import dataclasses
import json
import os
import pickle
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.data import geom as jgeom
from conan_fgw_tpu.data.packing import PackedBatch as JBatch
from conan_fgw_tpu.data.packing import pack_batch as jpack
from conan_fgw_tpu.models.heads import ConanModel as JConan
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu_torch.convert import params_from_flax
from conan_fgw_tpu_torch.data import geom as tgeom
from conan_fgw_tpu_torch.data import smiles as tsmi
from conan_fgw_tpu_torch.data.conformers import dg_generate, store_path
from conan_fgw_tpu_torch.data.packing import pack_batch as tpack
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import metrics as tmetrics
from conan_fgw_tpu_torch.train import predict as tpredict
from conan_fgw_tpu_torch.train import runner as trunner
from conan_fgw_tpu_torch.train.config import load_config as tload

REPO = Path(__file__).resolve().parents[1]
STEP_RTOL, FLOOR = 1e-4, 1e-7
SMALL = dict(hidden_channels=32, num_filters=32, num_gaussians=10, num_interactions=2)
# small molecules (at most 32 atoms with hydrogens), with activity labels
# and a float target; both classes in every split
SMILES = ["CCO", "c1ccccc1", "CC(=O)O", "CCN", "CCOC", "CCCl", "c1ccncc1", "CC(C)C", "CCCO",
          "CNC", "COC", "CC(=O)N", "OCCO", "CCS", "C1CCCC1", "CC#N", "CCC(=O)O", "NCCN"]
SPLITS = {"train": slice(0, 12), "valid": slice(12, 15), "test": slice(15, 18)}
NO_STORE = "CCCO"      # no store: the dg_generate fallback
FEW = "c1ccncc1"        # 2 stored conformers for K = 3: oversampling
PICKLED = "CC(C)C"      # only a GEOM pickle (summary.json)
# GEOM-size molecules: 65-96 and 97-128 atoms with hydrogens
LARGE = {96: ["CCCCCCCCCCCCCCCCCCCCCc1ccc(C(=O)NCCO)cc1", "CCCCCCCCCCCCCCCCCCCC(=O)OCC1CCNCC1"],
         128: ["CCCCCCCCCCCCCCCCCCCCCCCCCCCCCCc1ccc(C(=O)NCCO)cc1",
               "CCCCCCCCCCCCCCCCCCCCCCCCCCCCCC(=O)OCC1CCNCC1"]}


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The runner's full-width models run here beside JAX: one torch thread
    keeps the file from fighting other test workers for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _FakeConf:
    """Stand-in for an RDKit Conformer (``GetPositions`` only)."""

    def __init__(self, pos):
        self._pos = np.asarray(pos, np.float64)

    def GetPositions(self):
        return self._pos


class _FakeRDMol:
    """Stand-in for the pickled GEOM ``rd_mol`` objects: the readers call
    only ``GetConformers()[0].GetPositions()``."""

    def __init__(self, pos):
        self._confs = [_FakeConf(pos)]

    def GetConformers(self):
        return self._confs


def _atoms(smiles: str) -> int:
    return tsmi.add_hydrogens(tsmi.parse_smiles(smiles)).num_atoms


def write_rows(path: Path, rows):
    os.makedirs(path.parent, exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=["smiles", "active", "score", "mol_id"])
        w.writeheader()
        w.writerows(rows)


def make_geom(root: Path, smiles=SMILES, splits=SPLITS, name="cov2", stored=5) -> Path:
    """``root/data/{name}`` in the GEOM layout: the split CSVs (``active``
    and ``score`` targets), ``.npz`` stores under ``conformers_npz`` with
    ``stored`` conformers (2 for ``FEW``), none for ``NO_STORE``, and for
    ``PICKLED`` a GEOM pickle named in ``summary.json``; returns ``root``."""
    ddir = root / "data" / name
    rng = np.random.default_rng(3)
    rows = [{"smiles": s, "active": i % 2, "score": round(float(rng.normal()), 4),
             "mol_id": f"g{i}"} for i, s in enumerate(smiles)]
    for mode, part in splits.items():
        write_rows(ddir / f"{mode}.csv", rows[part])
    os.makedirs(ddir / "conformers_npz", exist_ok=True)
    summary = {}
    for i, s in enumerate(smiles):
        if s == NO_STORE:
            continue
        mol = tsmi.add_hydrogens(tsmi.parse_smiles(s))
        pos = dg_generate(mol, 2 if s == FEW else stored, seed=i)
        if s == PICKLED:
            rel = f"{name}/pickles/m{i}.pickle"
            os.makedirs(ddir / "pickles", exist_ok=True)
            with open(root / "data" / rel, "wb") as f:
                pickle.dump({"conformers": [{"rd_mol": _FakeRDMol(p)} for p in pos]}, f)
            summary[s] = {"pickle_path": rel}
        else:
            np.savez_compressed(store_path(str(ddir / "conformers_npz"), s), positions=pos,
                                smiles=np.str_(s))
    (ddir / "summary.json").write_text(json.dumps(summary))
    return root


@pytest.fixture(scope="module")
def geom(tmp_path_factory):
    return make_geom(tmp_path_factory.mktemp("geom"))


def assert_same_records(got, want):
    assert len(got) == len(want)
    for t, j in zip(got, want):
        for field in ("z", "pos", "x2d", "bonds", "bond_attr"):
            a, b = getattr(t, field), getattr(j, field)
            assert a.dtype == b.dtype and a.shape == b.shape, (j.mol_id, field)
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8)), (j.mol_id, field)
        assert (t.y, t.smiles, t.mol_id) == (j.y, j.smiles, j.mol_id)


def _pair(root, mode, k, target="active"):
    data = str(root / "data")
    return (tgeom.GEOMDataset(mode, data, "cov2", target, k),
            jgeom.GEOMDataset(mode, data, "cov2", target, k))


@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_records_match_jax_by_epoch(geom, epoch):
    """Every route of the train split (``.npz`` stores resampled from 5 to
    K=3, oversampled from 2, the pickle, the fallback) against the JAX
    class, in each of three epochs; the draws change with the epoch."""
    tds, jds = _pair(geom, "train", 3)
    tds.set_epoch(epoch)
    jds.set_epoch(epoch)
    got = tds.records()
    assert_same_records(got, jds.records())
    assert {r.smiles for r in got} >= {NO_STORE, FEW, PICKLED}
    if epoch:
        tds.set_epoch(0)
        assert not np.array_equal(tds.records()[0].pos, got[0].pos)


@pytest.mark.parametrize("smiles,stored,k", [(FEW, 2, 3), (NO_STORE, 3, 3), (PICKLED, 5, 3),
                                             ("CCO", 5, 5)])
def test_each_route_gives_the_jax_positions(geom, smiles, stored, k):
    """One molecule per route, K against the conformers its route holds:
    oversampled with replacement, embedded, read from the pickle, or
    taken whole when it holds exactly K."""
    tds, jds = _pair(geom, "train", k)
    i = next(i for i, r in enumerate(tds.rows) if r["smiles"] == smiles)
    assert tds._positions(smiles).shape[0] == stored
    assert_same_records([tds[i]], [jds[i]])
    assert tds[i].pos.shape == (k, _atoms(smiles), 3)


def test_valid_and_test_splits_and_the_float_target(geom):
    for mode in ("valid", "test"):
        tds, jds = _pair(geom, mode, 5, target="score")
        assert_same_records(tds.records(), jds.records())
        assert sorted({r.y for r in tds.records()}) != [0.0, 1.0]


def test_atom_count_mismatch_raises_as_in_jax(tmp_path):
    root = make_geom(tmp_path, smiles=SMILES[:4], splits={"train": slice(0, 4)})
    np.savez_compressed(store_path(str(root / "data/cov2/conformers_npz"), SMILES[0]),
                        positions=np.zeros((3, 2, 3), np.float32), smiles=np.str_(SMILES[0]))
    for ds in _pair(root, "train", 3):
        with pytest.raises(ValueError, match="atom ordering"):
            ds[0]


def test_convert_geom_store_writes_the_jax_arrays(tmp_path):
    """Both converters on the same pickles: equal positions and SMILES, and
    ``load_geom_positions`` equal to JAX's."""
    smiles = SMILES[:3]
    data = tmp_path / "data"
    summary = {}
    rng = np.random.default_rng(7)
    os.makedirs(data / "cov2/pickles")
    for i, s in enumerate(smiles):
        confs = [{"rd_mol": _FakeRDMol(rng.normal(size=(_atoms(s), 3)))} for _ in range(4)]
        rel = f"cov2/pickles/m{i}.pickle"
        with open(data / rel, "wb") as f:
            pickle.dump({"conformers": confs}, f)
        summary[s] = {"pickle_path": rel}
    (data / "cov2/summary.json").write_text(json.dumps(summary))
    out_t = tgeom.convert_geom_store(str(data), "cov2", out_subdir="port")
    out_j = jgeom.convert_geom_store(str(data), "cov2", out_subdir="jax")
    for s in smiles:
        pos = tgeom.load_geom_positions(str(data), summary[s]["pickle_path"])
        assert pos.dtype == np.float32 and pos.shape == (4, _atoms(s), 3)
        np.testing.assert_array_equal(pos, jgeom.load_geom_positions(str(data),
                                                                     summary[s]["pickle_path"]))
        with np.load(store_path(out_t, s)) as a, np.load(store_path(out_j, s)) as b:
            assert a.files == b.files
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])


def test_load_datasets_dispatches_on_the_dataset(geom, tmp_path):
    cfg = tmp_path / "c.yaml"
    cfg.write_text((REPO / "config/schnet/cov2_5.yaml").read_text())
    ds = trunner.load_datasets(tload(str(cfg)), str(geom / "data"))
    assert {m: type(d).__name__ for m, d in ds.items()} == dict.fromkeys(
        ("train", "valid", "test"), "GEOMDataset")
    assert [len(ds[m]) for m in ("train", "valid", "test")] == [12, 3, 3]


# ---------------------------------------------------------------- runner
def config_copy(src: str, out: Path, **values) -> str:
    """A copy of the YAML config ``src`` with some top-level values replaced."""
    text = (REPO / src).read_text()
    for key, value in values.items():
        text, n = re.subn(rf"(?m)^{key}: .*$", f"{key}: {value}", text)
        assert n == 1, key
    path = out / Path(src).name
    path.write_text(text)
    return str(path)


def _cli(root: Path, out: Path, config: str, stage: str) -> list[str]:
    return ["--config", config, "--stage", stage, "--data_root", str(root), "--run_name", "g",
            "--run_id", "1", "--models_dir", str(out / "models"), "--logs_dir", str(out / "logs"),
            "--metrics_dir", str(out / "metrics"), "--device", "cpu"]


def test_cli_trains_the_cov2_pair_then_predicts(geom, tmp_path):
    """``config/schnet/cov2_5.yaml`` and then ``cov2_5_bc.yaml`` (1 epoch,
    batch 4) through the runner's CLI on the GEOM store: stage 2 warm-starts
    from stage 1, ``best`` sits at the highest ``val_auroc``, and the AUROC
    of predict's probabilities is the runner's ``test_auroc``."""
    pre = config_copy("config/schnet/cov2_5.yaml", tmp_path, num_epochs=1, batch_size=4)
    bc = config_copy("config/schnet/cov2_5_bc.yaml", tmp_path, num_epochs=1, batch_size=4)
    trunner.main(_cli(geom, tmp_path, pre, "conan_fgw_pre"))
    summary = trunner.main(_cli(geom, tmp_path, bc, "conan_fgw"))
    assert {"test_auroc", "test_prc"} <= summary.keys()
    assert 0.0 <= summary["test_auroc"]["mean"] <= 1.0
    run = tmp_path / "models/g/1/run_conan_fgw:0"
    meta = json.loads((run / "last_state.meta.json").read_text())["loop"]["history"]
    assert meta[0]["fgw_diverged"] == 0 and np.isfinite(meta[0]["train_loss"])
    preds = tmp_path / "preds.csv"
    tpredict.main(["--config", bc, "--checkpoint", str(run), "--data_root", str(geom),
                   "--out", str(preds), "--device", "cpu"])
    with open(preds) as f:
        rows = list(csv.DictReader(f))
    prob = np.array([float(r["prediction"]) for r in rows])
    target = np.array([float(r["target"]) for r in rows]).astype(np.int64)
    assert len(rows) == 3 and np.all((prob > 0) & (prob < 1))
    assert abs(tmetrics.roc_auc(target, prob) - summary["test_auroc"]["mean"]) <= 1e-12


def test_cli_trains_dimenet_geom_stage1(geom, tmp_path):
    """``DimeNetGEOMExperiment``: regression on the float target, stage 1
    (its spec has no barycenter), one epoch through the runner's CLI."""
    cfg = tmp_path / "dimenet_geom.yaml"
    cfg.write_text("dataset_name: ['cov2']\ntarget: ['score']\nnum_conformers: 2\n"
                   "batch_size: 4\nexperiment: conan_fgw.src.experiments.DimeNetGEOMExperiment\n"
                   "num_epochs: 1\nlearning_rate: 0.001\nmodel_name: dimenet\n")
    config = tload(str(cfg))
    assert (config.spec.task, config.spec.barycenter, config.spec.dataset) == (
        "regression", False, "geom")
    summary = trunner.main(_cli(geom, tmp_path, str(cfg), "conan_fgw_pre"))
    assert np.isfinite(summary["test_rmse"]["mean"])
    rmse = tpredict.main(["--config", str(cfg), "--checkpoint",
                          str(tmp_path / "models/g/1/run_conan_fgw_pre:0"), "--data_root",
                          str(geom), "--device", "cpu"])
    assert rmse == summary["test_rmse"]["mean"]


# ---------------------------------------------------------------- large buckets
@pytest.fixture(scope="module")
def large(tmp_path_factory):
    """Two molecules a bucket at N=96 and N=128, two conformers each."""
    smiles = LARGE[96] + LARGE[128]
    assert [bucket for s in smiles for bucket in (96, 128)
            if bucket - 32 < _atoms(s) <= bucket] == [96, 96, 128, 128]
    root = make_geom(tmp_path_factory.mktemp("large"), smiles=smiles,
                     splits={"train": slice(0, 4)}, stored=2)
    return jgeom.GEOMDataset("train", str(root / "data"), "cov2", "active", 2).records()


@pytest.mark.parametrize("n_atoms", [96, 128])
def test_stage2_step_at_the_large_buckets_matches_jax(large, n_atoms):
    """One classification stage-2 train step (the scaled logit BCE through
    the barycenter) on two GEOM molecules of the bucket, narrow widths:
    the loss and the gradients' norm to 1e-4 relative, each parameter's
    gradient in norm to 1e-4 relative beyond the floor."""
    recs = [r for r in large if n_atoms - 32 < r.num_atoms <= n_atoms]
    pb = jpack(recs, max_atoms=n_atoms, batch_size=2)
    pb = dataclasses.replace(pb, y=np.array([1.0, 0.0], np.float32))
    jbatch = JBatch(**jax.tree.map(jnp.asarray, dataclasses.asdict(pb)))
    jmodel = JConan(task="classification", **SMALL)
    params = jmodel.init(jax.random.PRNGKey(n_atoms), jbatch, use_barycenter=True)
    params = {k: v for k, v in params.items() if k != "diagnostics"}
    js = jloop.TrainSettings(task="classification", loss_scale=2.5, use_barycenter=True)
    (loss_j, _), grads_j = jax.value_and_grad(jloop.make_loss_fn(jmodel, js), has_aux=True)(
        params, jbatch)

    tmodel = ConanModel(task="classification", device="cpu", **SMALL)
    tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    tbatch = dataclasses.replace(tpack(recs, max_atoms=n_atoms, batch_size=2),
                                 y=np.array([1.0, 0.0], np.float32)).to("cpu")
    assert tbatch.pos.shape[-2] == n_atoms
    ts = tloop.TrainSettings(task="classification", loss_scale=2.5, use_barycenter=True)
    pred, _ = tmodel(tbatch, use_barycenter=True)
    loss_t = tloop.task_loss(pred, tbatch, ts)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=STEP_RTOL)
    gj = {k: v.numpy() for k, v in params_from_flax(jax.tree.map(np.asarray, grads_j)).items()}
    gt = {k: (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
          for k, p in tmodel.named_parameters()}
    norm_j, norm_t = (np.sqrt(sum(np.sum(g * g) for g in grads.values())) for grads in (gj, gt))
    np.testing.assert_allclose(norm_t, norm_j, rtol=STEP_RTOL)
    for name, g in gt.items():
        diff = np.linalg.norm(g - gj[name])
        assert diff <= STEP_RTOL * np.linalg.norm(gj[name]) + FLOOR * norm_j, (name, diff)
