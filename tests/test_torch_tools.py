"""The port's tools and the last names of its modules, against the JAX
package on the CPU: ``data/conformers.py::generate_store``, the
``tools/prepare_data.py`` sources (``--builtin`` sol250/sol1k and the
derived sets, ``--download`` from a ``file://`` URL), ``run_experiment``'s
``datasets=`` and ``records_provider=``, ``merge_params``, ``StepTimer``,
``shard_range``, ``models/registry.py::get_model``,
``tools/summarize_protocol.py``, ``tools/eval_geom_scale.py`` (one process
and a two-rank gloo mesh) and ``tools/synthetic_e2e.py``.

Tolerances: files and CSVs byte for byte, manifests equal as JSON; the
runner's losses as in ``tests/test_torch_runner.py`` (1e-4 relative in the
first epoch, 1e-3 after it); eval predictions under carried weights within
1e-4 relative of the largest (the flagship's stage-1 forward in f32), and
two ranks' within 1e-6 of one process's."""

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from conan_fgw_tpu.data import conformers as jconf
from conan_fgw_tpu.data import loader as jloader
from conan_fgw_tpu.data import smiles as jsmi
from conan_fgw_tpu.data.synthetic import random_dataset as jrandom_dataset
from conan_fgw_tpu.models import registry as jregistry
from conan_fgw_tpu.train import checkpoints as jcheckpoints
from conan_fgw_tpu.train import runner as jrunner
from conan_fgw_tpu.train.config import ExperimentConfig as JConfig
from conan_fgw_tpu.utils import profiling as jprofiling
from conan_fgw_tpu_torch.convert import params_from_flax, state_dict_from_flax_checkpoint
from conan_fgw_tpu_torch.data import conformers as tconf
from conan_fgw_tpu_torch.data import loader as tloader
from conan_fgw_tpu_torch.data.synthetic import random_dataset as trandom_dataset
from conan_fgw_tpu_torch.models import registry as tregistry
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.train import checkpoints as tcheckpoints
from conan_fgw_tpu_torch.train import runner as trunner
from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer
from conan_fgw_tpu_torch.train.config import ExperimentConfig as TConfig
from conan_fgw_tpu_torch.tools import eval_geom_scale, summarize_protocol, synthetic_e2e
from conan_fgw_tpu_torch.tools import prepare_data as tprep
from conan_fgw_tpu_torch.utils import profiling as tprofiling

ROOT = Path(__file__).resolve().parents[1]
SOL250 = ROOT / "data" / "sol250"
FIRST_RTOL, LATER_RTOL = 1e-4, 1e-3
EVAL_RTOL = 1e-4
RANKS_RTOL = 1e-6  # two ranks against one process: f32 rounding only


def _jax_script(name: str):
    """A module of the JAX package's ``scripts/``, loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_scripts_{name}",
                                                  ROOT / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jprep():
    return _jax_script("prepare_data")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The full-width model runs beside JAX here: one torch thread keeps the
    file from fighting other test workers for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree_bytes(root: Path) -> dict:
    """Every regular file under ``root`` (symlinks to directories followed
    as links, not entered) by relative path, with its bytes."""
    out = {}
    for path in sorted(root.rglob("*")):
        if path.is_file() and not any(p.is_symlink() for p in path.relative_to(root).parents
                                      if str(p) != "."):
            out[str(path.relative_to(root))] = path.read_bytes()
    return out


def _quiet(fn, *args, **kwargs):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = fn(*args, **kwargs)
    return result, out.getvalue()


# ---------------------------------------------------------------- conformer stores
def test_generate_store_matches_jax(tmp_path):
    smiles = ["CCO", "c1ccccc1O", "CC(=O)N", "not a molecule"]
    ids = ["m/0", "m1", "m2", "bad"]
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jfailed = jconf.generate_store(smiles, ids, str(jdir), 4, max_workers=2)
    tfailed = tconf.generate_store(smiles, ids, str(tdir), 4, max_workers=2)
    assert [m for m, _ in tfailed] == [m for m, _ in jfailed] == ["bad"]
    jfiles, tfiles = _tree_bytes(jdir), _tree_bytes(tdir)
    assert sorted(tfiles) == sorted(jfiles) == ["m1.npz", "m2.npz", "m_0.npz"]
    assert tfiles == jfiles
    # an existing store is skipped, not rewritten
    (tdir / "m1.npz").write_bytes(b"kept")
    assert tconf.generate_store(smiles[1:2], ids[1:2], str(tdir), 4, max_workers=1) == []
    assert (tdir / "m1.npz").read_bytes() == b"kept"


# ---------------------------------------------------------------- prepare_data
def test_enumerate_sol1k_and_surrogate_match_jax(jprep):
    library = tprep.enumerate_sol1k()
    assert library == jprep.enumerate_sol1k()
    assert tprep.SOL250_SMILES == jprep.SOL250_SMILES
    for s in library[::97] + ["CC(C)Cc1ccc(cc1)C(C)C(O)=O"]:
        assert tprep.surrogate_logS(s) == jprep.surrogate_logS(s), s
    for s in ("[Xe]", "C1CC"):  # the parser's rejections raise in both
        with pytest.raises(Exception):
            jprep.surrogate_logS(s)
        with pytest.raises(Exception):
            tprep.surrogate_logS(s)


def _committed_stores() -> dict:
    """``data/sol250``'s stores by SMILES: their bytes."""
    import csv

    out = {}
    for mode in ("train", "valid", "test"):
        with open(SOL250 / f"{mode}.csv", newline="") as f:
            for r in csv.DictReader(f):
                out[r["smiles"]] = Path(tconf.store_path(str(SOL250 / f"conformers_{mode}"),
                                                         r["mol_id"])).read_bytes()
    return out


def test_prepare_builtin_matches_jax_and_the_committed_sol250(tmp_path, monkeypatch, jprep):
    subset = tprep.SOL250_SMILES[::33]
    monkeypatch.setattr(jprep, "SOL250_SMILES", subset)
    monkeypatch.setattr(tprep, "SOL250_SMILES", subset)
    _quiet(jprep.prepare_builtin, "sol250", str(tmp_path / "jax"), 10, 2)
    _quiet(tprep.prepare_builtin, "sol250", str(tmp_path / "port"), 10, 2)
    jdir, tdir = tmp_path / "jax" / "data" / "sol250", tmp_path / "port" / "data" / "sol250"
    jfiles, tfiles = _tree_bytes(jdir), _tree_bytes(tdir)
    assert sorted(tfiles) == sorted(jfiles)
    for name in tfiles:
        if name != "manifest.json":
            assert tfiles[name] == jfiles[name], name
    assert json.loads(tfiles["manifest.json"]) == json.loads(jfiles["manifest.json"])
    manifest = json.loads(tfiles["manifest.json"])
    assert manifest["n_molecules"] == len(subset) and sum(manifest["splits"].values()) == len(subset)
    # every store is the committed data/sol250 one, byte for byte
    committed = _committed_stores()
    stores = [p for p in tdir.glob("conformers_*/*.npz")]
    assert len(stores) == len(subset)
    for path in stores:
        with np.load(path) as z:
            smiles = str(z["smiles"])
        assert path.read_bytes() == committed[smiles], smiles


def _mini_sol1k(root: Path) -> None:
    """A sol1k-shaped root (``tests/test_prepare_derived.py``'s): three
    splits with four-conformer stores."""
    base = root / "data" / "sol1k"
    smiles = ["CCO", "CCC", "CCN", "CCCl", "COC", "CCCO", "CNC", "CCCC"]
    rows = [{"smiles": s, "y": float(-i), "mol_id": f"sol1k_{i:04d}"} for i, s in enumerate(smiles)]
    for mode, subset in (("train", rows[:6]), ("valid", rows[6:7]), ("test", rows[7:])):
        tprep.write_csv(str(base / f"{mode}.csv"), subset, target="logS_surrogate")
        cdir = base / f"conformers_{mode}"
        cdir.mkdir(parents=True, exist_ok=True)
        for r in subset:
            mol = jsmi.add_hydrogens(jsmi.parse_smiles(r["smiles"]))
            pos = np.stack([jconf.dg_generate(mol, 1, seed=7 + c)[0] for c in range(4)])
            np.savez_compressed(jconf.store_path(str(cdir), r["mol_id"]), positions=pos,
                                smiles=np.str_(r["smiles"]))


@pytest.mark.parametrize("name", ["sol1k_class", "solflex", "solflex_class", "solcons"])
def test_prepare_derived_matches_jax(tmp_path, jprep, name):
    for side in ("jax", "port"):
        _mini_sol1k(tmp_path / side)
    _quiet(jprep.prepare_derived, name, str(tmp_path / "jax"))
    _quiet(tprep.prepare_derived, name, str(tmp_path / "port"))
    jdir, tdir = tmp_path / "jax" / "data" / name, tmp_path / "port" / "data" / name
    for mode in ("train", "valid", "test"):
        assert (tdir / f"{mode}.csv").read_bytes() == (jdir / f"{mode}.csv").read_bytes()
        link = tdir / f"conformers_{mode}"
        assert link.is_symlink() and os.readlink(link) == os.readlink(jdir / f"conformers_{mode}")
    assert json.loads((tdir / "manifest.json").read_text()) == json.loads(
        (jdir / "manifest.json").read_text())
    with pytest.raises(FileNotFoundError, match="sol1k"):
        tprep.prepare_derived(name, str(tmp_path / "nowhere"))


def test_prepare_download_matches_jax(tmp_path, monkeypatch, jprep):
    raw = tmp_path / "delaney-processed.csv"
    rows = [("ethanol", "CCO", -0.30), ("propane", "CCC", 1.00), ("benzene", "c1ccccc1", 2.10),
            ("acetic acid", "CC(=O)O", -0.17), ("toluene", "Cc1ccccc1", 2.25),
            ("naphthalene", "c1ccc2ccccc2c1", 3.30), ("furan", "c1ccoc1", 0.80),
            ("thiophene", "c1ccsc1", 1.20), ("cyclohexane", "C1CCCCC1", 2.90),
            ("tetrahydrofuran", "C1CCOC1", -0.50), ("pyridine", "c1ccncc1", 0.65),
            ("aniline", "Nc1ccccc1", 1.05)]
    raw.write_text("Compound ID,smiles,measured log solubility in mols per litre\n"
                   + "".join(f"{c},{s},{y}\n" for c, s, y in rows))
    for module in (jprep, tprep):
        monkeypatch.setitem(module.DOWNLOADS["esol"], "url", f"file://{raw}")
    _quiet(jprep.prepare_download, "esol", str(tmp_path / "jax"), 3, 1, False)
    _quiet(tprep.prepare_download, "esol", str(tmp_path / "port"), 3, 1, False)
    jdir, tdir = tmp_path / "jax" / "data" / "esol", tmp_path / "port" / "data" / "esol"
    jfiles, tfiles = _tree_bytes(jdir), _tree_bytes(tdir)
    assert sorted(tfiles) == sorted(jfiles)
    for name in tfiles:
        if name != "manifest.json":
            assert tfiles[name] == jfiles[name], name
    manifest = json.loads(tfiles["manifest.json"])
    assert manifest == json.loads(jfiles["manifest.json"])
    assert manifest["sha256"] == tprep._sha256(str(raw)) and manifest["n_molecules"] == len(rows)


def test_prepare_data_cli_refuses_two_sources(tmp_path):
    with pytest.raises(SystemExit):
        tprep.main(["--builtin", "sol250", "--download", "esol", "--data_root", str(tmp_path)])


# ---------------------------------------------------------------- the runner's injected records
def _synthetic(n: int, K: int = 2):
    """The same synthetic molecules in both packages (their generators are
    bit-identical), split 8/2/2."""
    j = jrandom_dataset(11, n, num_conformers=K, heavy_range=(4, 7))
    t = trandom_dataset(11, n, num_conformers=K, heavy_range=(4, 7), device="cpu")
    assert [r.y for r in j] == [r.y for r in t]
    split = lambda recs: {"train": recs[:8], "valid": recs[8:10], "test": recs[10:]}  # noqa: E731
    return split(j), split(t)


def _configs(cls, experiment: str, lr: float) -> object:
    return cls(dataset_name=["synthetic"], target=["y"], num_conformers=2, batch_size=4,
               experiment=experiment, num_epochs=2, learning_rate=lr, es_patience=50,
               max_atoms=32)


def test_run_experiment_on_injected_datasets_matches_jax(tmp_path):
    jdata, tdata = _synthetic(12)
    common = dict(run_name="s", run_id="0")
    jmodels, tmodels = tmp_path / "jax", tmp_path / "port"
    jrunner.run_experiment(_configs(JConfig, "regression", 1e-3), stage=jrunner.STAGE_PRE,
                           datasets=jdata, models_dir=str(jmodels), **common)
    state = state_dict_from_flax_checkpoint(str(jmodels / "s/0/run_conan_fgw_pre:0/best.npz"))
    model = ConanModel(device="cpu")
    model.load_state_dict(state)
    RunCheckpointer(str(tmodels / "s/0/run_conan_fgw_pre:0")).save_best(model, 0)
    _, jruns = jrunner.run_experiment(_configs(JConfig, "regression_bc", 5e-4),
                                      stage=jrunner.STAGE_BC, datasets=jdata,
                                      models_dir=str(jmodels), **common)
    _, truns = trunner.run_experiment(_configs(TConfig, "regression_bc", 5e-4),
                                      stage=trunner.STAGE_BC, datasets=tdata,
                                      models_dir=str(tmodels), device="cpu",
                                      data_dir=str(tmp_path / "no_data_here"), **common)
    jh, th = jruns[0]["history"], truns[0]["history"]
    assert [r["epoch"] for r in th] == [r["epoch"] for r in jh] == [0, 1]
    for jrow, trow in zip(jh, th):
        rtol = FIRST_RTOL if trow["epoch"] == 0 else LATER_RTOL
        for key in ("train_loss", "val_mse", "val_loss"):
            assert abs(trow[key] - jrow[key]) <= rtol * abs(jrow[key]), (trow["epoch"], key)
        assert trow["fgw_diverged"] == jrow["fgw_diverged"] and trow["train_steps"] == 2
    jr, tr = jruns[0]["metrics"]["test_rmse"], truns[0]["metrics"]["test_rmse"]
    assert abs(tr - jr) <= LATER_RTOL * abs(jr)


class _Stop(Exception):
    pass


@pytest.mark.parametrize("given", ["datasets", "records_provider", "data_dir"])
def test_records_precedence(tmp_path, monkeypatch, given):
    """``datasets``, then ``records_provider(split)``, then ``data_dir``
    (JAX ``runner.py:184-186``): what ``fit`` is handed shows which."""
    _, tdata = _synthetic(12)
    other = {m: list(reversed(v)) for m, v in tdata.items()}
    asked, loaded = [], []

    def provider(split):
        asked.append(split)
        return other[split]

    class Dataset:
        def __init__(self, records):
            self._records = records

        def records(self):
            return self._records

        def set_epoch(self, epoch):
            pass

    def load_datasets(config, data_dir):
        loaded.append(data_dir)
        return {m: Dataset(v[:4]) for m, v in tdata.items()}

    def fit(settings, train_records, val_records, **kw):
        raise _Stop(train_records(0) if callable(train_records) else train_records, val_records)

    monkeypatch.setattr(trunner, "load_datasets", load_datasets)
    monkeypatch.setattr(trunner.loop_lib, "fit", fit)
    kwargs = {"datasets": dict(datasets=tdata, records_provider=provider),
              "records_provider": dict(records_provider=provider),
              "data_dir": {}}[given]
    with pytest.raises(_Stop) as stop:
        trunner.run_experiment(_configs(TConfig, "regression", 1e-3), device="cpu",
                               data_dir=str(tmp_path), models_dir=str(tmp_path / "m"), **kwargs)
    train, valid = stop.value.args
    want = {"datasets": tdata, "records_provider": other,
            "data_dir": {m: v[:4] for m, v in tdata.items()}}[given]
    assert train == want["train"] and valid == want["valid"]
    assert asked == (["train", "valid", "test"] if given == "records_provider" else [])
    assert loaded == ([str(tmp_path)] if given == "data_dir" else [])


# ---------------------------------------------------------------- small names
def test_merge_params_matches_jax():
    rng = np.random.default_rng(0)
    target = {"backbone": {"w": rng.normal(size=3), "b": rng.normal(size=2)},
              "head": {"w": rng.normal(size=4)}, "tbary": {"w": rng.normal(size=1)}}
    source = {"backbone": {"w": rng.normal(size=3)}, "head": {"w": rng.normal(size=4)},
              "extra": {"w": rng.normal(size=5)}}
    want = jcheckpoints.merge_params(target, source)
    got = tcheckpoints.merge_params(target, source)
    flat = lambda t, p="": [(p + k, v) for k, v in t.items()] if not any(  # noqa: E731
        isinstance(v, dict) for v in t.values()) else sum((flat(v, p + k + "/") for k, v in
                                                           t.items()), [])
    assert [k for k, _ in flat(got)] == [k for k, _ in flat(want)]
    for (_, a), (_, b) in zip(flat(got), flat(want)):
        assert a is b
    # over state dicts: stage 1's entries restored, the rest kept
    stage1 = ConanModel(seed=1, device="cpu").state_dict()
    stage2 = ConanModel(seed=2, device="cpu").state_dict()
    part = {k: v for k, v in stage1.items() if k.startswith("backbone.")}
    merged = tcheckpoints.merge_params(stage2, part)
    assert list(merged) == list(stage2)
    assert all(merged[k] is (part[k] if k in part else stage2[k]) for k in merged)


def test_step_timer_matches_jax(monkeypatch):
    ticks = iter([0.0, 0.5, 1.0, 1.25, 2.0, 2.75, 3.0, 3.125] * 2)
    fake = lambda: next(ticks)  # noqa: E731
    summaries = []
    for module in (jprofiling, tprofiling):
        monkeypatch.setattr(module.time, "perf_counter", fake)
        timer = module.StepTimer()
        for _ in range(4):
            with timer:
                pass
        summaries.append(timer.summary())
    assert summaries[1] == summaries[0]
    assert summaries[1]["steps"] == 3 and summaries[1]["max_s"] == 0.75


def test_step_timer_synchronises_the_card(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: calls.append(device))
    timer = tprofiling.StepTimer(device="cuda:0")
    with timer:
        pass
    assert calls == [torch.device("cuda:0")] * 2
    with tprofiling.StepTimer(device="cpu"):
        pass
    assert len(calls) == 2


@pytest.mark.parametrize("n,count", [(10, 3), (7, 7), (5, 8), (96, 4), (0, 2)])
def test_shard_range_matches_jax(n, count):
    for index in range(count):
        assert tloader.shard_range(n, index, count) == jloader.shard_range(n, index, count)
    assert [i for k in range(count) for i in tloader.shard_range(n, k, count)] == list(range(n))


def _backbone_inputs(name: str, jbatch, tbatch):
    """The registry module's inputs in each package: ``(jax, port)``."""
    import jax.numpy as jnp

    if name.endswith("esan"):
        return (jbatch,), (tbatch,)
    if name == "gat":
        fields = ("x2d", "bond_adj", "bond_attr", "atom_mask")
        return (tuple(getattr(jbatch, f) for f in fields),
                tuple(getattr(tbatch, f) for f in fields))
    B, K, N = tbatch.z.shape
    flat = [tbatch.z.reshape(B * K, N), tbatch.pos.reshape(B * K, N, 3),
            tbatch.atom_mask.repeat_interleave(K, dim=0)]
    if name == "schnet_covalent":
        flat += [tbatch.bond_adj.repeat_interleave(K, dim=0),
                 tbatch.bond_attr.repeat_interleave(K, dim=0)]
    return tuple(jnp.asarray(t.numpy()) for t in flat), tuple(flat)


@pytest.mark.parametrize("name,kw", [
    ("simple_schnet", {}), ("schnet", {}), ("schnet", {"cutoff": 10.0, "feat_dim": 512}),
    ("schnet_covalent", {}), ("simple_dimenet", {}), ("dimenet", {}), ("gat", {}),
    ("visnet", {}), ("avg_conf_esan", {}), ("geometry_induced_esan", {}),
    ("geometry_2d_induced_esan", {})])
def test_get_model_matches_jax(name, kw):
    """Each registry name gives the port's module with the JAX module's
    parameters (as many, of the same sizes) and outputs of the same shapes."""
    import jax
    import jax.numpy as jnp

    from conan_fgw_tpu.data.packing import PackedBatch as JBatch
    from conan_fgw_tpu.data.packing import pack_batch as jpack
    from conan_fgw_tpu_torch.data.packing import pack_batch as tpack

    jrecs = jrandom_dataset(3, 2, num_conformers=2, heavy_range=(4, 7))
    trecs = trandom_dataset(3, 2, num_conformers=2, heavy_range=(4, 7), device="cpu")
    jbatch = JBatch(**jax.tree.map(jnp.asarray, dataclasses.asdict(jpack(jrecs, max_atoms=32,
                                                                          batch_size=2))))
    tbatch = tpack(trecs, max_atoms=32, batch_size=2).to("cpu")
    jin, tin = _backbone_inputs(name, jbatch, tbatch)
    jmodule = jregistry.get_model(name, **kw)
    variables = jax.eval_shape(jmodule.init, jax.random.PRNGKey(0), *jin)
    jsizes = sorted(int(np.prod(v.shape)) for v in jax.tree.leaves(variables["params"]))
    jout = [tuple(v.shape) for v in jax.tree.leaves(jax.eval_shape(jmodule.apply, variables, *jin))]

    model = tregistry.get_model(name, seed=0, device="cpu", **kw)
    assert sorted(p.numel() for p in model.parameters()) == jsizes
    with torch.no_grad():
        out = model(*tin)
    touts = [tuple(t.shape) for t in (out if isinstance(out, (tuple, list)) else (out,))]
    assert touts == jout
    again = tregistry.get_model(name, seed=0, device="cpu", **kw)
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    with pytest.raises(ValueError, match="unknown model"):
        tregistry.get_model("schnett", device="cpu")


# ---------------------------------------------------------------- summarize_protocol
def test_summarize_protocol_matches_jax(tmp_path, monkeypatch):
    summaries = {"sol250_5": {"test_rmse": {"mean": 0.81234, "std": 0.0123, "n": 3}},
                 "sol1k_class_5_bc": {"test_auroc": {"mean": 0.9, "std": 0.01, "n": 5}},
                 "broken": {"val_mse": 1.0},
                 "a_long_protocol_name": {"test_rmse": {"mean": 1.5, "std": 0.0}}}
    for name, s in summaries.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(s))
    jmod = _jax_script("summarize_protocol")
    monkeypatch.setattr("sys.argv", ["summarize_protocol.py", str(tmp_path)])
    _, want = _quiet(jmod.main)
    _, got = _quiet(summarize_protocol.main, [str(tmp_path)])
    assert got == want
    assert len(got.splitlines()) == 4
    monkeypatch.setattr("sys.argv", ["summarize_protocol.py", str(tmp_path / "none")])
    _, jempty = _quiet(jmod.main)
    _, empty = _quiet(summarize_protocol.main, [str(tmp_path / "none")])
    assert empty == jempty and empty.splitlines() == ["protocol  test metric (mean ± std)  n"]


# ---------------------------------------------------------------- eval_geom_scale
def _jax_eval(n: int, batch: int):
    """The JAX tool's model and evaluate at ``batch``: its parameters and
    predictions in record order."""
    import jax
    import jax.numpy as jnp

    from conan_fgw_tpu.data.packing import PackedBatch as JBatch
    from conan_fgw_tpu.models.heads import ConanModel as JModel
    from conan_fgw_tpu.train import loop as jloop

    recs = jrandom_dataset(7, n, num_conformers=eval_geom_scale.K, heavy_range=(8, 13))
    settings = jloop.TrainSettings(use_barycenter=False, batch_size=batch)
    max_atoms = jloop.dataset_max_atoms(recs)
    first = next(iter(jloop.batch_iterator(recs, batch, max_atoms)))
    state = jloop.init_state(JModel(), settings,
                             JBatch(**jax.tree.map(jnp.asarray, dataclasses.asdict(first))))
    _, eval_step = jloop.make_step_fns(JModel(), settings)
    metrics, pred, _ = jloop.evaluate(eval_step, state.params, recs, settings, max_atoms, None)
    order = np.asarray(jloader.bucket_order(recs, buckets=jloop.bucket_boundaries(max_atoms)))
    in_order = np.empty_like(pred)
    in_order[order] = pred
    return state.params, in_order, float(metrics["loss"])


def test_eval_geom_scale_one_process_and_two_ranks(tmp_path):
    n, batch = 10, 4
    params, jpred, jloss = _jax_eval(n, batch)
    state = params_from_flax(jax_tree_to_numpy(params))
    single, pred = eval_geom_scale.run(n, device="cpu", state_dict=state, batch=batch)
    assert single["n_molecules"] == n and single["mesh"] is None and single["backend"] == "cpu"
    assert set(single) == {"n_molecules", "batch", "conformers", "mesh", "backend", "gen_s",
                           "warmup_s", "eval_epoch_s", "molecules_per_s", "val_loss"}
    scale = float(np.abs(jpred).max())
    assert float(np.abs(pred - jpred).max()) <= EVAL_RTOL * scale
    assert abs(single["val_loss"] - jloss) <= EVAL_RTOL * abs(jloss)
    ranked, pred2 = eval_geom_scale.run_mesh(n, ranks=2, state_dict=state, batch=batch)
    assert ranked["mesh"] == "2-device" and ranked["n_molecules"] == n
    # the same records in the same order; a rank's two rows round apart
    # from the four of one process's batch (CPU products of other shapes)
    assert float(np.abs(pred2 - pred).max()) <= RANKS_RTOL * scale
    assert abs(ranked["val_loss"] - single["val_loss"]) <= RANKS_RTOL * abs(single["val_loss"])


def jax_tree_to_numpy(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- synthetic_e2e
def test_synthetic_e2e_two_stages_on_the_cpu(tmp_path, caplog):
    data = synthetic_e2e.datasets(8, "cpu")
    full = jrandom_dataset(123, 68, num_conformers=3, heavy_range=(4, 9))
    assert [r.y for r in data["train"] + data["valid"] + data["test"]] == [r.y for r in full]
    assert [len(data[m]) for m in ("train", "valid", "test")] == [8, 30, 30]
    caplog.set_level("INFO", logger="conan_fgw_tpu_torch")
    out, printed = _quiet(synthetic_e2e.main, ["--device", "cpu", "--epochs", "1", "--size", "8",
                                               "--models_dir", str(tmp_path / "models")])
    for stage in ("stage1", "stage2"):
        summary, runs = out[stage]
        assert np.isfinite(summary["test_rmse"]["mean"])
        assert all(np.isfinite(r["train_loss"]) for r in runs[0]["history"])
    assert "warm-started run 0" in caplog.text
    assert "stage-2 test RMSE" in printed and "target std" in printed


def test_tools_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        eval_geom_scale.main(["--n", "4"])
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_e2e.main(["--epochs", "1", "--size", "4", "--models_dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tregistry.get_model("schnet")
