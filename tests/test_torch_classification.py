"""Port parity of the classification path against the JAX package, on the
CPU: ``SelfAttention``, ``ClassificationHead``, the classification
``ConanModel`` (stages 1 and 2), one train step with the scaled logit BCE,
the flax tree and checkpoint conversion, the cfconv's plain version at the
classification width (256 filters, 10 Gaussians), ``evaluate``'s
single-class fallback, the ``*_class_*`` configs, and the runner's stage 2
from one JAX stage-1 checkpoint on a few ``data/sol1k_class`` molecules.

Inputs are made with numpy from a seed. Tolerances: attention and head
rtol 1e-5; the model rtol 1e-4 in stage 1 and 1e-3 in stage 2 (the
barycenter's bound), as ``tests/test_torch_model.py``; the train step's
loss and each gradient in norm 1e-4, as ``tests/test_torch_train.py``; the
cfconv 5e-4 with a 1e-5 floor, the kernel contract; the runner 1e-4
relative in the first epoch and 1e-3 after it, as
``tests/test_torch_runner.py`` (found when this was written: losses 1.6e-7
to 3.5e-6 relative, AUROC and PRC-AUC equal to the JAX runner's)."""

import dataclasses
import glob
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.data.packing import PackedBatch as JBatch
from conan_fgw_tpu.data.packing import pack_batch as jpack
from conan_fgw_tpu.data.synthetic import random_dataset as jdataset
from conan_fgw_tpu.models.attention import SelfAttention as JSelfAttention
from conan_fgw_tpu.models.heads import ClassificationHead as JHead
from conan_fgw_tpu.models.heads import ConanModel as JConan
from conan_fgw_tpu.ops.pallas.cfconv import _cfconv_xla, fused_cfconv
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu.train import runner as jrunner
from conan_fgw_tpu.train.checkpoints import _save_pytree
from conan_fgw_tpu.train.config import load_config as jload
from conan_fgw_tpu_torch.convert import params_from_flax, state_dict_from_flax_checkpoint
from conan_fgw_tpu_torch.data import smiles as tsmi
from conan_fgw_tpu_torch.data.conformers import store_path
from conan_fgw_tpu_torch.data.datasets import read_csv_rows, write_csv
from conan_fgw_tpu_torch.data.packing import pack_batch as tpack
from conan_fgw_tpu_torch.data.synthetic import random_dataset as tdataset
from conan_fgw_tpu_torch.models.attention import SelfAttention
from conan_fgw_tpu_torch.models.heads import ClassificationHead, ConanModel
from conan_fgw_tpu_torch.ops.cuda.cfconv import _cfconv_plain
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import runner as trunner
from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer
from conan_fgw_tpu_torch.train.config import load_config as tload

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(hidden_channels=32, num_filters=32, num_gaussians=10, num_interactions=2)
LAYER_RTOL, STAGE1_RTOL, STAGE2_RTOL, STEP_RTOL, ATOL = 1e-5, 1e-4, 1e-3, 1e-4, 1e-5
CFCONV_RTOL, CFCONV_ATOL = 5e-4, 1e-5
FIRST_RTOL, LATER_RTOL = 1e-4, 1e-3
LABELS = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
LOSS_SCALE = 2.5


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One CPU thread runs these shapes about as fast as many and keeps the
    file from fighting other test workers for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _dense(params, i):
    return {"weight": torch.tensor(np.asarray(params[f"Dense_{i}"]["kernel"]).T),
            "bias": torch.tensor(np.asarray(params[f"Dense_{i}"]["bias"]))}


@pytest.mark.parametrize("length", [1, 3])
def test_self_attention_matches_flax(length):
    rng = np.random.default_rng(length)
    x = rng.standard_normal((2, 3, length, 16)).astype(np.float32)
    jmod = JSelfAttention(16)
    params = jmod.init(jax.random.PRNGKey(length), jnp.asarray(x))["params"]
    # non-zero biases, so that the test sees them
    params = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = SelfAttention(16)
    for i, lin in enumerate(tmod.qkv):
        lin.load_state_dict(_dense(params, i))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LAYER_RTOL, atol=1e-6)


def test_classification_head_matches_flax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((6, 16)).astype(np.float32)
    jmod = JHead(16)
    params = jmod.init(jax.random.PRNGKey(5), jnp.asarray(x))["params"]
    params = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    want = jmod.apply({"params": params}, jnp.asarray(x))
    tmod = ClassificationHead(16)
    for i, lin in enumerate(tmod.lins):
        lin.load_state_dict(_dense(params, i))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))
    assert got.shape == (6, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LAYER_RTOL, atol=1e-6)


def make_pair(pad_mode="reference", seed=0, batch_seed=7, heavy=(4, 9)):
    """A flax classification model with its parameters and the port's model
    holding the same weights, plus one batch with 0/1 labels in both forms."""
    pb = jpack(jdataset(batch_seed, 4, num_conformers=2, heavy_range=heavy), max_atoms=32,
               batch_size=4)
    pb = dataclasses.replace(pb, y=LABELS.copy())
    jbatch = JBatch(**jax.tree.map(jnp.asarray, dataclasses.asdict(pb)))
    jmodel = JConan(task="classification", bary_pad_mode=pad_mode, **SMALL)
    params = jmodel.init(jax.random.PRNGKey(seed), jbatch, use_barycenter=True)
    params = {k: v for k, v in params.items() if k != "diagnostics"}
    tmodel = ConanModel(task="classification", bary_pad_mode=pad_mode, device="cpu", **SMALL)
    tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    tpb = tpack(tdataset(batch_seed, 4, num_conformers=2, heavy_range=heavy, device="cpu"),
                max_atoms=32, batch_size=4)
    tbatch = dataclasses.replace(tpb, y=LABELS.copy()).to("cpu")
    return jmodel, params, jbatch, tmodel, tbatch


def test_params_from_flax_maps_every_classification_leaf(tmp_path):
    _, params, _, tmodel, _ = make_pair()
    state = params_from_flax(jax.tree.map(np.asarray, params))
    assert len(state) == len(jax.tree.leaves(params)) == len(tmodel.state_dict())
    assert {"head.lins.2.weight", "self_attention.qkv.0.bias"} <= state.keys()
    # a JAX classification checkpoint file loads with no unmapped leaf
    _save_pytree(str(tmp_path / "best"), params)
    got = state_dict_from_flax_checkpoint(str(tmp_path / "best.npz"))
    assert got.keys() == state.keys()
    ConanModel(task="classification", device="cpu", **SMALL).load_state_dict(got)


@pytest.mark.parametrize("stage,pad_mode", [(1, "reference"), (2, "reference"), (2, "masked")])
def test_forward_matches_flax(stage, pad_mode):
    jmodel, params, jbatch, tmodel, tbatch = make_pair(pad_mode)
    bary = stage == 2
    out_j, _ = jmodel.apply(params, jbatch, use_barycenter=bary, mutable=["diagnostics"])
    with torch.no_grad():
        out_t, _ = tmodel(tbatch, use_barycenter=bary)
    rtol = STAGE2_RTOL if bary else STAGE1_RTOL
    assert out_t.shape == (4, 1)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("stage", [1, 2])
def test_train_step_matches_jax(stage):
    jmodel, params, jbatch, tmodel, tbatch = make_pair(batch_seed=11)
    bary = stage == 2
    js = jloop.TrainSettings(task="classification", loss_scale=LOSS_SCALE, use_barycenter=bary)
    (loss_j, _), grads_j = jax.value_and_grad(jloop.make_loss_fn(jmodel, js), has_aux=True)(
        params, jbatch)
    ts = tloop.TrainSettings(task="classification", loss_scale=LOSS_SCALE, use_barycenter=bary)
    pred, _ = tmodel(tbatch, use_barycenter=bary)
    loss_t = tloop.task_loss(pred, tbatch, ts)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=STEP_RTOL)
    gj = params_from_flax(jax.tree.map(np.asarray, grads_j))
    for name, p in tmodel.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad  # unused branch: zeros in JAX
        diff = np.linalg.norm(g.numpy() - gj[name].numpy())
        assert diff <= STEP_RTOL * np.linalg.norm(gj[name].numpy()) + 1e-9, name
    # the attention gets a gradient in stage 1 only, the barycenter head in stage 2 only
    assert (tmodel.self_attention.qkv[2].weight.grad is None) == bary
    assert (tmodel.tbary.weight.grad is None) == (not bary)


def test_bce_is_the_stable_logit_form():
    pred = torch.tensor([[-80.0], [0.0], [3.0], [80.0]])
    batch = dataclasses.make_dataclass("B", ["y", "mol_mask"])(
        torch.tensor([1.0, 0.0, 1.0, 0.0]), torch.tensor([True, True, True, False]))
    got = tloop.masked_bce(pred, batch, 2.0)
    want = 2.0 * (80.0 + np.log(2.0) + np.log1p(np.exp(-3.0))) / 3
    assert abs(float(got) - want) <= 1e-5 * want


def _cfconv_problem(g, n, seed, f=256, gauss=10):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((g, n, 3)).astype(np.float32) * 2.0
    mask = np.ones((g, n), np.float32)
    mask[:, n - 3:] = 0.0
    pos[:, n - 3:] += 1e4
    x = rng.standard_normal((g, n, f)).astype(np.float32)
    w1 = (rng.standard_normal((gauss, f)) * (6 / (gauss + f)) ** 0.5).astype(np.float32)
    b1 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((f, f)) * (3 / f) ** 0.5).astype(np.float32)
    b2 = (rng.standard_normal(f) * 0.1).astype(np.float32)
    cot = rng.standard_normal((g, n, f)).astype(np.float32)
    return (pos, mask, x, w1, b1, w2, b2), cot


@pytest.mark.parametrize("n", [32, 64])
def test_cfconv_at_the_classification_width_matches_xla(n):
    """256 filters, 10 Gaussians, cap 32 (active at N=64): the plain version
    and its gradients against the JAX package's XLA formulation, which the
    JAX model runs at N=64 (its VMEM gate) and which equals its Pallas
    kernel at N=32."""
    args, cot = _cfconv_problem(2, n, seed=n)
    pos, mask = (jnp.asarray(a) for a in args[:2])

    def jloss(x, w1, b1, w2, b2):
        out = _cfconv_xla(pos, mask, x, w1, b1, w2, b2, cutoff=10.0, num_gaussians=10,
                          max_neighbors=32)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, out_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in args[2:]))
    t = [torch.from_numpy(a) for a in args]
    for a in t[2:]:
        a.requires_grad_(True)
    out_t = _cfconv_plain(*t, 10.0, 10, 32)
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=CFCONV_RTOL,
                               atol=CFCONV_ATOL)
    for name, a, gj in zip(("x", "w1", "b1", "w2", "b2"), t[2:], grads_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(gj), rtol=CFCONV_RTOL,
                                   atol=CFCONV_ATOL, err_msg=f"grad {name}")


def test_cfconv_at_the_classification_width_matches_pallas_interpret():
    args, _ = _cfconv_problem(2, 16, seed=3)
    out_p = fused_cfconv(*(jnp.asarray(a) for a in args), 10.0, 10, 6)
    out_t = _cfconv_plain(*(torch.from_numpy(a) for a in args), 10.0, 10, 6)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_p), rtol=CFCONV_RTOL, atol=CFCONV_ATOL)


@pytest.mark.parametrize("label", [0.0, 1.0])
def test_evaluate_reports_half_on_a_single_class_split(label):
    recs = tdataset(5, 4, num_conformers=2, heavy_range=(4, 7), device="cpu")
    recs = [dataclasses.replace(r, y=label) for r in recs]
    model = ConanModel(task="classification", device="cpu", **SMALL)
    settings = tloop.TrainSettings(task="classification", trade_off=True, batch_size=4)
    out, pred, _ = tloop.evaluate(model, recs, settings, 32, torch.device("cpu"))
    assert out["auroc"] == out["prc"] == 0.5 and "mean" not in out
    assert pred.shape == (4,) and np.isfinite(out["loss"])


CLASS_CONFIGS = sorted(glob.glob(str(REPO / "config" / "*" / "*_class_*.yaml")))


@pytest.mark.parametrize("path", CLASS_CONFIGS, ids=lambda p: Path(p).stem)
def test_class_configs_load_and_build(path):
    cfg = tload(path)
    assert cfg.spec.task == "classification"
    model = trunner.build_model(cfg, device="cpu")
    assert model.task == "classification"
    assert model.backbone.embedding.weight.shape == (100, 512)
    assert model.backbone.blocks[0].filter_w1.shape == (10, 256)
    assert model.backbone.blocks[0].filter_w2.shape == (256, 256)
    assert model.head.lins[0].weight.shape == (256, 256)
    settings = trunner.build_settings(cfg, trunner.STAGE_BC, loss_scale=3.0)
    want = jrunner.build_settings(jload(path), jrunner.STAGE_BC, loss_scale=3.0)
    assert settings.monitor == want.monitor == ("val_mean" if cfg.trade_off else "val_auroc")
    assert (settings.plateau_patience, settings.plateau_factor) == (5, 0.5)
    assert (settings.plateau_patience, settings.plateau_factor) == (
        want.plateau_patience, want.plateau_factor)
    assert settings.loss_scale == want.loss_scale and settings.trade_off == want.trade_off
    assert settings.use_barycenter == want.use_barycenter


def test_the_eight_configs_with_data_are_among_them():
    with_data = [p for p in CLASS_CONFIGS
                 if (REPO / "data" / tload(p).dataset_name[0]).is_dir()]
    assert len(with_data) == 8


# ---------------------------------------------------------------- runner
SOL1K_CLASS = REPO / "data" / "sol1k_class"
CONFIG = """dataset_name: ['tinyclass']
target: ['Class']
num_conformers: 2
batch_size: 4
experiment: {experiment}
num_epochs: 2
early_stopping: {{min_delta: 0.0001, patience: 40}}
learning_rate: {lr}
model_name: schnet
scan_chunk: 0
"""


@pytest.fixture(scope="module")
def tinyclass(tmp_path_factory):
    """``root/data/tinyclass``: sol1k_class training molecules of at most 32
    atoms with their conformer stores, 12 train, 6 valid and 6 test, each
    split holding both classes; returns ``root``."""
    root = tmp_path_factory.mktemp("tinyclass")
    rows = [r for r in read_csv_rows(str(SOL1K_CLASS / "train.csv"), "Class")
            if tsmi.add_hydrogens(tsmi.parse_smiles(r["smiles"])).num_atoms <= 32]
    pos = [r for r in rows if r["y"] == 1][:10]
    neg = [r for r in rows if r["y"] == 0][:14]
    splits = {"train": pos[:4] + neg[:8], "valid": pos[4:7] + neg[8:11],
              "test": pos[7:10] + neg[11:14]}
    out = root / "data" / "tinyclass"
    for mode, part in splits.items():
        write_csv(str(out / f"{mode}.csv"), part, target="Class")
        os.makedirs(out / f"conformers_{mode}", exist_ok=True)
        for r in part:
            shutil.copy(store_path(str(SOL1K_CLASS / "conformers_train"), r["mol_id"]),
                        store_path(str(out / f"conformers_{mode}"), r["mol_id"]))
    return root


def _close(got, want, rtol, what):
    assert abs(got - want) <= rtol * abs(want) + 1e-12, f"{what}: port {got} JAX {want}"


def test_stage2_matches_the_jax_runner(tinyclass, tmp_path):
    data = str(tinyclass / "data")
    pre, bc = tmp_path / "pre.yaml", tmp_path / "bc.yaml"
    pre.write_text(CONFIG.format(experiment="classification", lr="0.001"))
    bc.write_text(CONFIG.format(experiment="classification_bc", lr="0.0005"))
    jmodels, tmodels = tmp_path / "jax_models", tmp_path / "port_models"
    common = dict(data_dir=data, run_name="t", run_id="1")
    jrunner.run_experiment(jload(str(pre)), stage=jrunner.STAGE_PRE, models_dir=str(jmodels),
                           **common)
    state = state_dict_from_flax_checkpoint(str(jmodels / "t/1/run_conan_fgw_pre:0/best.npz"))
    model = ConanModel(task="classification", hidden_channels=512, num_filters=256,
                       num_gaussians=10, device="cpu")
    model.load_state_dict(state)
    RunCheckpointer(str(tmodels / "t/1/run_conan_fgw_pre:0")).save_best(model, 0)

    _, jruns = jrunner.run_experiment(jload(str(bc)), stage=jrunner.STAGE_BC,
                                      models_dir=str(jmodels), **common)
    _, truns = trunner.run_experiment(tload(str(bc)), stage=trunner.STAGE_BC,
                                      models_dir=str(tmodels), device="cpu", **common)
    jh, th = jruns[0]["history"], truns[0]["history"]
    assert [r["epoch"] for r in th] == [r["epoch"] for r in jh] == [0, 1]
    for jrow, trow in zip(jh, th):
        rtol = FIRST_RTOL if trow["epoch"] == 0 else LATER_RTOL
        for key in ("train_loss", "val_loss", "val_auroc", "val_prc"):
            _close(trow[key], jrow[key], rtol, f"epoch {trow['epoch']} {key}")
        assert trow["fgw_diverged"] == jrow["fgw_diverged"]
    for key in ("test_auroc", "test_prc", "test_loss"):
        _close(truns[0]["metrics"][key], jruns[0]["metrics"][key], LATER_RTOL, key)
    assert truns[0]["metrics"]["best_epoch"] == jruns[0]["metrics"]["best_epoch"]
    assert truns[0]["metrics"]["val_auroc"] == max(r["val_auroc"] for r in th)


def test_cli_two_stages_then_predict_probabilities(tinyclass, tmp_path):
    """The runner's CLI trains both classification stages (``best`` on the
    highest ``val_auroc``); ``predict`` writes probabilities whose AUROC is
    the runner's ``test_auroc``."""
    import csv

    from conan_fgw_tpu_torch.train import metrics as tmetrics
    from conan_fgw_tpu_torch.train import predict as tpredict

    pre, bc = tmp_path / "pre.yaml", tmp_path / "bc.yaml"
    pre.write_text(CONFIG.format(experiment="classification", lr="0.001"))
    bc.write_text(CONFIG.format(experiment="classification_bc", lr="0.0005")
                  + "trade_off: true\n")
    common = ["--data_root", str(tinyclass), "--run_name", "cli", "--run_id", "1",
              "--models_dir", str(tmp_path / "models"), "--logs_dir", str(tmp_path / "logs"),
              "--metrics_dir", str(tmp_path / "metrics"), "--device", "cpu"]
    trunner.main(["--config", str(pre), "--stage", "conan_fgw_pre", *common])
    summary = trunner.main(["--config", str(bc), "--stage", "conan_fgw", *common])
    assert {"test_auroc", "test_prc", "test_mean", "val_mean"} <= summary.keys()
    run = tmp_path / "models/cli/1/run_conan_fgw:0"
    meta = RunCheckpointer(str(run))
    assert meta.has("best")
    preds = tmp_path / "preds.csv"
    tpredict.main(["--config", str(bc), "--checkpoint", str(run), "--data_root", str(tinyclass),
                   "--out", str(preds), "--device", "cpu"])
    with open(preds) as f:
        rows = list(csv.DictReader(f))
    prob = np.array([float(r["prediction"]) for r in rows])
    target = np.array([float(r["target"]) for r in rows]).astype(np.int64)
    assert len(rows) == 6 and np.all((prob > 0) & (prob < 1))
    assert abs(tmetrics.roc_auc(target, prob) - summary["test_auroc"]["mean"]) <= 1e-12
