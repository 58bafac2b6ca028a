"""The port's two-stage runner, on the CPU: against the JAX runner from one
stage-1 checkpoint, through its CLI with ``predict``, and its refusals.

The data is a tiny dataset written from ``data/sol250``: 20 molecules of at
most 32 atoms (12 train, 4 valid, 4 test) with their 10-conformer stores,
K=2, batch 4, 2 epochs, one bucket (N=32), the flagship model at full width.

Runner against runner: the JAX runner trains stage 1; its ``best.npz`` goes
through ``state_dict_from_flax_checkpoint`` into the port's stage-1
directory; both runners then run stage 2 from it. The per-epoch
``train_loss``/``val_mse``/``val_loss`` and ``test_rmse`` must agree to 1e-4
relative in the first epoch and 1e-3 after it (the step parity bound of
``chip_smoke.py``). Found when this was written: 1.3e-7 to 6.6e-6 relative
over the two epochs, and 1.7e-5 in ``test_rmse``."""

import json
import logging
import os
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from conan_fgw_tpu.train import runner as jrunner
from conan_fgw_tpu.train.config import load_config as jload
from conan_fgw_tpu_torch.convert import state_dict_from_flax_checkpoint
from conan_fgw_tpu_torch.data import smiles as tsmi
from conan_fgw_tpu_torch.data.conformers import store_path
from conan_fgw_tpu_torch.data.datasets import read_csv_rows, write_csv
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.train import predict as tpredict
from conan_fgw_tpu_torch.train import runner as trunner
from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer
from conan_fgw_tpu_torch.train.config import load_config as tload

SOL250 = Path(__file__).resolve().parents[1] / "data" / "sol250"
FIRST_RTOL, LATER_RTOL = 1e-4, 1e-3
CONFIG = """dataset_name: ['tiny']
target: ['logS_surrogate']
num_conformers: 2
batch_size: 4
experiment: {experiment}
num_epochs: {epochs}
early_stopping: {{min_delta: 0.0001, patience: 50}}
learning_rate: {lr}
model_name: schnet
scan_chunk: 0
{extra}"""


def write_config(root: Path, name: str, stage: str, epochs: int = 2, extra: str = "") -> str:
    experiment, lr = ("regression", "0.001") if stage == "pre" else ("regression_bc", "0.0005")
    path = root / name
    path.write_text(CONFIG.format(experiment=experiment, epochs=epochs, lr=lr, extra=extra))
    return str(path)


def tiny_dataset(root: Path) -> Path:
    """``root/data/tiny``: the first 20 sol250 training molecules of at most
    32 atoms with their conformer stores; returns ``root``."""
    rows = [r for r in read_csv_rows(str(SOL250 / "train.csv"), "logS_surrogate")
            if tsmi.add_hydrogens(tsmi.parse_smiles(r["smiles"])).num_atoms <= 32][:20]
    for mode, part in (("train", rows[:12]), ("valid", rows[12:16]), ("test", rows[16:])):
        out = root / "data" / "tiny"
        write_csv(str(out / f"{mode}.csv"), part, target="logS_surrogate")
        os.makedirs(out / f"conformers_{mode}", exist_ok=True)
        for r in part:
            shutil.copy(store_path(str(SOL250 / "conformers_train"), r["mol_id"]),
                        store_path(str(out / f"conformers_{mode}"), r["mol_id"]))
    return root


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_dataset(tmp_path_factory.mktemp("tiny"))


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """These shapes are small: one CPU thread runs them about as fast as
    many, and keeps the file from fighting other test workers for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, rtol, what):
    assert abs(got - want) <= rtol * abs(want), f"{what}: port {got} JAX {want}"


def test_stage2_matches_the_jax_runner(tiny, tmp_path):
    data = str(tiny / "data")
    pre, bc = write_config(tmp_path, "pre.yaml", "pre"), write_config(tmp_path, "bc.yaml", "bc")
    jmodels, tmodels = tmp_path / "jax_models", tmp_path / "port_models"
    common = dict(data_dir=data, run_name="t", run_id="1")
    jrunner.run_experiment(jload(pre), stage=jrunner.STAGE_PRE, models_dir=str(jmodels), **common)

    state = state_dict_from_flax_checkpoint(str(jmodels / "t/1/run_conan_fgw_pre:0/best.npz"))
    model = ConanModel(device="cpu")
    model.load_state_dict(state)
    RunCheckpointer(str(tmodels / "t/1/run_conan_fgw_pre:0")).save_best(model, 0)

    _, jruns = jrunner.run_experiment(jload(bc), stage=jrunner.STAGE_BC,
                                      models_dir=str(jmodels), **common)
    _, truns = trunner.run_experiment(tload(bc), stage=trunner.STAGE_BC,
                                      models_dir=str(tmodels), device="cpu", **common)
    jh, th = jruns[0]["history"], truns[0]["history"]
    assert [r["epoch"] for r in th] == [r["epoch"] for r in jh] == [0, 1]
    for jrow, trow in zip(jh, th):
        rtol = FIRST_RTOL if trow["epoch"] == 0 else LATER_RTOL
        for key in ("train_loss", "val_mse", "val_loss"):
            _close(trow[key], jrow[key], rtol, f"epoch {trow['epoch']} {key}")
        assert trow["fgw_diverged"] == jrow["fgw_diverged"]
        assert trow["steps_n32"] == trow["train_steps"] == 3
    _close(truns[0]["metrics"]["test_rmse"], jruns[0]["metrics"]["test_rmse"], LATER_RTOL,
           "test_rmse")
    assert truns[0]["metrics"]["best_epoch"] == jruns[0]["metrics"]["best_epoch"]


def _cli(root: Path, config: str, stage: str, *extra: str) -> list[str]:
    return ["--config", config, "--stage", stage, "--data_root", str(root), "--run_name", "cli",
            "--run_id", "1", "--models_dir", str(root / "models"), "--logs_dir",
            str(root / "logs"), "--metrics_dir", str(root / "metrics"), "--device", "cpu", *extra]


def test_cli_two_stages_then_predict(tiny, tmp_path, caplog):
    pre, bc = write_config(tmp_path, "pre.yaml", "pre"), write_config(tmp_path, "bc.yaml", "bc")
    root = tmp_path / "run"
    shutil.copytree(tiny / "data", root / "data")
    with pytest.raises(FileNotFoundError, match="no stage-1 best checkpoint"):
        trunner.main(_cli(root, bc, "conan_fgw"))
    trunner.main(_cli(root, pre, "conan_fgw_pre"))
    stage1 = root / "models/cli/1/run_conan_fgw_pre:0"
    assert all((stage1 / f"{n}.npz").exists() for n in ("best", "last", "last_state"))
    out = tmp_path / "summary.json"
    with caplog.at_level(logging.INFO, logger="conan_fgw_tpu_torch"):
        trunner.main(_cli(root, bc, "conan_fgw", "--out_json", str(out), "--eval_guard"))
    assert f"warm-started run 0 from {stage1}" in caplog.text
    summary = json.loads(out.read_text())
    assert np.isfinite(summary["test_rmse"]["mean"]) and summary["test_rmse"]["n"] == 1
    assert summary["test_pred_outliers"]["n"] == 1  # --eval_guard reached evaluate
    rows = (root / "metrics/cli/1/run_conan_fgw:0/metrics.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].startswith("epoch,train_loss,lr,fgw_diverged")

    stage2 = root / "models/cli/1/run_conan_fgw:0"
    preds, emb = tmp_path / "preds.csv", tmp_path / "emb.npz"
    rmse = tpredict.main(["--config", bc, "--checkpoint", str(stage2), "--data_root", str(root),
                          "--out", str(preds), "--embeddings", str(emb), "--device", "cpu"])
    assert rmse == summary["test_rmse"]["mean"]
    assert len(preds.read_text().splitlines()) == 5
    with np.load(emb) as e:
        assert e["x3d"].shape == (4, 2, 64) and e["x_bary"].shape == e["x_cov"].shape == (4, 64)
        assert list(e["mol_id"]) == [line.split(",")[0] for line in preds.read_text().splitlines()[1:]]


def test_allow_scratch_trains_stage2_without_stage1(tiny, tmp_path, caplog):
    bc = write_config(tmp_path, "bc.yaml", "bc", epochs=1)
    with caplog.at_level(logging.WARNING, logger="conan_fgw_tpu_torch"):
        summary = trunner.main(_cli(tiny, bc, "conan_fgw", "--allow_scratch", "--models_dir",
                                    str(tmp_path / "models"), "--profile_dir",
                                    str(tmp_path / "trace")))
    assert "training from scratch" in caplog.text
    assert np.isfinite(summary["test_rmse"]["mean"])
    # --profile_dir: a Chrome trace of the fit
    assert json.loads((tmp_path / "trace/run0/trace.json").read_text())["traceEvents"]


def test_lr_finder_sets_the_learning_rate(tiny, tmp_path, caplog):
    pre = write_config(tmp_path, "pre.yaml", "pre", epochs=1, extra="use_lr_finder: true\n")
    with caplog.at_level(logging.INFO, logger="conan_fgw_tpu_torch"):
        trunner.main(_cli(tiny, pre, "conan_fgw_pre", "--models_dir", str(tmp_path / "models")))
    suggestion = float(caplog.text.split("lr finder suggestion: ")[1].split()[0])
    assert 1e-6 <= suggestion <= 1.0
    assert f"lr={suggestion:.2e}" in caplog.text  # the epoch ran at the suggested rate


@pytest.mark.parametrize("extra", [
    "experiment_override: gat_only",
    "experiment_override: esan_avg_conf",
    "experiment_override: conan_fgw.src.experiments.SOTAClassificationGEOMExperiment",
    "experiment_override: conan_fgw.src.experiments.DimeNetGEOMExperiment",
    "compute_dtype: bfloat16",
])
def test_what_the_port_lacks_raises(tiny, tmp_path, extra):
    key, value = extra.split(": ")
    text = Path(write_config(tmp_path, "c.yaml", "pre")).read_text()
    if key == "experiment_override":
        text = text.replace("experiment: regression", f"experiment: {value}")
    else:
        text += f"{extra}\n"
    (tmp_path / "c.yaml").write_text(text)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trunner.main(_cli(tiny, str(tmp_path / "c.yaml"), "conan_fgw_pre"))


@pytest.mark.parametrize("flags", [["--num_devices", "2"], ["--distributed"]])
def test_data_parallel_flags_raise(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trunner.main(_cli(tmp_path, write_config(tmp_path, "c.yaml", "pre"), "conan_fgw_pre",
                          *flags))


@pytest.mark.parametrize("key", ["use_pallas_cfconv", "use_pallas_fgw"])
def test_plain_versions_are_refused_on_the_card(tmp_path, key):
    cfg = tload(write_config(tmp_path, "c.yaml", "bc", extra=f"{key}: false\n"))
    trunner.check_supported(cfg, torch.device("cpu"))  # the CPU runs the plain versions
    with pytest.raises(ValueError, match=key):
        trunner.check_supported(cfg, torch.device("cuda"))


def test_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    cfg = write_config(tmp_path, "c.yaml", "pre")
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.main(["--config", cfg, "--logs_dir", str(tmp_path / "logs")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tpredict.main(["--config", cfg, "--checkpoint", str(tmp_path)])


def test_lr_finder_leaves_the_model_alone(tiny):
    from conan_fgw_tpu_torch.data.datasets import ConformerDataset
    from conan_fgw_tpu_torch.train.loop import TrainSettings
    from conan_fgw_tpu_torch.train.lr_finder import lr_find

    recs = ConformerDataset("train", str(tiny / "data"), "tiny", "logS_surrogate", 2).records()
    model = ConanModel(device="cpu", hidden_channels=32, num_filters=32, num_gaussians=10,
                       num_interactions=2)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    found = lr_find(model, TrainSettings(batch_size=4), recs, num_steps=8, device="cpu")
    assert 1e-6 <= found["suggestion"] <= 1.0 and len(found["losses"]) == len(found["lrs"])
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


def test_embeddings_match_flax():
    """``ConanModel.embeddings`` against the flax model's ``embeddings``
    under the same weights (tolerances of ``test_torch_model.py``: the 3D
    and 2D readouts 1e-4, the barycenter readout 1e-3)."""
    import jax

    from test_torch_model import ATOL, STAGE1_RTOL, STAGE2_RTOL, make_pair

    jmodel, params, jbatch, tmodel, tbatch = make_pair()
    want, _ = jmodel.apply(params, jbatch, method="embeddings", mutable=["diagnostics"])
    with torch.no_grad():
        got = tmodel.embeddings(tbatch)
    for key, rtol in (("x3d", STAGE1_RTOL), ("x_cov", STAGE1_RTOL), ("x_bary", STAGE2_RTOL)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(jax.device_get(want[key])),
                                   rtol=rtol, atol=ATOL, err_msg=key)
