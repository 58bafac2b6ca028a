"""The port's checkpoints on the CPU: the ``best``/``last``/``last_state``
round trip with Adam's state, exact resume (2 epochs plus a resume to 3
equals 3 epochs, bit for bit), the errors a bad restore raises, and the
reader of the JAX package's parameter checkpoints."""

import json

import jax
import numpy as np
import pytest
import torch

from conan_fgw_tpu.train.checkpoints import _save_pytree
from conan_fgw_tpu_torch.convert import params_from_flax, state_dict_from_flax_checkpoint
from conan_fgw_tpu_torch.data.synthetic import random_dataset
from conan_fgw_tpu_torch.data.packing import pack_batch
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import runner as trunner
from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer, find_pre_stage_dir
from conan_fgw_tpu_torch.train.config import load_config
from test_torch_model import SMALL, make_pair
from test_torch_runner import tiny_dataset, write_config

TIMES = ("train_s", "epoch_time_s", "queue_wait_s", "pack_s", "slot_wait_s", "replay_s")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """These shapes are small: one CPU thread runs them about as fast as
    many, and keeps the file from fighting other test workers for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trained(stage: int, steps: int = 2):
    """A small model and its Adam after ``steps`` steps (stage 2 runs the
    barycenter branch; stage 1 leaves its head without Adam state)."""
    model = ConanModel(device="cpu", seed=1, **SMALL)
    settings = tloop.TrainSettings(use_barycenter=stage == 2, batch_size=4)
    opt = tloop.make_optimizer(model, settings)
    batch = pack_batch(random_dataset(2, 4, num_conformers=2, heavy_range=(4, 7), device="cpu"),
                       max_atoms=32).to("cpu")
    for _ in range(steps):
        tloop.train_step(model, opt, batch, settings)
    return model, opt, batch, settings


@pytest.mark.parametrize("stage", [1, 2])
def test_round_trip_with_adam_state(tmp_path, stage):
    model, opt, batch, settings = _trained(stage)
    ck = RunCheckpointer(str(tmp_path / "run"))
    assert not ck.has("best")
    ck.save_best(model, 3, {"val_mse": 0.5})
    ck.save_last(model, 4)
    ck.save_state(model, opt, 4, {"lr": 1e-3, "history": [{"epoch": 4}]})
    assert all(ck.has(n) for n in ("best", "last", "last_state"))
    assert json.loads((tmp_path / "run/best.meta.json").read_text()) == {
        "epoch": 3, "metrics": {"val_mse": 0.5}}

    other = _trained(stage, steps=0)[0]
    for which in ("best", "last"):
        ck.restore_params(other, which)
        for k, v in model.state_dict().items():
            assert torch.equal(other.state_dict()[k], v), (which, k)
    other2, opt2, _, _ = _trained(stage, steps=0)
    meta = ck.restore_state(other2, opt2)
    assert meta == {"epoch": 4, "loop": {"lr": 1e-3, "history": [{"epoch": 4}]}}
    with_state = [n for n, p in model.named_parameters() if opt.state.get(p)]
    assert with_state == [n for n, p in other2.named_parameters() if opt2.state.get(p)]
    if stage == 1:
        assert "tbary.weight" not in with_state
    for (n, p), q in zip(model.named_parameters(), other2.parameters()):
        for key in ("step", "exp_avg", "exp_avg_sq") if n in with_state else ():
            assert torch.equal(opt.state[p][key], opt2.state[q][key]), (n, key)
    # one more step on each: the same update, bit for bit
    tloop.train_step(model, opt, batch, settings)
    tloop.train_step(other2, opt2, batch, settings)
    for k, v in model.state_dict().items():
        assert torch.equal(other2.state_dict()[k], v), k


def test_bad_restores_raise(tmp_path):
    model, opt, _, _ = _trained(1, steps=1)
    ck = RunCheckpointer(str(tmp_path))
    ck.save_best(model, 0)
    with pytest.raises(ValueError, match="shape"):
        ck.restore_params(ConanModel(device="cpu", **{**SMALL, "hidden_channels": 16}))
    with np.load(tmp_path / "best.npz") as d:
        arrays = {k: d[k] for k in d.files if k != "head.bias"}
    np.savez(tmp_path / "best.npz", **arrays)
    with pytest.raises(ValueError, match="missing 1 entries"):
        ck.restore_params(model)
    ck.save_state(model, opt, 0)
    with np.load(tmp_path / "last_state.npz") as d:
        arrays = {k: d[k] for k in d.files if k != "adam/head.bias/exp_avg_sq"}
    np.savez(tmp_path / "last_state.npz", **arrays)
    with pytest.raises(ValueError, match="incomplete"):
        ck.restore_state(model, opt)
    with pytest.raises(FileNotFoundError):
        ck.restore_params(model, "last")


@pytest.mark.parametrize("stage", [trunner.STAGE_PRE, trunner.STAGE_BC])
def test_resume_is_exact(tmp_path, stage):
    """3 epochs in one go against 2 epochs and a resume to 3: the same
    history (times aside) and bit-identical checkpoints."""
    root = tiny_dataset(tmp_path)
    kind = "pre" if stage == trunner.STAGE_PRE else "bc"
    runs = {}
    for name, plan in (("straight", (3,)), ("resumed", (2, 3))):
        for i, epochs in enumerate(plan):
            cfg = load_config(write_config(tmp_path, f"{name}{epochs}.yaml", kind, epochs=epochs))
            _, per_run = trunner.run_experiment(
                cfg, stage=stage, data_dir=str(root / "data"), run_name=name,
                models_dir=str(tmp_path / "models"), resume=i > 0, allow_scratch=True,
                device="cpu")
        runs[name] = per_run[0]
    strip = [{k: v for k, v in row.items() if k not in TIMES and not k.startswith("train_s_n")}
             for row in runs["straight"]["history"]]
    assert [r["epoch"] for r in runs["resumed"]["history"]] == [0, 1, 2]
    assert strip == [{k: v for k, v in row.items() if k not in TIMES
                      and not k.startswith("train_s_n")} for row in runs["resumed"]["history"]]
    assert runs["straight"]["metrics"] == runs["resumed"]["metrics"]
    for which in ("best", "last", "last_state"):
        with np.load(tmp_path / f"models/straight/0/run_{stage}:0/{which}.npz") as a, \
                np.load(tmp_path / f"models/resumed/0/run_{stage}:0/{which}.npz") as b:
            assert a.files == b.files
            for k in a.files:
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{which} {k}")


def test_find_pre_stage_dir():
    assert find_pre_stage_dir("m", "r", "1", 2) == "m/r/1/run_conan_fgw_pre:2"


def test_flax_checkpoint_reader(tmp_path):
    """A parameter checkpoint written by the JAX package's checkpointer
    reads into the same state dict as ``params_from_flax`` gives."""
    _, params, _, _, _ = make_pair()
    _save_pytree(str(tmp_path / "best"), params)
    got = state_dict_from_flax_checkpoint(str(tmp_path / "best.npz"))
    want = params_from_flax(jax.tree.map(np.asarray, params))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ConanModel(device="cpu", **SMALL).load_state_dict(got)
    np.savez(tmp_path / "odd.npz", **{"params/head/bias": np.zeros(1)})
    with pytest.raises(KeyError, match="not a flax parameter path"):
        state_dict_from_flax_checkpoint(str(tmp_path / "odd.npz"))
