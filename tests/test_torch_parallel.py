"""Data parallelism in the port (``parallel/``, ``train/loop.py::SplitStep``,
the runner's ``--num_devices`` and ``--distributed``) on the CPU: ranks are
processes over gloo, joined through a ``FileStore`` in a temporary
directory (``mesh.launch``) or through torchrun's environment on localhost.

Tolerances are ``tests/test_torch_train.py``'s: the loss and each gradient
leaf within 1e-4 relative (a leaf in norm), parameters after one Adam step
within 1e-2 * lr; the runner's ``test_rmse`` within 2e-3 relative, the JAX
package's own bound for its data-parallel CLI (``tests/test_cli.py``).
The ranks of one run must agree bit for bit."""

import dataclasses
import functools
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from conan_fgw_tpu.data.packing import PackedBatch as JBatch
from conan_fgw_tpu.parallel.mesh import create_mesh as jax_mesh
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu_torch.convert import params_from_flax
from conan_fgw_tpu_torch.data import loader, native
from conan_fgw_tpu_torch.data.loader import bucketed_batches
from conan_fgw_tpu_torch.data.packing import pack_batch
from conan_fgw_tpu_torch.data.synthetic import random_dataset
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.ops.cuda import _build
from conan_fgw_tpu_torch.parallel import mesh as mesh_lib
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import runner as trunner
from conan_fgw_tpu_torch.train.lr_finder import lr_find
from conan_fgw_tpu_torch.train.predict import predict_records
import torch_parallel_ranks as ranks_lib
from test_torch_model import SMALL, make_pair
from test_torch_runner import tiny_dataset, write_config
from torch_parallel_ranks import CASES, LR

ROOT = Path(__file__).resolve().parents[1]
RTOL, RMSE_RTOL = 1e-4, 2e-3
FIELDS = [f.name for f in dataclasses.fields(JBatch)]


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One torch thread here and in each rank (``launch`` shares this
    process's threads out), so that the ranks do not fight for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cpu_mesh(rank: int, world: int) -> mesh_lib.Mesh:
    """A mesh for the pure functions (``row_block`` and the packers)."""
    return mesh_lib.Mesh(rank, world, torch.device("cpu"), "gloo", None, None)


# (a) ------------------------------------------------------------------------
@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_rank_blocks_concatenate_to_the_batch(world):
    """Every global batch (both buckets, the batch of 6 padded up to a
    multiple of the ranks as the JAX runner pads it) is, byte for byte, its
    ranks' ``shard_batch`` blocks concatenated, and each rank's
    ``rank_packer`` block, native or numpy, is its ``shard_batch`` block,
    an all-padding block included, with the global batch's real rows."""
    recs = random_dataset(3, 13, num_conformers=2, heavy_range=(3, 25), device="cpu")
    batch_size = -(-6 // world) * world
    buckets = (32, 64)
    whole = list(bucketed_batches(recs, batch_size, buckets, pack=pack_batch))
    empty_blocks = 0
    for rank in range(world):
        m = _cpu_mesh(rank, world)
        for native_pack in (True, False):
            pack = mesh_lib.rank_packer(functools.partial(loader.pack, native=native_pack), m)
            for g, pb in zip(whole, bucketed_batches(recs, batch_size, buckets, pack=pack),
                             strict=True):
                want = mesh_lib.shard_batch(g, m)
                for name in FIELDS:
                    assert getattr(pb, name).tobytes() == getattr(want, name).tobytes(), name
                assert pb.global_rows == int(g.mol_mask.sum())
                empty_blocks += not pb.mol_mask.any()
    for g in whole:
        blocks = [mesh_lib.shard_batch(g, _cpu_mesh(r, world)) for r in range(world)]
        for name in FIELDS:
            joined = np.concatenate([getattr(b, name) for b in blocks])
            assert joined.tobytes() == getattr(g, name).tobytes(), name
    assert empty_blocks > 0 or world < 3  # the last batches leave whole blocks of padding
    with pytest.raises(ValueError, match="multiple"):
        mesh_lib.row_block(5, 0, 2)


# (b)-(d): one launch of two ranks serves every case ---------------------------
@pytest.fixture(scope="module")
def pair():
    assert ranks_lib.SMALL == SMALL  # the ranks build make_pair's model
    return make_pair(batch_seed=11)


@pytest.fixture(scope="module")
def ranks(pair):
    state = params_from_flax(jax.tree.map(np.asarray, pair[1]))
    return mesh_lib.launch(ranks_lib.rank_worker, 2, state, backend="gloo", device="cpu")


def _grads(flat: np.ndarray, model) -> dict:
    """The per-parameter gradients in a ``SplitStep`` buffer: the
    parameters with a gradient, in order, then the loss and ``n_div``."""
    named = [(k, p) for k, p in model.named_parameters() if p.grad is not None]
    out, at = {}, 0
    for k, p in named:
        out[k] = flat[at: at + p.numel()].reshape(p.shape)
        at += p.numel()
    assert at + 2 == flat.size
    return out


def _single_step(pair, bary, n_real):
    """One port train step in one process on the global batch: the loss,
    the gradients before the clip and the weights after Adam."""
    model = ConanModel(device="cpu", **SMALL)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, pair[1])))
    settings = tloop.TrainSettings(use_barycenter=bary, learning_rate=LR, batch_size=4)
    opt = tloop.make_optimizer(model, settings)
    batch = ranks_lib.global_batch(n_real).to("cpu")
    opt.zero_grad(set_to_none=True)
    pred, _ = model(batch, use_barycenter=bary)
    loss = tloop.masked_mse(pred, batch)
    loss.backward()
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters() if p.grad is not None}
    tloop.clip_by_global_norm_(list(model.parameters()), settings.grad_clip)
    opt.step()
    return model, float(loss.detach()), grads, {k: v.numpy() for k, v in model.state_dict().items()}


def _jax_step(pair, bary, n_real):
    """JAX's train step on a two-device mesh: the loss, the gradients and
    the parameters after the step, in the port's names."""
    jmodel, params = pair[0], pair[1]
    js = jloop.TrainSettings(use_barycenter=bary, learning_rate=LR)
    mesh = jax_mesh(2)
    global_batch = JBatch(**dataclasses.asdict(ranks_lib.global_batch(n_real)))
    batch = jloop._to_device_batch(global_batch, mesh)
    replicated = NamedSharding(mesh, PartitionSpec())
    rep = jax.tree.map(lambda x: jax.device_put(np.array(x), replicated), params)
    (loss, _), grads = jax.value_and_grad(jloop.make_loss_fn(jmodel, js), has_aux=True)(rep, batch)
    state = jloop.TrainState.create(apply_fn=jmodel.apply, params=rep, tx=jloop.make_optimizer(js))
    state, _, _ = jloop.make_step_fns(jmodel, js)[0](state, batch)
    as_port = lambda tree: {k: v.numpy() for k, v in  # noqa: E731
                            params_from_flax(jax.tree.map(np.asarray, tree)).items()}
    return float(loss), as_port(grads), as_port(state.params)


def _hold(loss, grads, weights, want_loss, want_grads, want_weights):
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    for k, want in want_grads.items():
        got = grads.get(k, np.zeros_like(want))  # no gradient: the barycenter head in stage 1
        assert np.linalg.norm(got - want) <= RTOL * np.linalg.norm(want) + 1e-9, k
    for k, want in want_weights.items():
        np.testing.assert_allclose(weights[k], want, atol=1e-2 * LR, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_the_jax_mesh_step(pair, ranks, case):
    """(b) The port's step on two gloo ranks against JAX's ``train_step``
    on a two-device mesh, from the same flax weights and global batch; with
    3 real rows the second rank holds 1 real row and 1 of padding, and the
    global denominator makes the ranks' losses sum to the batch's mean."""
    bary, n_real = CASES[case]
    model = _single_step(pair, bary, n_real)[0]
    flat, weights = ranks[0][case]
    _hold(float(flat[-2]), _grads(flat, model), weights[0], *_jax_step(pair, bary, n_real))


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_match_one_process(pair, ranks, case):
    """(c) The two ranks' step against the port's step in one process on
    the whole batch; the ranks' buffers and weights bit-identical at every
    one of three steps."""
    bary, n_real = CASES[case]
    model, loss, grads, weights = _single_step(pair, bary, n_real)
    flat, rank_weights = ranks[0][case]
    _hold(float(flat[-2]), _grads(flat, model), rank_weights[0], loss, grads, weights)
    flat1, rank1_weights = ranks[1][case]
    assert flat.tobytes() == flat1.tobytes()
    for a, b in zip(rank_weights, rank1_weights, strict=True):
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize("label", ["evaluate", "evaluate graphs"])
def test_two_rank_evaluate_gives_the_single_predictions_in_order(ranks, label):
    """(d) ``evaluate`` on two ranks (eagerly and through ``StepGraphs``'
    eval steps, both buckets, batches with padding rows and all-padding
    blocks) returns on every rank the single process's predictions in its
    order, and the same metrics; the small collectives agree."""
    settings = tloop.TrainSettings(use_barycenter=True, batch_size=4)
    model = ConanModel(device="cpu", seed=2, **SMALL)
    metrics, pred, y = tloop.evaluate(model, ranks_lib.eval_records(), settings, 64, "cpu")
    for out in ranks:
        m, p, yy = out[label]
        assert yy.tobytes() == y.tobytes()
        np.testing.assert_allclose(p, pred, rtol=1e-5, atol=1e-6)
        for k in metrics:
            np.testing.assert_allclose(m[k], metrics[k], rtol=1e-5, err_msg=k)
    assert ranks[0][label][1].tobytes() == ranks[1][label][1].tobytes()
    assert [out["mean"] for out in ranks] == [0.5, 0.5]
    assert [out["broadcast"] for out in ranks] == [{"from": 0}, {"from": 0}]
    assert all("replicas' weights differ" in out["replicas"] for out in ranks)


def test_two_rank_predict_and_lr_finder_agree_with_one_process(ranks):
    """``predict_records`` on two ranks gives every rank the single
    process's predictions in its order; the lr finder's sweep on rank 0
    reaches every rank, equal to one process's."""
    settings = tloop.TrainSettings(use_barycenter=True, batch_size=4)
    model = ConanModel(device="cpu", seed=2, **SMALL)
    ordered, pred, y = predict_records(model, ranks_lib.eval_records(), settings, 64, "cpu")
    found = lr_find(model, settings, ranks_lib.eval_records(), num_steps=4, device="cpu")
    for out in ranks:
        order, p, yy = out["predict"]
        assert order == [r.y for r in ordered] and yy.tobytes() == y.tobytes()
        np.testing.assert_allclose(p, pred, rtol=1e-5, atol=1e-6)
        assert out["lr_find"] == found


# (e)-(g): the runner -------------------------------------------------------
@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_dataset(tmp_path_factory.mktemp("tiny"))


def _args(tiny, root: Path, cfg: str, stage: str, *extra) -> list[str]:
    return ["--config", cfg, "--stage", stage, "--data_root", str(tiny), "--run_name", "dp",
            "--run_id", "1", "--models_dir", str(root / "models"), "--logs_dir",
            str(root / "logs"), "--metrics_dir", str(root / "metrics"), "--device", "cpu",
            "--out_json", str(root / f"{stage}.json"), *extra]


def test_cli_two_ranks_match_one_process(tiny, tmp_path):
    """(e) ``--device cpu --num_devices 2`` trains stage 1 through the CLI
    and stage 2 warm-started from it, against ``--num_devices 1``: each
    stage's ``test_rmse`` within 2e-3; the two ranks' summaries equal; only
    rank 0 writes checkpoints, metrics, its log and ``--out_json``."""
    pre = write_config(tmp_path, "pre.yaml", "pre")
    bc = write_config(tmp_path, "bc.yaml", "bc")
    one, two = tmp_path / "one", tmp_path / "two"
    for stage, cfg in (("conan_fgw_pre", pre), ("conan_fgw", bc)):
        trunner.main(_args(tiny, one, cfg, stage, "--num_devices", "1"))
    s1 = trunner.main(_args(tiny, two, pre, "conan_fgw_pre", "--num_devices", "2"))
    args = trunner.parse_args(_args(tiny, two, bc, "conan_fgw", "--num_devices", "2"))
    (s2, written0), (s2_rank1, written1) = mesh_lib.launch(ranks_lib.spied_rank, 2, args,
                                                           backend="gloo", device="cpu")
    assert s2 == s2_rank1
    assert written0 and "csv" in written0 and not written1
    for stage, s in (("conan_fgw_pre", s1), ("conan_fgw", s2)):
        want = json.loads((one / f"{stage}.json").read_text())["test_rmse"]["mean"]
        assert json.loads((two / f"{stage}.json").read_text()) == s
        np.testing.assert_allclose(s["test_rmse"]["mean"], want, rtol=RMSE_RTOL, err_msg=stage)
        run = two / "models/dp/1" / f"run_{stage}:0"
        assert all((run / f"{n}.npz").exists() for n in ("best", "last", "last_state"))
        log = (two / "logs/dp/1" / f"run_{stage}/log.txt").read_text()
        assert "rank 0 of 2" in log and "rank 1 of 2" not in log
    assert "warm-started run 0" in (two / "logs/dp/1/run_conan_fgw/log.txt").read_text()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_distributed_processes_agree(tiny, tmp_path):
    """(f) ``--distributed``: two processes on torchrun's environment
    (localhost), each writing where its own arguments say, give equal
    summaries."""
    cfg = write_config(tmp_path, "pre.yaml", "pre", epochs=1)
    port = _free_port()
    procs = []
    for rank in range(2):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": "2",
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1",
               "PYTHONPATH": str(ROOT)}
        argv = _args(tiny, tmp_path / f"p{rank}", cfg, "conan_fgw_pre", "--distributed")
        procs.append(subprocess.Popen([sys.executable, "-m", "conan_fgw_tpu_torch.train.runner",
                                       *argv], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    s0, s1 = (json.loads((tmp_path / f"p{r}/conan_fgw_pre.json").read_text()) for r in (0, 1))
    assert np.isfinite(s0["test_rmse"]["mean"]) and s0 == s1
    assert "rank 1 of 2" in (tmp_path / "p1/logs/dp/1/run_conan_fgw_pre/log.txt").read_text()


def test_more_ranks_than_cards_raises(monkeypatch):
    """(g) ``--num_devices`` above the visible cards raises, naming both."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"--num_devices 2: only 1 CUDA device"):
        trunner.num_ranks(2, torch.device("cuda"))
    assert trunner.num_ranks(0, torch.device("cuda")) == 1
    assert trunner.num_ranks(0, torch.device("cpu")) == 1


def test_a_failed_rank_or_topology_raises(monkeypatch):
    """A rank that raises makes ``launch`` raise, with its error or with the
    failed all-reduce of the rank that waited on it (whichever ends first;
    the other is stopped); a mesh without a joined group, and a torchrun
    environment with ``WORLD_SIZE`` but not the rest, raise; no
    ``WORLD_SIZE`` at all is one process."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException,
                       match=r"rank 1 fails|in all_reduce\s"):
        mesh_lib.launch(ranks_lib.failing_rank, 2, backend="gloo", device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        mesh_lib.create_mesh(2, "cpu")
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    mesh_lib.initialize_distributed("gloo")
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="MASTER_ADDR"):
        mesh_lib.initialize_distributed("gloo")


# the build race ---------------------------------------------------------------
def _concurrent(code: str, *argv, env=None) -> list[str]:
    procs = [subprocess.Popen([sys.executable, "-c", code, *argv], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    return [out.strip() for out, _ in outs]


def test_concurrent_packer_builds_give_one_good_library(tmp_path, monkeypatch):
    """Two processes building the native packer at once into one directory
    give one library, which packs as the numpy packer does."""
    code = ("import sys; from pathlib import Path; from conan_fgw_tpu_torch.data import native;"
            " native.BUILD_DIR = Path(sys.argv[1]); print(native.build())")
    paths = _concurrent(code, str(tmp_path), env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert paths[0] == paths[1]
    assert [p.name for p in tmp_path.iterdir() if p.name != ".lock"] == [Path(paths[0]).name]
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_lib", None)
    recs = random_dataset(1, 3, num_conformers=2, heavy_range=(3, 9), device="cpu")
    got, want = (fn(recs, max_atoms=32, batch_size=4)
                 for fn in (native.pack_batch_native, pack_batch))
    assert all(getattr(got, k).tobytes() == getattr(want, k).tobytes() for k in FIELDS)


def test_concurrent_kernel_builds_compile_once(tmp_path):
    """Two processes building the CUDA kernels at once (a stand-in ``nvcc``
    that takes a while and logs its calls) compile each source and link
    once: the second waits for the first's library."""
    bin_dir, out = tmp_path / "bin", tmp_path / "build"
    bin_dir.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n"
                    f"echo \"$*\" >> {tmp_path / 'calls.txt'}\n"
                    "sleep 0.5\n"
                    "while [ \"$1\" != -o ]; do shift; done\n"
                    "echo built > \"$2\"\n")
    nvcc.chmod(0o755)
    code = ("import sys; from pathlib import Path; from conan_fgw_tpu_torch.ops.cuda import _build;"
            " _build.BUILD_DIR = Path(sys.argv[1]); print(_build.build()[0])")
    env = {**os.environ, "PYTHONPATH": str(ROOT), "PATH": f"{bin_dir}:/usr/bin:/bin"}
    paths = _concurrent(code, str(out), env=env)
    assert paths[0] == paths[1] and Path(paths[0]).read_text() == "built\n"
    calls = (tmp_path / "calls.txt").read_text().splitlines()
    # one compile a source (csrc/*.cu), one link
    assert len(calls) == len(_build.SOURCES) + 1 and sum("-shared" in c for c in calls) == 1, calls
