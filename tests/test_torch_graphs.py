"""The port's counterpart of ``scan_chunk`` training (``train/graphs.py``)
on the CPU: the multi-tensor clip, the tensor learning rate, ``fit`` and
``evaluate`` through ``StepGraphs`` against eager steps, the graphed branch
rehearsed with stand-ins for CUDA graphs and streams, the launch
accounting of captured graphs, resuming a tensor-state Adam, and the
runner against the JAX runner with ``scan_chunk: 8``.

On the CPU ``StepGraphs`` runs the same step eagerly through its static
buffers, so ``fit`` must give bit for bit what eager steps give; the
graphs themselves are held against the eager steps on the card by
``chip_smoke.py`` phase 8. Small widths (hidden 32, 32 filters, 10
Gaussians) as ``tests/test_scan_chunk.py``; the runner test runs the
full-width model as ``tests/test_torch_runner.py`` does, with its
tolerances."""

import collections
import contextlib
import functools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conan_fgw_tpu.train import runner as jrunner
from conan_fgw_tpu.train.config import load_config as jload
from conan_fgw_tpu_torch.convert import state_dict_from_flax_checkpoint
from conan_fgw_tpu_torch.data.loader import bucketed_batches
from conan_fgw_tpu_torch.data.packing import pack_batch
from conan_fgw_tpu_torch.data.synthetic import random_dataset
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import runner as trunner
from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer
from conan_fgw_tpu_torch.train.config import load_config as tload
from conan_fgw_tpu_torch.train.graphs import LaunchReplays, StepGraphs
from test_torch_runner import FIRST_RTOL, LATER_RTOL, tiny_dataset, write_config

SMALL = dict(hidden_channels=32, num_filters=32, num_gaussians=10, num_interactions=2)
TIMES = ("train_s", "epoch_time_s", "queue_wait_s", "pack_s", "slot_wait_s", "replay_s")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """The runner test runs the full-width model beside JAX: one CPU thread
    keeps this file from fighting other test workers for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _no_times(history):
    return [{k: v for k, v in row.items() if k not in TIMES and not k.startswith("train_s_n")}
            for row in history]


@pytest.mark.parametrize("scale", [0.03, 0.3, 30.0])
def test_multi_tensor_clip_matches_optax(scale):
    """Below and above the threshold, with a parameter that has no gradient."""
    rng = np.random.default_rng(7)
    gs = [rng.standard_normal(s).astype(np.float32) * scale for s in ((3, 4), (5,), (2, 2, 3))]
    clipped, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in gs], None)
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(ps, gs):
        p.grad = torch.from_numpy(g.copy())
    idle = torch.nn.Parameter(torch.ones(4))
    norm = tloop.clip_by_global_norm_([ps[0], idle, *ps[1:]], 1.0)
    assert idle.grad is None
    np.testing.assert_allclose(float(norm), float(optax.global_norm([jnp.asarray(g) for g in gs])),
                               rtol=1e-6)
    for p, c in zip(ps, clipped):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(c), rtol=1e-6)


def test_tensor_lr_matches_float_lr():
    """A tensor lr written in place by ``set_learning_rate`` after step 10
    against a float lr set the same way: 20 Adam steps to 1e-6 relative."""
    rng = np.random.default_rng(3)
    init = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [rng.standard_normal((6, 5)).astype(np.float32) for _ in range(20)]
    weights = {}
    for kind in ("tensor", "float"):
        p = torch.nn.Parameter(torch.from_numpy(init.copy()))
        lr = torch.tensor(5e-3) if kind == "tensor" else 5e-3
        opt = torch.optim.Adam([p], lr=lr, betas=(0.9, 0.999), eps=1e-8)
        for i, g in enumerate(grads):
            if i == 10:
                tloop.set_learning_rate(opt, 2e-3)
            p.grad = torch.from_numpy(g)
            opt.step()
        assert isinstance(opt.param_groups[0]["lr"], torch.Tensor) == (kind == "tensor")
        weights[kind] = p.detach().numpy().copy()
    assert not np.array_equal(weights["tensor"], init)
    np.testing.assert_allclose(weights["tensor"], weights["float"], rtol=1e-6)


def test_make_optimizer_keeps_a_float_lr_on_the_cpu():
    opt = tloop.make_optimizer(ConanModel(device="cpu", **SMALL), tloop.TrainSettings())
    group = opt.param_groups[0]
    assert group["lr"] == 5e-4 and not group["capturable"]


class _EagerSteps:
    """``fit``'s steps without ``StepGraphs``: each batch moved with ``to``
    and stepped eagerly, the reference of the static-buffer path."""

    def __init__(self, model, optimizer, settings, device):
        self.train = lambda pb: tloop.train_step(model, optimizer, pb.to(device), settings)
        self.eval = lambda pb: tloop.eval_step(model, pb.to(device), settings)

    def stage(self, records, batch_size, buckets):
        return None  # no pinned slots: batches come from the default packer


@pytest.mark.parametrize("bary", [False, True])
def test_fit_through_step_graphs_is_bit_identical_to_eager_steps(bary, monkeypatch):
    """The counterpart of ``test_fit_scan_chunk_equivalent``: on the CPU the
    graphed path is the eager step through static buffers, so histories and
    weights are equal bit for bit."""
    recs = random_dataset(7, 12, num_conformers=2, heavy_range=(3, 12), device="cpu")
    val = random_dataset(8, 6, num_conformers=2, heavy_range=(3, 12), device="cpu")
    settings = tloop.TrainSettings(batch_size=2, num_epochs=2, use_barycenter=bary,
                                   learning_rate=1e-3, seed=1)
    runs = {}
    for mode in ("graphs", "eager"):
        if mode == "eager":
            monkeypatch.setattr(tloop, "step_graphs", _EagerSteps)
        runs[mode] = tloop.fit(settings, recs, val, model=ConanModel(device="cpu", seed=1, **SMALL),
                               device="cpu")
    assert isinstance(runs["graphs"].graphs, StepGraphs)
    assert {k[0] for k in runs["graphs"].graphs.steps} == {"train", "eval"}
    assert _no_times(runs["graphs"].history) == _no_times(runs["eager"].history)
    for p, q in zip(runs["graphs"].model.parameters(), runs["eager"].model.parameters()):
        assert torch.equal(p, q)


def test_mixed_buckets_train_every_batch_once():
    """The counterpart of ``test_mixed_buckets_consume_all_batches``: with
    two bucket shapes every batch trains exactly once."""
    recs = random_dataset(11, 14, num_conformers=2, heavy_range=(3, 28), device="cpu")
    val = random_dataset(12, 4, num_conformers=2, heavy_range=(3, 10), device="cpu")
    settings = tloop.TrainSettings(batch_size=3, num_epochs=1, use_barycenter=True)
    res = tloop.fit(settings, recs, val, model=ConanModel(device="cpu", **SMALL), device="cpu")
    max_atoms = tloop.dataset_max_atoms(recs + val)
    want = collections.Counter(pb.max_atoms for pb in bucketed_batches(
        recs, 3, buckets=tloop.bucket_boundaries(max_atoms)))
    row = res.history[0]
    assert len(want) == 2 and row["train_steps"] == sum(want.values())
    assert {n: row[f"steps_n{n}"] for n in want} == dict(want)
    assert {k[1][2] for k in res.graphs.steps if k[0] == "train"} == set(want)
    assert np.isfinite(row["train_loss"])


def test_evaluate_through_graphs_matches_eager():
    """The counterpart of ``test_eval_scan_matches_per_step``."""
    recs = random_dataset(7, 14, num_conformers=2, heavy_range=(3, 25), device="cpu")
    model = ConanModel(device="cpu", **SMALL)
    settings = tloop.TrainSettings(batch_size=2, use_barycenter=True)
    max_atoms = tloop.dataset_max_atoms(recs)
    graphs = tloop.step_graphs(model, tloop.make_optimizer(model, settings), settings, "cpu")
    m_g, pred_g, y_g = tloop.evaluate(model, recs, settings, max_atoms, "cpu", graphs)
    m_e, pred_e, y_e = tloop.evaluate(model, recs, settings, max_atoms, "cpu")
    np.testing.assert_array_equal(y_g, y_e)
    np.testing.assert_allclose(pred_g, pred_e, rtol=1e-6)
    np.testing.assert_allclose(m_g["rmse"], m_e["rmse"], rtol=1e-6)
    assert {k[0] for k in graphs.steps} == {"eval"}


def test_static_buffers_copy_and_do_not_alias_the_batch():
    """Each batch is copied into the shape's buffers; the host batch that
    made them is never written through them."""
    recs = random_dataset(5, 4, num_conformers=2, heavy_range=(3, 8), device="cpu")
    model = ConanModel(device="cpu", **SMALL)
    settings = tloop.TrainSettings(batch_size=2)
    graphs = tloop.step_graphs(model, tloop.make_optimizer(model, settings), settings, "cpu")
    first, second = (pack_batch(recs[i:i + 2], max_atoms=32, batch_size=2) for i in (0, 2))
    kept = first.pos.copy()
    graphs.eval(first)
    graphs.eval(second)
    (step,) = graphs.steps.values()
    np.testing.assert_array_equal(first.pos, kept)
    np.testing.assert_array_equal(step.batch.pos.numpy(), second.pos)


def test_launch_replays_count_each_replay_once():
    """Capture counts once (nothing runs), standing for the first replay;
    every later replay adds the captured delta; untouched names stay out."""
    reset_launches()
    launches["other"] += 2

    def counted_call():  # a wrapper launching two kernels of one name
        launches["fake"] += 2

    acc = LaunchReplays()
    with acc.capturing():
        counted_call()
    assert launches["fake"] == 2 and acc.delta == {"fake": 2}
    acc.replayed()  # the first replay: the capture already counted it
    assert launches["fake"] == 2
    for n in range(2, 5):
        acc.replayed()
        assert launches["fake"] == 2 * n
    assert launches["other"] == 2
    reset_launches()


class _FakeGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: the capture ran the step for
    real, standing for the first replay; each later replay reruns it
    (``rerun``, set by ``_Rehearsed._capture``)."""

    def __init__(self):
        self.rerun, self.replays = None, 0

    def replay(self):
        if self.replays:
            self.rerun()
        self.replays += 1


class _FakeStream:
    def __init__(self, device=None):
        pass

    def wait_stream(self, other):
        pass


class _Rehearsed(StepGraphs):
    """``StepGraphs`` with its graphed branch on, on the CPU. A replay
    reruns the step through uncounted functions (a real replay does not
    call the wrappers) and writes the results into the captured outputs
    and gradients, as the graph writes its static tensors."""

    def __init__(self, uncounted, *args):
        super().__init__(*args)
        self.graphed = True
        self.uncounted = uncounted

    def _capture(self, step, fn, kind):
        super()._capture(step, fn, kind)

        def rerun():
            for static, new in zip(step.out, self.uncounted[kind](step.batch)):
                static.copy_(new)
            if kind == "train":
                for g, p in zip(step.grads, self.params):
                    if g is not None:
                        g.copy_(p.grad)

        step.graph.rerun = rerun


@pytest.mark.parametrize("bary", [False, True])
@pytest.mark.parametrize("kind", ["train", "eval"])
def test_rehearsed_graphs_match_eager_steps(kind, bary, monkeypatch):
    """The graphed branch of ``StepGraphs`` (side-stream warm-up, capture,
    replays, the outputs' clones, ``grads``, ``LaunchReplays``) with
    stand-ins for CUDA graphs and streams: over one shape's five batches
    it gives the eager steps' outputs, weights and gradients bit for bit
    (aliased outputs would all read the last step's), and counts each
    step's launches once."""
    for name, fake in (("CUDAGraph", _FakeGraph), ("Stream", _FakeStream),
                       ("current_stream", _FakeStream),
                       ("graph", lambda g: contextlib.nullcontext()),
                       ("stream", lambda s: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, fake)
    recs = random_dataset(4, 10, num_conformers=2, heavy_range=(3, 8), device="cpu")
    batches = list(bucketed_batches(recs, 2, buckets=(32,)))
    settings = tloop.TrainSettings(batch_size=2, use_barycenter=bary, learning_rate=1e-3)
    runs = {}
    for mode in ("eager", "rehearsed"):
        model = ConanModel(device="cpu", seed=1, **SMALL)
        fns = {"train": functools.partial(tloop.train_step, model,
                                          tloop.make_optimizer(model, settings), settings=settings),
               "eval": functools.partial(tloop.eval_step, model, settings=settings)}
        if mode == "eager":
            outs = [fns[kind](pb.to("cpu")) for pb in batches]
            grads = [p.grad for p in model.parameters()]
        else:
            def counted(fn):
                def call(batch):
                    launches["kernel"] += 3
                    return fn(batch)
                return call

            reset_launches()
            graphs = _Rehearsed(fns, counted(fns["train"]), counted(fns["eval"]),
                                model.parameters(), "cpu")
            outs = [getattr(graphs, kind)(pb) for pb in batches]
            grads = graphs.grads
            (step,) = graphs.steps.values()
            assert step.warm and step.graph.replays == len(batches) - 1
            assert launches["kernel"] == 3 * len(batches)
            reset_launches()
        runs[mode] = (model, outs, grads)
    (m_e, outs_e, grads_e), (m_r, outs_r, grads_r) = runs["eager"], runs["rehearsed"]
    assert len(batches) == 5
    for oe, orr in zip(outs_e, outs_r):
        assert all(torch.equal(a, b) for a, b in zip(oe, orr))
    for p, q in zip(m_e.parameters(), m_r.parameters()):
        assert torch.equal(p, q)
    if kind == "train":
        assert all((a is None and b is None) or torch.equal(a, b) for a, b in zip(grads_e, grads_r))


def test_resume_with_a_tensor_step_and_lr(tmp_path):
    """``last_state`` of an Adam whose ``step`` entries and lr are tensors:
    the restored optimizer's next step equals an uninterrupted run's bit for
    bit, and its lr stays a tensor that ``set_learning_rate`` writes."""
    batch = pack_batch(random_dataset(2, 4, num_conformers=2, heavy_range=(4, 7), device="cpu"),
                       max_atoms=32).to("cpu")
    settings = tloop.TrainSettings(use_barycenter=True, batch_size=4)

    def tensor_lr_adam(model):
        return torch.optim.Adam(model.parameters(), lr=torch.tensor(settings.learning_rate),
                                betas=(0.9, 0.999), eps=1e-8)

    model = ConanModel(device="cpu", seed=1, **SMALL)
    opt = tensor_lr_adam(model)
    for _ in range(2):
        tloop.train_step(model, opt, batch, settings)
    assert all(isinstance(st["step"], torch.Tensor) for st in opt.state.values())
    ck = RunCheckpointer(str(tmp_path))
    ck.save_state(model, opt, 1)
    with np.load(tmp_path / "last_state.npz") as data:
        assert data["adam/head.bias/step"].shape == () and float(data["adam/head.bias/step"]) == 2.0

    other = ConanModel(device="cpu", seed=9, **SMALL)
    other_opt = tensor_lr_adam(other)
    ck.restore_state(other, other_opt)
    lr = other_opt.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor)
    for opt_ in (opt, other_opt):
        tloop.set_learning_rate(opt_, 2e-4)
    assert float(lr) == pytest.approx(2e-4) and other_opt.param_groups[0]["lr"] is lr
    tloop.train_step(model, opt, batch, settings)
    tloop.train_step(other, other_opt, batch, settings)
    for (k, v), w in zip(model.state_dict().items(), other.state_dict().values()):
        assert torch.equal(v, w), k
    for p, q in zip(model.parameters(), other.parameters()):
        assert torch.equal(opt.state[p]["step"], other_opt.state[q]["step"])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_dataset(tmp_path_factory.mktemp("tiny"))


def test_stage2_scan_chunk_matches_the_jax_runner(tiny, tmp_path):
    """``scan_chunk: 8`` in both runners' configs, stage 2 from one JAX
    stage-1 checkpoint, within ``test_torch_runner.py``'s tolerances: the
    JAX runner takes its scanned path, the port's steps go through
    ``StepGraphs`` (its counterpart, whatever the value)."""
    data = str(tiny / "data")
    cfgs = {}
    for kind in ("pre", "bc"):
        text = open(write_config(tmp_path, f"{kind}.yaml", kind)).read()
        (tmp_path / f"{kind}.yaml").write_text(text.replace("scan_chunk: 0", "scan_chunk: 8"))
        cfgs[kind] = str(tmp_path / f"{kind}.yaml")
    jmodels, tmodels = tmp_path / "jax_models", tmp_path / "port_models"
    common = dict(data_dir=data, run_name="t", run_id="1")
    jrunner.run_experiment(jload(cfgs["pre"]), stage=jrunner.STAGE_PRE, models_dir=str(jmodels),
                           **common)
    model = ConanModel(device="cpu")
    model.load_state_dict(state_dict_from_flax_checkpoint(
        str(jmodels / "t/1/run_conan_fgw_pre:0/best.npz")))
    RunCheckpointer(str(tmodels / "t/1/run_conan_fgw_pre:0")).save_best(model, 0)

    captured = []
    original = StepGraphs.__init__

    def spy(self, *args, **kwargs):
        original(self, *args, **kwargs)
        captured.append(self)

    StepGraphs.__init__ = spy
    try:
        _, jruns = jrunner.run_experiment(jload(cfgs["bc"]), stage=jrunner.STAGE_BC,
                                          models_dir=str(jmodels), **common)
        _, truns = trunner.run_experiment(tload(cfgs["bc"]), stage=trunner.STAGE_BC,
                                          models_dir=str(tmodels), device="cpu", **common)
    finally:
        StepGraphs.__init__ = original
    (graphs,) = captured
    assert {k[0] for k in graphs.steps} == {"train", "eval"}
    jh, th = jruns[0]["history"], truns[0]["history"]
    assert [r["epoch"] for r in th] == [r["epoch"] for r in jh] == [0, 1]
    for jrow, trow in zip(jh, th):
        rtol = FIRST_RTOL if trow["epoch"] == 0 else LATER_RTOL
        for key in ("train_loss", "val_mse", "val_loss"):
            got, want = trow[key], jrow[key]
            assert abs(got - want) <= rtol * abs(want), f"epoch {trow['epoch']} {key}: {got} {want}"
        assert trow["fgw_diverged"] == jrow["fgw_diverged"]
        assert trow["steps_n32"] == trow["train_steps"] == 3
    got, want = truns[0]["metrics"]["test_rmse"], jruns[0]["metrics"]["test_rmse"]
    assert abs(got - want) <= LATER_RTOL * abs(want)
    assert truns[0]["metrics"]["best_epoch"] == jruns[0]["metrics"]["best_epoch"]
