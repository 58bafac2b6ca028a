"""Port parity: gradient accumulation (``TrainSettings.accumulate_steps``)
against the JAX package's ``optax.MultiSteps`` around clip and Adam, on the
CPU, at a small size (hidden 32, 2 interactions, N=32, batches of 2, K=2).

Tolerances, as ``tests/test_torch_train.py`` holds one step: each
mini-step's loss rtol 1e-4; the weights atol 1e-2 lr per update so far
(Adam normalises each element, so it amplifies noise where a gradient is
near 1e-8), and bit for bit unchanged on a mini-step that does not update;
Adam's step count exactly. The first GAT layer's ``att_dst`` has an exactly
zero gradient (XLA returns zeros, the port rounding noise, which Adam
normalises to steps of the lr), so weights whose JAX gradient is below 1e-7
of the global norm are held by their effect instead, as
``tests/test_torch_esan.py`` holds them: the two models' predictions on a
fresh batch, rtol 1e-4. The port against itself (a resume, the graphed
branch, the data-parallel split step): bit for bit.
"""

import contextlib
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.data.packing import PackedBatch as JBatch
from conan_fgw_tpu.models.heads import ConanModel as JConan
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu_torch.convert import params_from_flax
from conan_fgw_tpu_torch.data.loader import bucketed_batches
from conan_fgw_tpu_torch.data.packing import pack_batch as tpack
from conan_fgw_tpu_torch.data.synthetic import random_dataset
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer
from conan_fgw_tpu_torch.train.graphs import StepGraphs
from test_torch_graphs import _FakeGraph, _FakeStream
from test_torch_model import SMALL

LR = 5e-4
K_STEPS = 3
FIELDS = [f.name for f in dataclasses.fields(JBatch)]


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_params(seed=0):
    pb = tpack(random_dataset(3, 2, num_conformers=2, heavy_range=(4, 9), device="cpu"),
               max_atoms=32, batch_size=2)
    jb = JBatch(**{f: jnp.asarray(getattr(pb, f)) for f in FIELDS})
    params = JConan(**SMALL).init(jax.random.PRNGKey(seed), jb, use_barycenter=True)
    return {k: v for k, v in params.items() if k != "diagnostics"}


def _noise_gradients(params, jbatch, bary) -> set:
    """The weights whose JAX gradient on ``jbatch`` is below 1e-7 of the
    global gradient norm."""
    js = jloop.TrainSettings(use_barycenter=bary)
    _, grads = jax.value_and_grad(jloop.make_loss_fn(JConan(**SMALL), js), has_aux=True)(
        params, jbatch)
    norms = {k: float(np.linalg.norm(v.numpy()))
             for k, v in params_from_flax(jax.tree.map(np.asarray, grads)).items()}
    total = float(np.sqrt(sum(n * n for n in norms.values())))
    noise = {k for k, n in norms.items() if n <= 1e-7 * total}
    assert all(k.startswith("gat.") for k in noise), noise  # the GAT's attention and edges
    return noise


def _assert_predictions_close(model, jparams, bary, seed=21):
    """The port's and the JAX model's predictions on a fresh batch."""
    pb = tpack(random_dataset(seed, 4, num_conformers=2, heavy_range=(4, 9), device="cpu"),
               max_atoms=32, batch_size=4)
    jb = JBatch(**{f: jnp.asarray(getattr(pb, f)) for f in FIELDS})
    want = np.asarray(JConan(**SMALL).apply(jparams, jb, use_barycenter=bary,
                                            mutable=["diagnostics"])[0])
    with torch.no_grad():
        got = model(pb.to("cpu"), use_barycenter=bary)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def _port(params):
    model = ConanModel(device="cpu", **SMALL)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return model


def test_fit_accumulates_as_optax_multisteps(tmp_path, monkeypatch):
    """``fit`` over one epoch of 7 mini-steps (stage 2, k=3: updates after
    the 3rd and 6th) against the JAX step with ``optax.MultiSteps`` fed
    the same batches: the loss of every mini-step, the weights after each,
    Adam's count and the epoch's loss record."""
    params = _jax_params()
    model = _port(params)
    seen = []  # per mini-step: the batch, its loss and the weights after it
    train = StepGraphs.train

    def spy(self, pb):
        batch = {f: np.array(getattr(pb, f)) for f in FIELDS}
        loss, n_div = train(self, pb)
        seen.append((batch, float(loss), {k: v.clone() for k, v in model.state_dict().items()}))
        return loss, n_div

    monkeypatch.setattr(StepGraphs, "train", spy)
    recs = random_dataset(5, 14, num_conformers=2, heavy_range=(4, 9), device="cpu")
    val = random_dataset(6, 2, num_conformers=2, heavy_range=(4, 9), device="cpu")
    settings = tloop.TrainSettings(batch_size=2, num_epochs=1, use_barycenter=True,
                                   learning_rate=LR, accumulate_steps=K_STEPS, max_atoms=32)
    ckpt = RunCheckpointer(str(tmp_path))
    result = tloop.fit(settings, recs, val, model=model, device="cpu", checkpointer=ckpt)
    assert len(seen) == 7

    js = jloop.TrainSettings(use_barycenter=True, learning_rate=LR, accumulate_steps=K_STEPS)
    jmodel = JConan(**SMALL)
    state = jloop.TrainState.create(apply_fn=jmodel.apply, params=params,
                                    tx=jloop.make_optimizer(js))
    jstep, _ = jloop.make_step_fns(jmodel, js)
    before = {k: torch.from_numpy(v.numpy()) for k, v in params_from_flax(
        jax.tree.map(np.asarray, params)).items()}
    noise = _noise_gradients(params, JBatch(**{f: jnp.asarray(v) for f, v in seen[0][0].items()}),
                             True)
    for i, (batch, loss_t, weights) in enumerate(seen):
        state, loss_j, _ = jstep(state, JBatch(**{f: jnp.asarray(v) for f, v in batch.items()}))
        np.testing.assert_allclose(loss_t, float(loss_j), rtol=1e-4)
        updates = (i + 1) // K_STEPS
        assert int(state.opt_state.gradient_step) == updates
        want = params_from_flax(jax.tree.map(np.asarray, state.params))
        for name, w in weights.items():
            if name not in noise:
                np.testing.assert_allclose(w.numpy(), want[name].numpy(), rtol=0,
                                           atol=1e-2 * LR * max(updates, 1), err_msg=f"{i} {name}")
        if (i + 1) % K_STEPS:  # no update: bit for bit the weights before
            assert all(torch.equal(w, before[k]) for k, w in weights.items()), i
        else:
            assert not all(torch.equal(w, before[k]) for k, w in weights.items()), i
        before = weights
    _assert_predictions_close(result.model, state.params, True)
    np.testing.assert_allclose(result.history[0]["train_loss"],
                               np.mean([loss for _, loss, _ in seen]), rtol=1e-6)
    with np.load(tmp_path / "last_state.npz") as data:
        steps = {float(data[k]) for k in data.files if k.startswith("adam/") and
                 k.endswith("/step")}
        assert steps == {7 // K_STEPS}
        assert int(data["accumulate/mini_step"]) == 7 % K_STEPS


def test_set_learning_rate_reaches_the_inner_adam():
    """An lr change in the middle of an accumulation takes effect at its
    update, as JAX's ``set_learning_rate`` on a ``MultiStepsState`` does."""
    params = _jax_params(seed=1)
    model = _port(params)
    settings = tloop.TrainSettings(batch_size=2, learning_rate=LR, accumulate_steps=2,
                                   use_barycenter=True)
    opt = tloop.make_optimizer(model, settings)
    acc = tloop.make_accumulation(model, settings, "cpu")
    js = jloop.TrainSettings(learning_rate=LR, accumulate_steps=2, use_barycenter=True)
    jmodel = JConan(**SMALL)
    state = jloop.TrainState.create(apply_fn=jmodel.apply, params=params,
                                    tx=jloop.make_optimizer(js))
    jstep, _ = jloop.make_step_fns(jmodel, js)
    recs = random_dataset(9, 8, num_conformers=2, heavy_range=(4, 9), device="cpu")
    noise = set()
    for i, pb in enumerate(bucketed_batches(recs, 2, buckets=(32,))):
        jb = JBatch(**{f: jnp.asarray(getattr(pb, f)) for f in FIELDS})
        if i == 0:
            noise = _noise_gradients(params, jb, True)
        if i == 1:
            tloop.set_learning_rate(opt, LR / 4)
            state = jloop.set_learning_rate(state, LR / 4)
        update = acc.begin()
        tloop.train_step(model, opt, pb.to("cpu"), settings, acc, update)
        acc.end()
        state, _, _ = jstep(state, jb)
    want = params_from_flax(jax.tree.map(np.asarray, state.params))
    assert noise
    for name, w in model.state_dict().items():
        if name not in noise:
            np.testing.assert_allclose(w.numpy(), want[name].numpy(), rtol=0, atol=2e-2 * LR,
                                       err_msg=name)
    _assert_predictions_close(model, state.params, True)


def test_resume_in_the_middle_of_an_accumulation_is_bit_exact(tmp_path):
    """Two epochs of 4 mini-steps at k=3 leave the first epoch at m=1; a
    resume from its ``last_state`` continues that accumulation and ends
    bit for bit where the straight run does."""
    recs = random_dataset(10, 8, num_conformers=2, heavy_range=(4, 9), device="cpu")
    val = random_dataset(11, 2, num_conformers=2, heavy_range=(4, 9), device="cpu")

    def run(epochs, directory, resume=False):
        settings = tloop.TrainSettings(batch_size=2, num_epochs=epochs, learning_rate=1e-3,
                                       accumulate_steps=K_STEPS, max_atoms=32, seed=2)
        return tloop.fit(settings, recs, val, model=ConanModel(device="cpu", seed=2, **SMALL),
                         device="cpu", checkpointer=RunCheckpointer(str(directory)),
                         resume=resume)

    straight = run(2, tmp_path / "a")
    run(1, tmp_path / "b")
    with np.load(tmp_path / "b" / "last_state.npz") as data:
        assert int(data["accumulate/mini_step"]) == 1
        assert any(np.any(data[k]) for k in data.files
                   if k.startswith("accumulate/") and k != "accumulate/mini_step")
    resumed = run(2, tmp_path / "b", resume=True)
    for p, q in zip(straight.model.parameters(), resumed.model.parameters()):
        assert torch.equal(p, q)
    for name in ("a", "b"):
        with np.load(tmp_path / name / "last_state.npz") as data:
            arrays = {k: data[k] for k in data.files}
        if name == "a":
            want = arrays
        else:
            assert arrays.keys() == want.keys()
            assert all(np.array_equal(arrays[k], want[k]) for k in want), name
    assert straight.history[1]["train_loss"] == resumed.history[1]["train_loss"]


class _Rehearsed(StepGraphs):
    """``StepGraphs`` with its graphed branch on, on the CPU (as in
    ``tests/test_torch_graphs.py``): a replay reruns the step of its kind
    (through ``uncounted[kind]`` where given: a real replay calls no
    wrapper) and writes its outputs into the captured ones."""

    uncounted: dict = {}

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.graphed = True

    def _capture(self, step, fn, kind):
        super()._capture(step, fn, kind)

        def rerun():
            for static, new in zip(step.out, self.uncounted.get(kind, fn)(step.batch)):
                static.copy_(new)

        step.graph.rerun = rerun


@pytest.mark.parametrize("k", [1, K_STEPS])
def test_graphed_accumulation_matches_eager_mini_steps(k, monkeypatch):
    """Two train graphs a shape at k > 1 ("train" accumulates, "train_update"
    also updates), one at k = 1, and the replays give the eager mini-steps'
    losses and weights bit for bit; the divisor the graphs read is the
    host's m + 1 before each mini-step."""
    for name, fake in (("CUDAGraph", _FakeGraph), ("Stream", _FakeStream),
                       ("current_stream", _FakeStream),
                       ("graph", lambda g: contextlib.nullcontext()),
                       ("stream", lambda s: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, fake)
    recs = random_dataset(4, 16, num_conformers=2, heavy_range=(3, 8), device="cpu")
    batches = list(bucketed_batches(recs, 2, buckets=(32,)))
    settings = tloop.TrainSettings(batch_size=2, learning_rate=1e-3, accumulate_steps=k)
    runs = {}
    for mode in ("eager", "rehearsed"):
        model = ConanModel(device="cpu", seed=1, **SMALL)
        opt = tloop.make_optimizer(model, settings)
        acc = tloop.make_accumulation(model, settings, "cpu")
        if mode == "eager":
            outs = []
            for pb in batches:
                update = acc.begin() if acc else True
                outs.append(tloop.train_step(model, opt, pb.to("cpu"), settings, acc, update))
                if acc:
                    acc.end()
        else:
            monkeypatch.setattr(tloop, "StepGraphs", _Rehearsed)
            graphs = tloop.step_graphs(model, opt, settings, "cpu", accumulation=acc)
            assert isinstance(graphs, _Rehearsed) and graphs.graphed
            divisors = []
            begin = acc.begin if acc else None
            if acc:
                monkeypatch.setattr(acc, "begin",
                                    lambda: divisors.append(acc.m + 1) or begin())
            outs = [graphs.train(pb) for pb in batches]
            kinds = sorted(key[0] for key in graphs.steps)
            assert kinds == (["train", "train_update"] if k > 1 else ["train"])
            if acc:
                assert divisors == [i % k + 1 for i in range(len(batches))]
                assert float(acc.divisor) == divisors[-1]
        runs[mode] = (model, outs, opt)
    (m_e, outs_e, opt_e), (m_r, outs_r, opt_r) = runs["eager"], runs["rehearsed"]
    assert len(batches) == 8
    for a, b in zip(outs_e, outs_r):
        assert torch.equal(a[0], b[0])
    for p, q in zip(m_e.parameters(), m_r.parameters()):
        assert torch.equal(p, q)
    assert {float(s["step"]) for s in opt_r.state.values()} == {len(batches) // k}


def test_split_step_accumulates_the_reduced_gradients(monkeypatch):
    """Under data parallelism the fold sees the all-reduced gradient: a
    stand-in all-reduce that doubles (two ranks holding the same rows, each
    dividing by twice the rows) gives the single-process mini-steps bit for
    bit; folding before the reduce would halve every update's mean."""
    monkeypatch.setattr(tloop.collectives, "all_reduce_", lambda flat, mesh: flat.mul_(2.0))
    recs = random_dataset(12, 8, num_conformers=2, heavy_range=(3, 8), device="cpu")
    batches = list(bucketed_batches(recs, 2, buckets=(32,)))
    settings = tloop.TrainSettings(batch_size=2, learning_rate=1e-3, accumulate_steps=2)
    models = []
    for split in (False, True):
        model = ConanModel(device="cpu", seed=3, **SMALL)
        opt = tloop.make_optimizer(model, settings)
        acc = tloop.make_accumulation(model, settings, "cpu")
        step = tloop.SplitStep(model, opt, settings, mesh=None, accumulation=acc)
        for pb in batches:
            update = acc.begin()
            batch = pb.to("cpu")
            if split:
                rows = torch.tensor(2.0 * float(batch.mol_mask.sum()))
                step.before(batch, rows)
                step.reduce()
                step.after(update)
            else:
                tloop.train_step(model, opt, batch, settings, acc, update)
            acc.end()
        models.append(model)
    for p, q in zip(*(m.parameters() for m in models)):
        assert torch.equal(p, q)


def test_accumulation_needs_two_mini_steps():
    with pytest.raises(ValueError, match="at least 2"):
        tloop.Accumulation([torch.nn.Parameter(torch.zeros(2))], 1, "cpu")
    assert tloop.make_accumulation(ConanModel(device="cpu", **SMALL),
                                   tloop.TrainSettings(), "cpu") is None


def test_launches_count_each_kind_once_a_replay(monkeypatch):
    """Each train kind's graph counts its own kernels' launches per replay
    (``LaunchReplays``), so the counts stay executions under accumulation."""
    for name, fake in (("CUDAGraph", _FakeGraph), ("Stream", _FakeStream),
                       ("current_stream", _FakeStream),
                       ("graph", lambda g: contextlib.nullcontext()),
                       ("stream", lambda s: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, fake)
    model = ConanModel(device="cpu", seed=1, **SMALL)
    settings = tloop.TrainSettings(batch_size=2, accumulate_steps=2)
    acc = tloop.make_accumulation(model, settings, "cpu")

    def step(update, batch, count=True):
        launches["k"] += count
        return torch.zeros(()), torch.zeros((), dtype=torch.int64)

    graphs = _Rehearsed(functools.partial(step, False), lambda b: None, model.parameters(),
                        "cpu", accumulation=acc, train_update_fn=functools.partial(step, True))
    graphs.uncounted = {kind: functools.partial(step, kind == "train_update", count=False)
                        for kind in ("train", "train_update")}
    recs = random_dataset(4, 12, num_conformers=2, heavy_range=(3, 8), device="cpu")
    reset_launches()
    for pb in bucketed_batches(recs, 2, buckets=(32,)):
        graphs.train(pb)
    # 6 mini-steps: each kind warms up eagerly, is captured (counted once for
    # its first replay) and its later replays add the capture's count
    assert launches["k"] == 6
    reset_launches()
