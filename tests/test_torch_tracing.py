"""The port's spans and counters (``utils/profiling.py``) and the Sinkhorn
iterations K3 returns, kept through the barycenter to the epoch's counter.

On the CPU: ``span`` without a profiler calls no ``record_function``; an
epoch under ``device_trace`` writes the loop's ranges; the packer's count;
``fgw.sinkhorn_iters`` against the plain solver on the epoch's own solves;
the plain solver's count itself; ``fit``'s new history columns across a
resume. On the card (``-m card``): K3's iteration count against the plain
solver's, and the captures of new shapes.
"""

import json

import pytest
import torch

from conan_fgw_tpu_torch.data.packing import bucket_for
from conan_fgw_tpu_torch.data.synthetic import random_dataset
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.ops.cuda import fgw as k3
from conan_fgw_tpu_torch.ops.fgw import FGWConfig
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer
from conan_fgw_tpu_torch.utils import profiling

SMALL = dict(hidden_channels=32, num_filters=32, num_gaussians=10, num_interactions=2)
# the smallest widths the card's cfconv kernels are built for
CARD = dict(hidden_channels=128, num_filters=128, num_gaussians=50, num_interactions=1)
KW = dict(alpha=0.1, epsilon=0.1, pgd_iters=5, pgd_tol=1e-4, sinkhorn_iters=5, sinkhorn_thr=1e-2)
# the new history columns of host seconds
TIMES = ("queue_wait_s", "pack_s", "slot_wait_s", "replay_s")


def _epoch_setup(device, bary=True, molecules=10, seed=7):
    recs = random_dataset(seed, molecules, num_conformers=2, heavy_range=(3, 12), device="cpu")
    settings = tloop.TrainSettings(batch_size=4, use_barycenter=bary, learning_rate=1e-3)
    model = ConanModel(device=device, seed=1, **(SMALL if device == "cpu" else CARD))
    opt = tloop.make_optimizer(model, settings)
    graphs = tloop.step_graphs(model, opt, settings, torch.device(device))
    return recs, settings, graphs, tloop.dataset_max_atoms(recs)


def _problem(S, N, scale, seed):
    """``S`` solves at N atoms, costs ``scale`` times squared distances:
    small scales freeze every Sinkhorn solve after its first iteration,
    large ones run the whole budget (both far from ``sinkhorn_thr``)."""
    g = torch.Generator().manual_seed(seed)
    x, y = torch.randn(S, N, 3, generator=g), torch.randn(S, N, 3, generator=g)
    C1, C2 = torch.cdist(x, x), torch.cdist(y, y)
    p = torch.full((S, N), 1.0 / N)
    return [t.contiguous() for t in (scale * torch.cdist(x, y) ** 2,
                                     C1 / C1.amax((-2, -1), keepdim=True),
                                     C2 / C2.amax((-2, -1), keepdim=True),
                                     p, p.clone(), p[:, :, None] * p[:, None, :])]


def _mixed(N, seed):
    """Half the solves freezing early, half running the budget."""
    small, large = _problem(4, N, 1e-3, seed), _problem(4, N, 1.0, seed + 1)
    return [torch.cat([a, b]) for a, b in zip(small, large)]


def test_span_calls_no_record_function_without_a_profiler(monkeypatch):
    """Without a profiler a span is the shared no-op or a counter's timer
    and never builds a ``record_function``; under one it opens
    ``conan.<name>`` and keeps the span in ``recorded``."""
    def refuse(*a, **k):
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    profiling.reset_counters()
    assert profiling.span("x") is profiling.span("y", 32)
    with profiling.span("x", 32, counter="test.x_s"):
        pass
    assert profiling.counters["test.x_s"] > 0
    monkeypatch.undo()
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("traced", 64, counter="test.x_s"):
            pass
        profiling.add("test.count", 3)
    names = [e.key for e in prof.key_averages()]
    assert "conan.traced" in names
    last = [r[:2] for r in list(profiling.recorded)[-2:]]
    assert last == [("conan.traced", 64), ("test.count", 3)]
    assert profiling.counters["test.count"] == 3


def test_train_epoch_trace_has_the_loop_spans(tmp_path):
    """A ``_train_epoch`` of small records under ``device_trace`` writes
    ``conan.queue_wait``, ``conan.epoch_start`` and ``conan.epoch_end``
    ranges into ``trace.json``."""
    recs, settings, graphs, max_atoms = _epoch_setup("cpu", bary=False)
    with profiling.device_trace(str(tmp_path)):
        tloop._train_epoch(graphs, recs, settings, max_atoms, torch.device("cpu"), 0)
    with open(tmp_path / "trace.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "user_annotation"}
    assert {"conan.queue_wait", "conan.epoch_start", "conan.epoch_end"} <= names


def test_packs_count_the_epochs_batches():
    recs, settings, graphs, max_atoms = _epoch_setup("cpu", bary=False)
    before = profiling.counters.copy()
    losses, _, _ = tloop._train_epoch(graphs, recs, settings, max_atoms, torch.device("cpu"), 0)
    assert profiling.counters["pipeline.packs"] - before["pipeline.packs"] == len(losses) > 1
    assert profiling.counters["pipeline.pack_s"] > before["pipeline.pack_s"]
    assert profiling.counters["pipeline.queue_wait_s"] > before["pipeline.queue_wait_s"]


def test_sinkhorn_iters_match_the_plain_solver(monkeypatch):
    """After one epoch ``fgw.sinkhorn_iters`` grew by the iterations of
    every solve the epoch made (a frozen molecule's too), recomputed
    through ``fgw_couplings_plain`` on the same inputs."""
    recs, settings, graphs, max_atoms = _epoch_setup("cpu", molecules=9)
    seen, plain = [], k3.fgw_couplings_plain

    def spy(*args, **kw):
        seen.append(([a.clone() for a in args], dict(kw)))
        return plain(*args, **kw)

    monkeypatch.setattr(k3, "fgw_couplings_plain", spy)
    before = profiling.counters["fgw.sinkhorn_iters"]
    _, divs, _ = tloop._train_epoch(graphs, recs, settings, max_atoms, torch.device("cpu"), 0)
    got = profiling.counters["fgw.sinkhorn_iters"] - before
    monkeypatch.undo()
    want = 0
    for args, kw in seen:
        _, flags = k3.fgw_couplings_plain(*args, **kw)
        want += int(flags[1].sum())
    solves = len(divs) * settings.batch_size * 2 * FGWConfig().outer_iters
    assert len(seen) == len(divs) * FGWConfig().outer_iters
    assert got == want and 5 * solves <= got <= 25 * solves
    assert all(d.shape == (2,) for d in divs)


@pytest.mark.parametrize("scale,per_solve", [(1e-3, 5), (1.0, 25)])
def test_plain_solver_counts_iterations_until_the_freeze(scale, per_solve):
    """Each PGD step's Sinkhorn solve counts the iterations that began
    before it froze: one where the first check passes, the whole budget
    where it does not; the padding of n < N changes nothing."""
    args = _problem(3, 40, scale, 5)
    T, flags = k3.fgw_couplings_plain(*args, **KW)
    assert flags.dtype == torch.int32 and flags[1].tolist() == [per_solve] * 3
    assert flags[0].tolist() == [0] * 3
    padded = [k3._padded(a, 24) for a in args]
    T_n, flags_n = k3.fgw_couplings_plain(*padded, n=40, **KW)
    assert torch.equal(flags_n, flags) and torch.equal(T_n[:, :40, :40], T)


def test_fit_history_counts_survive_a_resume(tmp_path):
    """The new history columns are present; a straight run and a resumed
    one agree on ``fgw_sinkhorn_iters`` and ``fgw_diverged`` (the time
    columns, like ``train_s_n*``, are left out)."""
    recs = random_dataset(10, 8, num_conformers=2, heavy_range=(4, 9), device="cpu")
    val = random_dataset(11, 2, num_conformers=2, heavy_range=(4, 9), device="cpu")

    def run(epochs, directory, resume=False):
        settings = tloop.TrainSettings(batch_size=4, num_epochs=epochs, learning_rate=1e-3,
                                       use_barycenter=True, max_atoms=32, seed=2)
        return tloop.fit(settings, recs, val, model=ConanModel(device="cpu", seed=2, **SMALL),
                         device="cpu", checkpointer=RunCheckpointer(str(directory)),
                         resume=resume)

    straight = run(2, tmp_path / "a")
    run(1, tmp_path / "b")
    resumed = run(2, tmp_path / "b", resume=True)
    for row in straight.history:
        assert all(isinstance(row[k], float) or row[k] == 0 for k in TIMES)
        assert row["fgw_sinkhorn_iters"] > 0 and row["graph_captures"] == row["graph_warm_ups"] == 0
        assert row["pack_s"] > 0 and row["queue_wait_s"] > 0
    keep = ("fgw_sinkhorn_iters", "fgw_diverged", "graph_captures", "graph_warm_ups")
    assert [{k: r[k] for k in keep} for r in straight.history] == \
        [{k: r[k] for k in keep} for r in resumed.history]


@pytest.mark.card
@pytest.mark.parametrize("N,n", [(32, 32), (64, 50), (128, 128)])
def test_k3_iterations_match_the_plain_solver_on_the_card(N, n):
    """K3's iteration count equals the plain solver's on solves far from
    the 1e-2 threshold (the same count with it four times lower and
    higher), half freezing early and half running the budget."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [k3._padded(a, N - n) for a in _mixed(n, N)]
    want = [k3.fgw_couplings_plain(*args, n=n, **dict(KW, sinkhorn_thr=t))[1]
            for t in (2.5e-3, 1e-2, 4e-2)]
    assert torch.equal(want[0], want[1]) and torch.equal(want[1], want[2])
    assert want[1][1].tolist() == [5] * 4 + [25] * 4
    T, flags = k3._couplings(*[a.cuda() for a in args], n=n, count="test", **KW)
    torch.cuda.synchronize()
    assert torch.equal(flags.cpu(), want[1])


@pytest.mark.card
def test_graph_captures_count_new_shapes_on_the_card():
    """Every shape with two batches or more warms up and is captured in the
    first epoch (``graphs.captures`` the shapes), and the second captures
    nothing; every step but a shape's eager first one replays
    (``graphs.replays``), and the replays' time is counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    recs, settings, graphs, max_atoms = _epoch_setup("cuda", molecules=32, seed=3)
    buckets = tloop.bucket_boundaries(max_atoms)
    per = {}
    for r in recs:
        per.setdefault(bucket_for(r.num_atoms, buckets), []).append(r)
    # the buckets of two batches or more: a shape of one batch warms up in
    # the first epoch and is captured in the second
    per = {b: rs for b, rs in per.items() if len(rs) > settings.batch_size}
    recs = [r for rs in per.values() for r in rs]
    shapes = len(per)
    assert shapes >= 1
    counts, steps = [], []
    for epoch in range(2):
        before = profiling.counters.copy()
        losses = tloop._train_epoch(graphs, recs, settings, max_atoms, torch.device("cuda"),
                                    epoch)[0]
        steps.append(len(losses))
        counts.append({k: profiling.counters[k] - before[k]
                       for k in ("graphs.captures", "graphs.warm_ups", "graphs.replays",
                                 "graphs.replay_s", "fgw.sinkhorn_iters")})
    assert counts[0]["graphs.captures"] == shapes and counts[1]["graphs.captures"] == 0
    assert counts[0]["graphs.warm_ups"] == shapes and counts[1]["graphs.warm_ups"] == 0
    assert counts[0]["graphs.replays"] == steps[0] - shapes
    assert counts[1]["graphs.replays"] == steps[1]
    assert counts[1]["graphs.replay_s"] > 0 and counts[1]["fgw.sinkhorn_iters"] > 0
