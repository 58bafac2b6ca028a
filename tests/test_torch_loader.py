"""The port's host pipeline on the CPU: the loader (``data/loader.py``) and
``loop.batch_iterator`` against the JAX package's unshuffled ones,
the prefetching iterators against the serial ones, ``Prefetcher``'s errors
and early close, the pinned-slot pool of ``train/graphs.py`` with a
stand-in for CUDA events, and ``fit``/``evaluate`` through prefetch and
the native packer (into recycled slots) against the serial numpy path,
bit for bit. Small sizes: B <= 8, N <= 64, K <= 5, SMALL model widths."""

import dataclasses
import functools
import sys
import time

import numpy as np
import pytest
import torch

from conan_fgw_tpu.data import loader as jloader
from conan_fgw_tpu.data import packing as jpacking
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu_torch.data import loader as tloader
from conan_fgw_tpu_torch.data import native as tnative
from conan_fgw_tpu_torch.data.packing import PackedBatch, batch_layout, pack_batch
from conan_fgw_tpu_torch.data.synthetic import random_dataset
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.train import graphs as tgraphs
from conan_fgw_tpu_torch.train import loop as tloop

SMALL = dict(hidden_channels=32, num_filters=32, num_gaussians=10, num_interactions=2)
FIELDS = [f.name for f in dataclasses.fields(PackedBatch)]
TIMES = ("train_s", "epoch_time_s")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One CPU thread: the bit-identity checks compare runs of the plain
    path, whose BLAS may split a product differently across a varying
    number of threads on a loaded machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def records(seed=3, n=13, k=2, heavy=(3, 25)):
    """Molecules of both the N=32 and the N=64 bucket."""
    return random_dataset(seed, n, num_conformers=k, heavy_range=heavy, device="cpu")


def as_jax(recs):
    return [jpacking.MoleculeRecord(**dataclasses.asdict(r)) for r in recs]


def assert_same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        for name in FIELDS:
            x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
            assert (x.dtype, x.shape) == (y.dtype, y.shape), name
            assert x.tobytes() == y.tobytes(), name


def _no_times(history):
    return [{k: v for k, v in row.items() if k not in TIMES and not k.startswith("train_s_n")}
            for row in history]


class FakeEvent:
    """Stands in for ``torch.cuda.Event``: a recorded copy "lands" when the
    test sets ``done`` or when it is waited on."""

    def __init__(self):
        self.done = self.waited = False

    def record(self):
        self.done = self.waited = False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = self.done = True


# ----------------------------------------------------------- loader vs JAX
@pytest.mark.parametrize("batch_size", [3, 4])
def test_batches_match_jax(batch_size):
    recs = records()
    assert_same_batches(tloader.batches(recs, batch_size, 64),
                        jloader.batches(as_jax(recs), batch_size, 64))


@pytest.mark.parametrize("batch_size", [3, 4])
def test_bucketed_batches_match_jax(batch_size):
    recs = records()
    got = list(tloader.bucketed_batches(recs, batch_size, (32, 64)))
    assert_same_batches(got, jloader.bucketed_batches(as_jax(recs), batch_size, buckets=(32, 64)))
    assert {pb.max_atoms for pb in got} == {32, 64}


@pytest.mark.parametrize("buckets", [(32, 64), tloader.DEFAULT_BUCKETS])
def test_bucket_order_matches_jax(buckets):
    recs = records(seed=4, n=17)
    assert tloader.bucket_order(recs, buckets) == jloader.bucket_order(as_jax(recs), buckets)


@pytest.mark.parametrize("prefetch", [False, True])
@pytest.mark.parametrize("bucketed", [False, True])
@pytest.mark.parametrize("native", [False, True])
def test_batch_iterator_matches_jax(bucketed, prefetch, native):
    recs = records(seed=5)
    got = tloop.batch_iterator(recs, 4, 64, prefetch=prefetch, bucketed=bucketed,
                               pack=functools.partial(tloader.pack, native=native))
    want = jloop.batch_iterator(as_jax(recs), 4, 64, prefetch=prefetch, bucketed=bucketed)
    assert_same_batches(got, want)


@pytest.mark.parametrize("batch_size", [1, 3])
def test_prefetched_iterators_give_the_serial_batches(batch_size):
    recs = records(seed=6)
    assert_same_batches(tloader.prefetched_batches(recs, batch_size, 64),
                        tloader.batches(recs, batch_size, 64, pack=pack_batch))
    assert_same_batches(
        tloader.prefetched_bucketed_batches(recs, batch_size, buckets=(32, 64)),
        tloader.bucketed_batches(recs, batch_size, (32, 64), pack=pack_batch))


# ----------------------------------------------------------- Prefetcher
def test_prefetcher_reraises_a_packer_exception():
    calls = []

    def failing(recs, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("packer failed")
        return tloader.pack(recs, **kw)

    pf = tloader.prefetched_batches(records(), 4, 64, pack=failing)
    got = []
    with pytest.raises(RuntimeError, match="packer failed"):
        for pb in pf:
            got.append(pb)
    assert len(got) == 1
    pf._thread.join(1.0)
    assert not pf._thread.is_alive()


def test_early_close_ends_the_thread_within_a_second():
    """The consumer takes one batch and closes: the thread, blocked on the
    full queue, is gone within 1 s; so after a ``break``."""
    pf = tloader.prefetched_batches(records(n=13), 1, 64)
    it = iter(pf)
    next(it)
    time.sleep(0.05)  # the thread fills the queue and blocks on it
    assert pf._thread.is_alive()
    t0 = time.perf_counter()
    pf.close()
    assert not pf._thread.is_alive() and time.perf_counter() - t0 < 1.0

    pf = tloader.prefetched_batches(records(n=13), 1, 64)
    for _ in pf:
        break
    pf._thread.join(1.0)
    assert not pf._thread.is_alive()


def test_an_exhausted_pool_raises_in_the_consumer(monkeypatch):
    """A consumer that holds more batches than the pool was sized for: the
    packer does not wait for a slot, it raises, and the consumer sees it.
    A pool with no room for a copy in flight is refused."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    layout = batch_layout(1, 2, 32)
    with pytest.raises(ValueError, match="pinned slots"):
        tgraphs.PinnedSlots(layout, tgraphs.HELD, pin=False)
    pool = tgraphs.PinnedSlots(layout, tgraphs.HELD + 1, pin=False)

    def into_slot(recs, **kw):
        return tnative.pack_batch_native(recs, out=pool.acquire(), **kw)

    held = []
    with pytest.raises(RuntimeError, match="no free pinned slot"):
        for pb in tloader.prefetched_batches(records(n=12, heavy=(3, 8)), 1, 32, pack=into_slot):
            held.append(pb)  # never staged
    assert len(held) == tgraphs.HELD + 1


# ----------------------------------------------------------- pinned slots
def _device_buffers(layout):
    """The flat static buffer a ``StepGraphs`` step would copy into (on the CPU)."""
    flat, _ = tgraphs.flat_batch(layout)
    return flat


def test_a_slot_is_reused_only_once_its_copy_has_landed(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    layout = batch_layout(2, 2, 32)
    n = tgraphs.HELD + 2  # two copies may be in flight
    pool = tgraphs.PinnedSlots(layout, n, pin=False)
    assert pool.limit == 2
    dst = _device_buffers(layout)
    slots = [pool.acquire() for _ in range(n)]
    assert len({id(x) for x in slots}) == n
    a, b, c = slots[:3]
    with pytest.raises(RuntimeError):
        pool.acquire()
    pool.stage(a, dst)
    pool.stage(b, dst)  # two copies in flight, within the limit: no wait
    (_, ev_a), (_, ev_b) = pool._in_flight
    assert not ev_a.waited and not ev_b.waited
    with pytest.raises(RuntimeError):
        pool.acquire()  # no slot is free while its copy is in flight
    ev_b.done = True
    pool.reclaim(2)  # oldest first: b waits behind a
    with pytest.raises(RuntimeError):
        pool.acquire()
    ev_a.done = True
    pool.reclaim(2)
    assert pool.acquire() is a and pool.acquire() is b

    pool.stage(c, dst)  # c in flight
    pool.stage(a, dst)  # a's event recorded again: pending
    (_, ev_c), (_, ev_a2) = pool._in_flight
    assert ev_a2 is ev_a and not ev_a.done
    pool.stage(b, dst)  # the third copy in flight: the oldest is waited for
    assert ev_c.waited and not ev_a2.waited
    assert pool.acquire() is c

    pool.reset()  # waits for the rest and frees every slot
    assert not pool._in_flight and ev_a2.waited
    assert {id(pool.acquire()) for _ in range(n)} == {id(x) for x in pool.batches}


def test_stage_copies_the_slot_bytes(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    recs = records(n=3, heavy=(3, 8))
    pool = tgraphs.PinnedSlots(batch_layout(4, 2, 32), tgraphs.HELD + 1, pin=False)
    pb = tnative.pack_batch_native(recs, max_atoms=32, batch_size=4, out=pool.acquire())
    step = tgraphs._Step.like(pb, torch.device("cpu"))
    assert step.flat.numel() == pool.flats[0].numel()
    pool.stage(pb, step.flat)  # one copy of the whole batch
    assert_same_batches([PackedBatch(**{k: getattr(step.batch, k).numpy() for k in FIELDS})],
                        [pack_batch(recs, max_atoms=32, batch_size=4)])


def test_slots_under_thread_switching_stress(monkeypatch):
    """Forty batches through the smallest pool (one copy in flight), a
    prefetch thread and a consumer that checks each batch's bytes before
    staging it, with the interpreter switching threads as often as it can:
    the packer always finds a free slot, and never writes a slot the
    consumer holds or whose copy is in flight."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    recs = records(seed=8, n=40, heavy=(3, 8))
    layout = batch_layout(1, 2, 32)
    pool = tgraphs.PinnedSlots(layout, tgraphs.HELD + 1, pin=False)
    dst = _device_buffers(layout)
    want = list(tloader.batches(recs, 1, 32, pack=pack_batch))

    def into_slot(recs, **kw):
        return tnative.pack_batch_native(recs, out=pool.acquire(), **kw)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.perf_counter()
        for i, pb in enumerate(tloader.prefetched_batches(recs, 1, 32, pack=into_slot)):
            assert pool.owns(pb)
            time.sleep(0.001)
            assert_same_batches([pb], [want[i]])
            pool.stage(pb, dst)
            if i % 2:
                pool._in_flight[0][1].done = True
        assert i == 39 and time.perf_counter() - t0 < 30
    finally:
        sys.setswitchinterval(interval)


def test_stage_allocates_a_pool_per_shape_once(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    model = ConanModel(device="cpu", **SMALL)
    settings = tloop.TrainSettings(batch_size=4)
    graphs = tloop.step_graphs(model, tloop.make_optimizer(model, settings), settings, "cpu")
    recs = records(n=9)
    assert graphs.stage(recs, 4, (32, 64)) is None  # the CPU has no slots
    graphs.slots = tgraphs.SLOTS
    assert graphs.stage(recs, 4, (32, 64)) == graphs.pack
    pools = dict(graphs.pools)
    assert set(pools) == {(4, 2, 32), (4, 2, 64)}
    graphs.stage(recs, 4, (32, 64))
    assert all(graphs.pools[k] is v for k, v in pools.items())
    pb = graphs.pack(recs[:2], max_atoms=64, batch_size=4)
    assert pools[(4, 2, 64)].owns(pb)


# ----------------------------------------------------------- the loop
def test_recycled_slot_pool_keeps_predictions_aligned(monkeypatch):
    """``evaluate`` through ``StepGraphs`` whose batches come from the
    smallest pool (five slots), twelve batches (the last one padded): each
    slot serves two or three batches, and the predictions and targets
    still line up with their records, as the serial numpy pass gives them."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    recs = records(seed=10, n=23, heavy=(3, 8))
    model = ConanModel(device="cpu", seed=2, **SMALL)
    settings = tloop.TrainSettings(batch_size=2, use_barycenter=True)
    graphs = tloop.step_graphs(model, tloop.make_optimizer(model, settings), settings, "cpu")
    graphs.slots = tgraphs.HELD + 1
    staged = []
    original = tgraphs.PinnedSlots.stage
    monkeypatch.setattr(tgraphs.PinnedSlots, "stage",
                        lambda self, pb, dst: (staged.append(id(pb)), original(self, pb, dst)))
    m_s, pred_s, y_s = tloop.evaluate(model, recs, settings, 32, "cpu", graphs)
    m_e, pred_e, y_e = tloop.evaluate(model, recs, settings, 32, "cpu", prefetch=False,
                                      native=False)
    (pool,) = graphs.pools.values()
    assert len(pool.batches) == 5
    assert len(staged) == 12 and set(staged) == {id(b) for b in pool.batches}
    np.testing.assert_array_equal(y_s, np.asarray([r.y for r in recs], np.float32))
    np.testing.assert_array_equal(y_s, y_e)
    np.testing.assert_array_equal(pred_s, pred_e)
    assert m_s == m_e


def _slotted(slots):
    def make(model, optimizer, settings, device):
        graphs = tgraphs.StepGraphs(
            lambda batch: tloop.train_step(model, optimizer, batch, settings),
            lambda batch: tloop.eval_step(model, batch, settings), model.parameters(), device)
        graphs.slots = slots
        return graphs
    return make


@pytest.mark.parametrize("slots", [tgraphs.HELD + 1, tgraphs.SLOTS])
def test_fit_prefetched_and_native_is_bit_identical_to_serial_numpy(slots, monkeypatch):
    """Three pipelines, one history: prefetch with the native packer (the
    default), the serial numpy packer, and prefetch into recycled slots per
    shape (both buckets)."""
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    recs, val = records(seed=12, n=11), records(seed=13, n=5)
    settings = tloop.TrainSettings(batch_size=3, num_epochs=2, use_barycenter=True, seed=3,
                                   learning_rate=1e-3)
    runs = {}
    for mode in ("default", "serial numpy", "slots"):
        kw = dict(prefetch=False, native=False) if mode == "serial numpy" else {}
        if mode == "slots":
            monkeypatch.setattr(tloop, "step_graphs", _slotted(slots))
        runs[mode] = tloop.fit(settings, recs, val, model=ConanModel(device="cpu", seed=1, **SMALL),
                               device="cpu", **kw)
    assert set(runs["slots"].graphs.pools) == {(3, 2, 32), (3, 2, 64)}
    assert not runs["default"].graphs.pools
    want = runs["serial numpy"]
    for mode in ("default", "slots"):
        assert _no_times(runs[mode].history) == _no_times(want.history), mode
        for p, q in zip(runs[mode].model.parameters(), want.model.parameters()):
            assert torch.equal(p, q), mode


def test_fit_epoch_order_is_the_jax_loops(monkeypatch):
    """Every epoch's batches come in the order of the JAX loop's unshuffled
    bucketed ``batch_iterator``."""
    recs, val = records(seed=14, n=10), records(seed=15, n=3)
    settings = tloop.TrainSettings(batch_size=3, num_epochs=2, seed=4)
    seen = []
    original = tgraphs.StepGraphs.train
    monkeypatch.setattr(tgraphs.StepGraphs, "train",
                        lambda self, pb: (seen.append(pb.y.copy()), original(self, pb))[1])
    tloop.fit(settings, recs, val, model=ConanModel(device="cpu", **SMALL), device="cpu")
    max_atoms = tloop.dataset_max_atoms(recs + val)
    want = [pb.y for _ in range(2) for pb in jloop.batch_iterator(
        as_jax(recs), 3, max_atoms, bucketed=True, prefetch=False)]
    assert len(seen) == len(want)
    for a, b in zip(seen, want):
        np.testing.assert_array_equal(a, b)


def test_evaluate_follows_the_bucket_order():
    """Evaluation's targets come in ``bucket_order``, which predict uses to
    align its outputs with their records."""
    recs = records(seed=16, n=10)
    model = ConanModel(device="cpu", **SMALL)
    max_atoms = tloop.dataset_max_atoms(recs)
    order = tloader.bucket_order(recs, tloop.bucket_boundaries(max_atoms))
    assert order != sorted(order)
    _, _, y = tloop.evaluate(model, recs, tloop.TrainSettings(batch_size=3), max_atoms, "cpu")
    np.testing.assert_array_equal(y, np.asarray([recs[i].y for i in order], np.float32))
