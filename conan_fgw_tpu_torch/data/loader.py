"""Host data loader: batch packing and background prefetch.

Port of ``conan_fgw_tpu/data/loader.py``. Batches are packed with the
native C++ packer (``data/native.py``) unless a caller passes another
``pack`` (the numpy ``packing.pack_batch``, or a packer that writes into
pinned host memory, ``train/graphs.py::StepGraphs.pack``), and prefetched
on a background thread so that packing overlaps the device's steps. The
order is the input's (the reference's loaders do not shuffle) unless a
caller asks for ``shuffle``: then ``rng`` permutes the records as the JAX
loader's does, drawing in the same order (the record indices; with buckets
the bucket order, then each bucket's records in first-seen order), so the
same generator gives the same batches molecule by molecule.

Each batch's packing is the span ``pack``, its seconds added to
``pipeline.pack_s`` and one to ``pipeline.packs`` (``utils/profiling.py``'s
counters; on a prefetch thread no profiler records, so there they are
counters alone); the consumer's waits for
the prefetch thread are the span ``queue_wait`` (``pipeline.queue_wait_s``),
and the thread's end in ``close`` the span ``epoch_end``.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Callable, Iterator, Sequence

import numpy as np

from conan_fgw_tpu_torch.data.native import pack_batch_native
from conan_fgw_tpu_torch.data.packing import (
    DEFAULT_BUCKETS,
    MoleculeRecord,
    PackedBatch,
    bucket_for,
    pack_batch,
)
from conan_fgw_tpu_torch.utils.profiling import add, span

DEPTH = 2  # batches a Prefetcher's queue holds ahead of its consumer
_DONE = object()  # the end of a prefetch queue


def shard_range(n: int, process_index: int, process_count: int) -> range:
    """Process ``process_index``'s contiguous share of ``n`` items, the last
    one shorter (``DistributedSampler(shuffle=False)``'s split)."""
    per = (n + process_count - 1) // process_count
    start = process_index * per
    return range(start, min(start + per, n))


def pack(records: Sequence[MoleculeRecord], *, native: bool = True, **kw) -> PackedBatch:
    """One padded batch: the native packer, or with ``native=False`` the
    numpy one (byte for byte the same)."""
    return (pack_batch_native if native else pack_batch)(records, **kw)


def _packed(pack: Callable, records: list, max_atoms: int, batch_size: int) -> PackedBatch:
    """``pack(records, ...)``, counted in ``pipeline.pack_s`` and
    ``pipeline.packs``."""
    with span("pack", counter="pipeline.pack_s"):
        pb = pack(records, max_atoms=max_atoms, batch_size=batch_size)
    add("pipeline.packs", 1)
    return pb


def batches(records: Sequence[MoleculeRecord], batch_size: int, max_atoms: int, *,
            shuffle: bool = False, rng: np.random.Generator | None = None,
            pack: Callable = pack) -> Iterator[PackedBatch]:
    """Batches in input order, or with ``shuffle`` in the order of one
    ``rng.shuffle`` of the record indices, every one padded to
    ``max_atoms`` atoms and ``batch_size`` molecules."""
    idx = np.arange(len(records))
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    for s in range(0, len(idx), batch_size):
        yield _packed(pack, [records[i] for i in idx[s : s + batch_size]], max_atoms, batch_size)


def _groups(records: Sequence[MoleculeRecord], buckets) -> dict[int, list[int]]:
    """Record indices by bucket: groups in first-seen order, input order
    within each."""
    groups: dict[int, list[int]] = {}
    for i, r in enumerate(records):
        groups.setdefault(bucket_for(r.num_atoms, buckets), []).append(i)
    return groups


def bucketed_batches(records: Sequence[MoleculeRecord], batch_size: int,
                     buckets=DEFAULT_BUCKETS, *, shuffle: bool = False,
                     rng: np.random.Generator | None = None,
                     pack: Callable = pack) -> Iterator[PackedBatch]:
    """Atom-count-bucketed batching in input order: group molecules by
    padded size, groups in first-seen order, then emit full-width batches
    (the last of each group padded via ``mol_mask``). A bucket's batches
    come one after another. With ``shuffle``, ``rng`` shuffles the order of
    the buckets and then each bucket's records, buckets taken in first-seen
    order, as the JAX loader does."""
    groups = _groups(records, buckets)
    order = list(groups)
    if shuffle:
        rng = rng or np.random.default_rng()
        rng.shuffle(order)
        for idx in groups.values():
            rng.shuffle(idx)
    for b in order:
        idx = groups[b]
        for s in range(0, len(idx), batch_size):
            yield _packed(pack, [records[i] for i in idx[s : s + batch_size]], b, batch_size)


def bucket_order(records: Sequence[MoleculeRecord], buckets=DEFAULT_BUCKETS) -> list[int]:
    """The record permutation ``bucketed_batches`` emits unshuffled. Callers that align
    per-record outputs (predictions, embeddings) with their input records
    reindex through this."""
    return [i for idx in _groups(records, buckets).values() for i in idx]


class Prefetcher:
    """Wrap a batch iterator with a ``DEPTH``-deep background prefetch queue.

    The thread runs ``iterator``; an exception there is re-raised in the
    consumer. ``close()`` stops the thread and waits for it: iterating to
    the end, or leaving the iteration early (``break``, an exception, a
    generator closed), calls it. The thread checks its stop flag after each
    put, and ``close`` empties the queue, so a thread blocked on the full
    queue gets its put through and ends."""

    def __init__(self, iterator: Iterator):
        self._queue: queue.Queue = queue.Queue(maxsize=DEPTH)
        self._stop = threading.Event()
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._fill, args=(iterator,), daemon=True)
        self._thread.start()

    def _fill(self, iterator):
        try:
            for item in iterator:
                self._queue.put(item)
                if self._stop.is_set():
                    return
        except BaseException as e:  # propagate to the consumer
            self._err = e
        self._queue.put(_DONE)

    def __iter__(self):
        try:
            while True:
                with span("queue_wait", counter="pipeline.queue_wait_s"):
                    item = self._queue.get()
                if item is _DONE:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            self.close()

    def close(self) -> None:
        """Stop the thread and wait for it to end. After the stop flag is
        set the thread makes at most one more put, which the emptied queue
        takes without blocking."""
        with span("epoch_end"):
            self._stop.set()
            with contextlib.suppress(queue.Empty):
                while True:
                    self._queue.get_nowait()
            self._thread.join()


def prefetched_batches(records, batch_size, max_atoms, *, shuffle=False, rng=None,
                       pack: Callable = pack) -> Prefetcher:
    return Prefetcher(batches(records, batch_size, max_atoms, shuffle=shuffle, rng=rng, pack=pack))


def prefetched_bucketed_batches(records, batch_size, *, buckets=DEFAULT_BUCKETS, shuffle=False,
                                rng=None, pack: Callable = pack) -> Prefetcher:
    return Prefetcher(bucketed_batches(records, batch_size, buckets, shuffle=shuffle, rng=rng,
                                       pack=pack))
