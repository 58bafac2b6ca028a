"""Train and eval steps captured as CUDA graphs, one per batch shape (the
port's counterpart of the JAX package's ``make_multi_step`` and
``make_eval_scan``, ``conan_fgw_tpu/train/loop.py``).

JAX stacks ``scan_chunk`` same-shape batches and runs one ``lax.scan`` of
the step per dispatch. Here each batch shape's whole step (forward with the
barycenter, loss, backward, clip and Adam; or the eval forward) is captured
once as a ``torch.cuda.CUDAGraph`` and then replayed once per batch from
static input buffers: a few host calls per step in place of about a
thousand kernel launches.

Per shape and kind (train or eval): the first batch runs the step eagerly
on a side stream. It is a real step of the epoch, and it makes what is
created lazily (Adam's state, the kernels' one-time function attributes,
cuBLAS's handles) before capture. The second batch is captured and then
replayed, so it also runs once. Every later batch is copied into the
static buffers and replayed. Each graph keeps its own memory pool; the
train step sets the gradients to None before its forward, so that backward
allocates them in the pool, and ``StepGraphs.grads`` holds them. Callers
get clones of the static outputs: without them every loss of an epoch
would alias the last replay.

The graphs stay valid while everything that touches the weights writes
them in place: Adam's foreach update, ``RunCheckpointer.restore_params``
(``copy_``) and ``set_learning_rate`` (a ``fill_`` of the optimizer's lr
tensor). ``RunCheckpointer.restore_state`` replaces Adam's state tensors,
so it must run before the first capture, as ``fit`` does. A capture or
replay that fails raises; nothing falls back to the eager step on the card.

Batches reach the static buffers from pinned host memory
(``PinnedSlots``): ``StepGraphs.stage`` readies a small pool of pinned
batches per shape before a pass over the data, the prefetch thread packs
each batch natively into a free one (``StepGraphs.pack``), and ``_run``
copies it with ``non_blocking`` copies on the current stream, so the host
neither packs nor waits for the stream on the step's path. The static
buffers stay single: stream order serialises a copy, the replay that
reads it and the next copy. A batch that is not a slot's (a plain numpy
batch) is copied synchronously.

Under data parallelism (``reduce`` given, ``train/loop.py::SplitStep``)
every step also takes the global batch's real molecules as a 0-d static
input (``_Step.rows``, written in place before each step), the buffers and
pinned slots take the rank's rows, ``(batch_size // world, K, N)``, and the
train step is two graphs per shape: the first ends with the gradients in
``SplitStep``'s flat buffer, the all-reduce runs on the current stream
between the two replays (through the host with gloo, enqueued with NCCL),
and the second reads the buffer back, clips and steps Adam. A collective
inside a capture is later work. Without ``reduce`` the train step stays one
graph per shape.

Gradient accumulation (``accumulation`` given,
``train/loop.py::Accumulation``) makes two train kinds per shape, each
captured as its own graph: ``"train"``, a mini-step that only adds its
gradients to the running mean, and ``"train_update"``, one that also
clips and steps Adam. The host knows the mini-step count and picks which
to replay; the count's ``m + 1`` reaches the graphs through the
accumulation's 0-d device tensor, written before the replay, so nothing
branches inside a graph. Without it the train step stays one graph per
shape.

On the CPU the same object runs the step eagerly through the same static
buffers: there are no graphs and no pinned slots there.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import queue
from typing import Callable, Sequence

import numpy as np
import torch

from conan_fgw_tpu_torch.data.loader import DEPTH
from conan_fgw_tpu_torch.data.native import pack_batch_native
from conan_fgw_tpu_torch.data.packing import (
    MoleculeRecord,
    PackedBatch,
    batch_layout,
    bucket_for,
)
from conan_fgw_tpu_torch.ops.cuda import launches

_FIELDS = tuple(f.name for f in dataclasses.fields(PackedBatch))
# pinned host batches a pass over the data may hold besides the copies in
# flight: the prefetch queue's DEPTH, the one the consumer holds before its
# copy, and the one being packed
HELD = DEPTH + 2
SLOTS = HELD + 2  # per shape: two copies may be in flight


class LaunchReplays:
    """Kernel launch counts of one captured graph (``ops.cuda.launches``).

    The kernels' wrappers count once while the graph is captured, though
    nothing runs then, and not at all when it is replayed. The capture's
    count stands for the first replay, and every later replay adds the
    delta the capture counted, so ``launches`` counts kernel executions as
    it does for eager steps."""

    def __init__(self):
        self.delta: dict[str, int] = {}
        self.replays = 0

    @contextlib.contextmanager
    def capturing(self):
        before = collections.Counter(launches)
        yield
        self.delta = {k: v - before[k] for k, v in launches.items() if v != before[k]}

    def replayed(self) -> None:
        if self.replays:
            launches.update(self.delta)
        self.replays += 1


def flat_batch(layout: dict, **empty_kw) -> tuple[torch.Tensor, PackedBatch]:
    """One uint8 buffer (``torch.empty(..., **empty_kw)``) holding every
    field of a batch of ``layout`` (``{field: (shape, numpy dtype)}``),
    each at a 64-byte-aligned offset, and the ``PackedBatch`` of its typed
    views: a whole batch moves between two such buffers in one copy."""
    spans, total = {}, 0
    for name, (shape, dtype) in layout.items():
        nbytes = int(np.prod(shape)) * np.dtype(dtype).itemsize
        spans[name] = slice(total, total + nbytes)
        total += -(-nbytes // 64) * 64
    flat = torch.empty(total, dtype=torch.uint8, **empty_kw)
    views = {}
    for name, (shape, dtype) in layout.items():
        typed = torch.from_numpy(np.empty(0, dtype)).dtype
        views[name] = flat[spans[name]].view(typed).view(shape)
    return flat, PackedBatch(**views)


def host_batch(layout: dict, pin: bool) -> tuple[torch.Tensor, PackedBatch]:
    """A flat host buffer (``flat_batch``, pinned with ``pin``) and the
    ``PackedBatch`` of numpy views of it that a packer fills (bool stays
    bool: the native packer writes through a uint8 view of it)."""
    flat, views = flat_batch(layout, pin_memory=pin)
    return flat, PackedBatch(**{name: getattr(views, name).numpy() for name in _FIELDS})


@dataclasses.dataclass
class _Step:
    """One shape's static input buffers (views of one flat device buffer;
    under data parallelism also ``rows``, the global batch's real
    molecules), and its graph once captured (a split train step's second
    half in ``after``)."""

    flat: torch.Tensor
    batch: PackedBatch
    rows: torch.Tensor | None = None
    warm: bool = False
    graph: torch.cuda.CUDAGraph | None = None
    after: torch.cuda.CUDAGraph | None = None
    out: tuple = ()
    grads: list | None = None
    counts: LaunchReplays = dataclasses.field(default_factory=LaunchReplays)

    @classmethod
    def like(cls, pb: PackedBatch, device: torch.device, rows: bool = False) -> "_Step":
        flat, batch = flat_batch(batch_layout(*pb.z.shape), device=device)
        return cls(flat, batch, torch.zeros((), device=device) if rows else None)

    def load(self, pb: PackedBatch) -> None:
        """Copy the host batch ``pb`` into the static buffers (from
        pageable memory, so the copy waits for the stream)."""
        for name in _FIELDS:
            getattr(self.batch, name).copy_(torch.from_numpy(getattr(pb, name)))


class PinnedSlots:
    """A pool of ``n`` host batches of one shape (pinned with ``pin``),
    reused from pass to pass.

    A packer takes a free slot's batch (``acquire``, any thread), packs
    into its numpy views and hands it on. The main thread copies it to the
    device (``stage``) and records an event after the copy; the slot is
    free again only once that event has completed, so a packer never
    writes bytes still in flight. Only the main thread records, queries or
    waits on events: it frees the slots whose copies have landed at each
    ``stage``, and waits for the oldest copy while more than ``n - HELD``
    are in flight. A pass holds at most ``HELD`` slots besides those, so a
    packer always finds a free one and never waits."""

    def __init__(self, layout: dict, n: int, pin: bool):
        if n <= HELD:
            raise ValueError(f"{n} pinned slots: a pass may hold {HELD} besides its copies")
        self.limit = n - HELD  # copies in flight
        self.flats, self.batches = map(list, zip(*(host_batch(layout, pin) for _ in range(n))))
        self._index = {id(b): i for i, b in enumerate(self.batches)}
        # each slot's event, recorded after its copy
        self._events = [torch.cuda.Event() for _ in range(n)]
        self._in_flight: collections.deque = collections.deque()  # (slot, event), oldest first
        self.reset()

    def owns(self, pb: PackedBatch) -> bool:
        return id(pb) in self._index

    def acquire(self) -> PackedBatch:
        """A free slot's batch (any thread, without waiting)."""
        try:
            return self.batches[self._free.get_nowait()]
        except queue.Empty:
            raise RuntimeError(f"no free pinned slot of {len(self.batches)}: the pass holds"
                               f" more than {HELD} besides its copies in flight") from None

    def stage(self, pb: PackedBatch, dst: torch.Tensor) -> None:
        """Copy the slot batch ``pb`` into the flat device buffer ``dst``
        (of the same layout) on the current stream, in one copy, without
        waiting for it (main thread)."""
        i = self._index[id(pb)]
        dst.copy_(self.flats[i], non_blocking=True)
        event = self._events[i]
        event.record()
        self._in_flight.append((i, event))
        self.reclaim(self.limit)

    def reclaim(self, limit: int) -> None:
        """Free the slots whose copies have landed, oldest first, waiting
        for copies while more than ``limit`` are in flight (main thread)."""
        while self._in_flight:
            i, event = self._in_flight[0]
            if len(self._in_flight) > limit:
                event.synchronize()
            elif not event.query():
                return
            self._in_flight.popleft()
            self._free.put(i)

    def reset(self) -> None:
        """Wait for every copy in flight and free every slot, for a new
        pass (main thread; no packer may be running)."""
        self.reclaim(0)
        self._free: queue.Queue = queue.Queue()
        for i in range(len(self.batches)):
            self._free.put(i)


class StepGraphs:
    """The train and eval steps of one ``fit``, captured per batch shape.

    ``train_fn(batch)`` runs one train step on a device batch and returns
    ``(loss, n_div)``; ``eval_fn(batch)`` returns ``(loss, pred, n_div)``
    (``train/loop.py::step_graphs`` binds them to a model, its optimizer
    and the settings). ``params`` are the model's parameters.
    ``train(pb)``/``eval(pb)`` take a host ``PackedBatch`` and return the
    step's outputs as device tensors of their own. Before a pass over the
    data, ``stage`` readies the pinned slots of its batch shapes and
    returns ``pack``, which packs a batch into one of them.

    With ``reduce`` (data parallelism), ``train_fn`` is the pair
    ``(before, after)``: ``before(batch, rows)`` returns nothing,
    ``reduce()`` sums its results over the ranks, and ``after()`` returns
    ``(loss, n_div)``; ``eval_fn(batch, rows)``. ``rows`` is the host
    batch's ``global_rows`` as a 0-d tensor.

    With an ``accumulation``, ``train_fn`` is the mini-step that only
    accumulates and ``train_update_fn`` (of the same form) the one that
    also updates; ``train`` picks one by the accumulation's count."""

    def __init__(self, train_fn, eval_fn: Callable, params: Sequence[torch.nn.Parameter],
                 device, reduce: Callable | None = None, accumulation=None,
                 train_update_fn=None):
        self.fns = {"train": train_fn, "eval": eval_fn}
        self.accumulation = accumulation
        if accumulation is not None:
            self.fns["train_update"] = train_update_fn
        self.reduce = reduce
        self.params = list(params)
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"  # the CPU runs the steps eagerly
        self.steps: dict[tuple, _Step] = {}
        # the last train step's gradients, one entry per parameter (None
        # where it had none): after a replay they are the graph's static
        # tensors, which ``p.grad`` may no longer point to
        self.grads: list = []
        # pinned host slots per batch shape (B, K, N); the CPU has none
        self.slots = SLOTS if self.graphed else 0
        self.pools: dict[tuple, PinnedSlots] = {}

    def stage(self, records: Sequence[MoleculeRecord], batch_size: int,
              buckets: Sequence[int]) -> Callable | None:
        """Ready the pinned slots of every batch shape that ``records``
        reach in ``buckets``, for one pass over them (main thread, no
        packer running): allocate a shape's pool the first time, wait for
        copies still in flight and free every slot. Returns ``pack``, or
        None where there are no slots."""
        if not self.slots or not records:
            return None
        K = records[0].num_conformers
        for n in sorted({bucket_for(r.num_atoms, buckets) for r in records}):
            if (batch_size, K, n) not in self.pools:
                self.pools[(batch_size, K, n)] = PinnedSlots(
                    batch_layout(batch_size, K, n), self.slots, pin=self.device.type == "cuda")
        for pool in self.pools.values():
            pool.reset()
        return self.pack

    def pack(self, records: Sequence[MoleculeRecord], *, max_atoms: int,
             batch_size: int) -> PackedBatch:
        """Pack ``records`` natively into a free pinned slot of their
        shape (any thread)."""
        pool = self.pools[(batch_size, records[0].num_conformers, max_atoms)]
        return pack_batch_native(records, max_atoms=max_atoms, batch_size=batch_size,
                                 out=pool.acquire())

    def train(self, pb: PackedBatch) -> tuple:
        if self.accumulation is None:
            return self._run("train", pb)
        out = self._run("train_update" if self.accumulation.begin() else "train", pb)
        self.accumulation.end()
        return out

    def eval(self, pb: PackedBatch) -> tuple:
        return self._run("eval", pb)

    def _run(self, kind: str, pb: PackedBatch) -> tuple:
        key = (kind, pb.z.shape)
        step = self.steps.get(key)
        if step is None:
            step = self.steps[key] = _Step.like(pb, self.device, self.reduce is not None)
        self._load(step, pb)
        fn = self.fns[kind]
        if not self.graphed:
            out = self._eager(step, fn)
        elif step.graph is None and not step.warm:
            out = self._warm_up(step, fn)
        else:
            if step.graph is None:
                self._capture(step, fn, kind)
            step.graph.replay()
            if step.after is not None:
                self.reduce()
                step.after.replay()
            step.counts.replayed()
            out = tuple(t.clone() for t in step.out)
        if kind != "eval":
            self.grads = step.grads if step.graph is not None else [p.grad for p in self.params]
        return out

    def _load(self, step: _Step, pb: PackedBatch) -> None:
        """Stage a slot batch without waiting; copy any other batch. Under
        data parallelism also write its ``global_rows`` into ``step.rows``."""
        if step.rows is not None:
            if pb.global_rows is None:
                raise ValueError("a data-parallel step needs the global batch's rows"
                                 " (parallel/mesh.py::rank_packer)")
            step.rows.fill_(pb.global_rows)
        pool = self.pools.get(pb.z.shape)
        if pool is not None and pool.owns(pb):
            pool.stage(pb, step.flat)
        else:
            step.load(pb)

    def _args(self, step: _Step) -> tuple:
        return (step.batch,) if step.rows is None else (step.batch, step.rows)

    def _eager(self, step: _Step, fn) -> tuple:
        """The step without graphs; a split train step (``fn`` a pair) with
        its all-reduce."""
        if isinstance(fn, tuple):
            before, after = fn
            before(*self._args(step))
            self.reduce()
            return after()
        return fn(*self._args(step))

    def _warm_up(self, step: _Step, fn) -> tuple:
        """The shape's first batch, eagerly on a side stream, which waits
        for the current stream's work: the batch's copy too."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = self._eager(step, fn)
        current.wait_stream(side)
        step.warm = True
        return out

    def _capture(self, step: _Step, fn, kind: str) -> None:
        """Capture the step into a graph of its own memory pool (a split
        train step into two, around its all-reduce, which is not
        captured); its first replay follows. The batch's copy was issued
        before, and entering ``torch.cuda.graph`` synchronises the device:
        the copy lands before the capture and is never recorded into the
        graph."""
        split = isinstance(fn, tuple)
        graph = torch.cuda.CUDAGraph()
        with step.counts.capturing():
            with torch.cuda.graph(graph):
                out = (fn[0] if split else fn)(*self._args(step))
            if split:
                step.after = torch.cuda.CUDAGraph()
                with torch.cuda.graph(step.after):
                    out = fn[1]()
        step.out = out
        step.graph = graph
        if kind != "eval":
            step.grads = [p.grad for p in self.params]
