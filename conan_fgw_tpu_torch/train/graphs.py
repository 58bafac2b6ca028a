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

On the CPU the same object runs the step eagerly through the same static
buffers: there are no graphs there.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Callable, Sequence

import torch

from conan_fgw_tpu_torch.data.packing import PackedBatch
from conan_fgw_tpu_torch.ops.cuda import launches

_FIELDS = tuple(f.name for f in dataclasses.fields(PackedBatch))


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


@dataclasses.dataclass
class _Step:
    """One shape's static input buffers, and its graph once captured."""

    batch: PackedBatch
    warm: bool = False
    graph: torch.cuda.CUDAGraph | None = None
    out: tuple = ()
    grads: list | None = None
    counts: LaunchReplays = dataclasses.field(default_factory=LaunchReplays)

    @classmethod
    def like(cls, pb: PackedBatch, device: torch.device) -> "_Step":
        return cls(PackedBatch(**{
            name: torch.empty(getattr(pb, name).shape, device=device,
                              dtype=torch.from_numpy(getattr(pb, name)).dtype)
            for name in _FIELDS
        }))

    def load(self, pb: PackedBatch) -> None:
        """Copy the host batch ``pb`` into the static buffers."""
        for name in _FIELDS:
            getattr(self.batch, name).copy_(torch.from_numpy(getattr(pb, name)))


class StepGraphs:
    """The train and eval steps of one ``fit``, captured per batch shape.

    ``train_fn(batch)`` runs one train step on a device batch and returns
    ``(loss, n_div)``; ``eval_fn(batch)`` returns ``(loss, pred, n_div)``
    (``train/loop.py::step_graphs`` binds them to a model, its optimizer
    and the settings). ``params`` are the model's parameters.
    ``train(pb)``/``eval(pb)`` take a host ``PackedBatch`` and return the
    step's outputs as device tensors of their own."""

    def __init__(self, train_fn: Callable, eval_fn: Callable,
                 params: Sequence[torch.nn.Parameter], device):
        self.fns = {"train": train_fn, "eval": eval_fn}
        self.params = list(params)
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"  # the CPU runs the steps eagerly
        self.steps: dict[tuple, _Step] = {}
        # the last train step's gradients, one entry per parameter (None
        # where it had none): after a replay they are the graph's static
        # tensors, which ``p.grad`` may no longer point to
        self.grads: list = []

    def train(self, pb: PackedBatch) -> tuple:
        return self._run("train", pb)

    def eval(self, pb: PackedBatch) -> tuple:
        return self._run("eval", pb)

    def _run(self, kind: str, pb: PackedBatch) -> tuple:
        key = (kind, pb.z.shape)
        step = self.steps.get(key)
        if step is None:
            step = self.steps[key] = _Step.like(pb, self.device)
        step.load(pb)
        fn = self.fns[kind]
        if not self.graphed:
            out = fn(step.batch)
        elif step.graph is None and not step.warm:
            out = self._warm_up(step, fn)
        else:
            if step.graph is None:
                self._capture(step, fn, kind)
            step.graph.replay()
            step.counts.replayed()
            out = tuple(t.clone() for t in step.out)
        if kind == "train":
            self.grads = step.grads if step.graph is not None else [p.grad for p in self.params]
        return out

    def _warm_up(self, step: _Step, fn: Callable) -> tuple:
        """The shape's first batch, eagerly on a side stream."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = fn(step.batch)
        current.wait_stream(side)
        step.warm = True
        return out

    def _capture(self, step: _Step, fn: Callable, kind: str) -> None:
        """Capture the step into a graph of its own memory pool; its first
        replay follows."""
        graph = torch.cuda.CUDAGraph()
        with step.counts.capturing(), torch.cuda.graph(graph):
            step.out = fn(step.batch)
        step.graph = graph
        if kind == "train":
            step.grads = [p.grad for p in self.params]
