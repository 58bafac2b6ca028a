"""Train step and epoch loop (port of ``conan_fgw_tpu/train/loop.py``).

One train step: forward (including the batched FGW barycenter in stage 2),
the task's loss (masked MSE for regression; for classification the stable
logit-space BCE scaled by ``loss_scale``), backward, global-norm clip at 1.0
written as ``optax.clip_by_global_norm`` with multi-tensor ops, and Adam
(``torch.optim.Adam``, whose update equals optax's). On the card Adam is
capturable and its learning rate a 0-d tensor on the device, which
``set_learning_rate`` writes in place. ``fit`` runs epochs over
atom-count-bucketed batches with the LR plateau schedule and early stopping
on ``val_loss``, keeps the ``best`` checkpoint by ``TrainSettings.monitor``
(higher is better for ``val_auroc``, ``val_mean`` and ``val_prc``, lower for
the rest) and the ``last`` and ``last_state`` ones every epoch, and resumes
from ``last_state``. ``fit(..., model=m)`` continues from the weights ``m``
holds; the runner loads stage 1's ``best`` into ``m`` for the stage-2 warm
start. ``fit``'s train and eval steps go through
``train/graphs.py::StepGraphs``, the counterpart of the JAX package's
``scan_chunk`` training: on the card each bucket shape's whole step is one
CUDA graph, replayed once per batch, whatever a config's ``scan_chunk``.
Their batches come through ``batch_iterator``, as the JAX package's do:
packed natively on a prefetch thread, on the card straight into
``StepGraphs``' pinned slots.

``TrainSettings.accumulate_steps`` k > 1 accumulates gradients over k
mini-steps before each update, as the JAX package wraps Adam in
``optax.MultiSteps`` (``Accumulation``): a running mean of the mini-steps'
gradients, and on every k-th mini-step the clip and Adam on the mean; the
other mini-steps leave the weights and Adam's state as they were. On the
card each shape then has two train graphs, one that accumulates and one
that accumulates and updates; the host picks one by the mini-step count.

Data parallelism (``fit(..., mesh=...)``, ``parallel/``): one process per
rank consumes the global batch stream, packs its row block of each batch
and divides its masked loss sum by the global batch's real molecules; the
train step is split around one all-reduce of the gradients
(``SplitStep``), and ``evaluate`` gathers every rank's predictions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import itertools
import logging
import time
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from conan_fgw_tpu_torch.data import loader as loader_lib
from conan_fgw_tpu_torch.data.packing import (
    DEFAULT_BUCKETS,
    MoleculeRecord,
    PackedBatch,
    bucket_for,
)
from conan_fgw_tpu_torch.device import resolve_device
from conan_fgw_tpu_torch.parallel import collectives
from conan_fgw_tpu_torch.parallel import mesh as mesh_lib
from conan_fgw_tpu_torch.train import metrics as metrics_lib
from conan_fgw_tpu_torch.train.graphs import StepGraphs
from conan_fgw_tpu_torch.utils import profiling

log = logging.getLogger("conan_fgw_tpu_torch")

# eval-guard outlier threshold, in label standard deviations (the JAX
# package's GUARD_SIGMAS: far outside any legitimate regressor output, and
# never reached by ordinary bad fits)
GUARD_SIGMAS = 50.0
# monitors for which a higher value is better
MAXIMIZED = ("val_auroc", "val_mean", "val_prc")
# fit's history columns of an epoch's change in the program's counters
COUNTER_COLUMNS = {
    "fgw_sinkhorn_iters": "fgw.sinkhorn_iters",
    "queue_wait_s": "pipeline.queue_wait_s",
    "pack_s": "pipeline.pack_s",
    "slot_wait_s": "graphs.slot_wait_s",
    "replay_s": "graphs.replay_s",
    "graph_captures": "graphs.captures",
    "graph_warm_ups": "graphs.warm_ups",
}


@dataclasses.dataclass
class TrainSettings:
    """Optimisation settings; defaults mirror the reference regression task."""

    task: str = "regression"  # or "classification"
    # classification: the BCE's scalar class-weight rescale (the runner's
    # class_weight_ratio of the train split); None is 1
    loss_scale: float | None = None
    trade_off: bool = False  # classification: also report mean = (auroc + prc) / 2
    learning_rate: float = 5e-4
    num_epochs: int = 80
    batch_size: int = 24
    grad_clip: float = 1.0
    plateau_patience: int = 10
    plateau_factor: float = 0.8
    es_patience: int = 50
    es_min_delta: float = 1e-4
    use_barycenter: bool = False
    monitor: str = "val_mse"  # the history key that picks `best` (see MAXIMIZED)
    seed: int = 5
    max_atoms: int | None = None  # the largest bucket; None: the data's
    # shuffle the training batches every epoch with np.random.default_rng([seed,
    # epoch]), as the JAX package does (the reference's loaders do not)
    shuffle: bool = False
    # atom-count-bucketed batching: each batch padded to its molecules'
    # bucket of bucket_boundaries(max_atoms); False pads every batch to
    # max_atoms, one graph shape
    bucketed: bool = True
    # flag non-finite and outlier predictions in `evaluate` (pred_outliers)
    eval_guard: bool = False
    # mini-steps a gradient update averages over (optax.MultiSteps'
    # every_k_schedule); 1 updates every step
    accumulate_steps: int = 1


def _denominator(w: torch.Tensor, rows: torch.Tensor | None) -> torch.Tensor:
    """``max(real molecules, 1)``: the batch's own, or under data
    parallelism the global batch's ``rows`` (a 0-d tensor), so that the
    ranks' losses sum to the global batch's mean."""
    return torch.clamp(w.sum() if rows is None else rows, min=1.0)


def masked_mse(pred: torch.Tensor, batch, rows: torch.Tensor | None = None) -> torch.Tensor:
    """Mean squared error over real molecules (``mol_mask``), divided by
    ``rows`` where given (``_denominator``)."""
    y = batch.y[:, None]
    w = batch.mol_mask.to(pred.dtype)[:, None]
    denom = _denominator(w, rows)
    sq = torch.where(w > 0, (pred - y) ** 2, torch.zeros_like(pred))
    return sq.sum() / denom


def masked_bce(pred: torch.Tensor, batch, scale: float | None = None,
               rows: torch.Tensor | None = None) -> torch.Tensor:
    """Binary cross-entropy of logits over real molecules, times ``scale``:
    the stable form ``max(z, 0) - z y + log1p(exp(-|z|))``. The model
    returns logits; this equals the reference's probability-space BCE with
    its class-weight rescale, and keeps a gradient where the sigmoid
    saturates in f32. ``rows`` as in ``masked_mse``."""
    y = batch.y[:, None]
    w = batch.mol_mask.to(pred.dtype)[:, None]
    denom = _denominator(w, rows)
    bce = torch.clamp(pred, min=0.0) - pred * y + torch.log1p(torch.exp(-pred.abs()))
    total = torch.where(w > 0, bce, torch.zeros_like(bce)).sum() / denom
    return (1.0 if scale is None else scale) * total


def task_loss(pred: torch.Tensor, batch, settings: "TrainSettings",
              rows: torch.Tensor | None = None) -> torch.Tensor:
    """The loss of ``settings.task``: masked MSE, or the scaled masked BCE
    (``rows`` as in ``masked_mse``)."""
    if settings.task == "regression":
        return masked_mse(pred, batch, rows)
    return masked_bce(pred, batch, settings.loss_scale, rows)


def clip_by_global_norm_(params: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale gradients in place as ``optax.clip_by_global_norm``: unchanged
    when the global norm is below ``max_norm``, else ``g * max_norm / norm``
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``). Multi-tensor
    ops, a factor chosen on the device: a few launches in all, no host
    sync, so a CUDA graph can hold it."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    factor = torch.where(norm >= max_norm, max_norm / norm, torch.ones_like(norm))
    torch._foreach_mul_(grads, factor)
    return norm


def make_optimizer(model: torch.nn.Module, settings: TrainSettings) -> torch.optim.Optimizer:
    """Adam with optax's defaults. On the card it is capturable and its lr
    a 0-d float32 tensor on the device: a graph captured with a float lr
    would keep that value in its kernels and miss the plateau schedule's
    changes. The CPU keeps a float lr (torch refuses capturable there)."""
    params = list(model.parameters())
    dev = params[0].device
    if dev.type == "cuda":
        lr = torch.tensor(settings.learning_rate, dtype=torch.float32, device=dev)
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=True)
    return torch.optim.Adam(params, lr=settings.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    """Set every group's lr: a tensor lr is written in place, so captured
    steps read the new value."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            group["lr"].fill_(lr)
        else:
            group["lr"] = lr


class Accumulation:
    """``optax.MultiSteps``' state beside Adam, for ``accumulate_steps`` k:
    ``acc``, the running mean of this accumulation's gradients (one tensor
    per parameter, zero where none came yet), and ``m``, its mini-steps so
    far (``MultiStepsState.mini_step``), a host integer.

    ``begin()`` before each mini-step writes ``m + 1`` into ``divisor``, a
    0-d device tensor that a captured step reads, and says whether this
    mini-step updates; ``fold(update)`` inside the step takes the fresh
    gradients into the mean, ``acc += (g - acc) / (m + 1)`` (a division,
    as optax divides), and on an update leaves the mean in the gradients
    for the clip and Adam and zeroes ``acc``; ``end()`` after the step
    moves ``m`` on, back to 0 after an update."""

    def __init__(self, params, k: int, device):
        if k < 2:
            raise ValueError(f"accumulate_steps={k}: an accumulation has at least 2 mini-steps")
        self.k = k
        self.params = list(params)
        self.acc = [torch.zeros_like(p) for p in self.params]
        self.m = 0
        self.divisor = torch.ones((), dtype=torch.float32, device=device)

    def begin(self) -> bool:
        self.divisor.fill_(self.m + 1)
        return self.m == self.k - 1

    def end(self) -> None:
        self.m = (self.m + 1) % self.k

    def fold(self, update: bool) -> None:
        pairs = [(p.grad, a) for p, a in zip(self.params, self.acc) if p.grad is not None]
        grads, acc = [g for g, _ in pairs], [a for _, a in pairs]
        torch._foreach_sub_(grads, acc)
        torch._foreach_div_(grads, self.divisor)
        torch._foreach_add_(acc, grads)
        if update:
            torch._foreach_copy_(grads, acc)
            torch._foreach_zero_(acc)


def make_accumulation(model, settings: TrainSettings, device) -> Accumulation | None:
    """The ``Accumulation`` of ``settings.accumulate_steps``, or None for 1."""
    if settings.accumulate_steps == 1:
        return None
    return Accumulation(model.parameters(), settings.accumulate_steps, device)


def _apply(model, optimizer, settings: TrainSettings, accumulation, update: bool) -> None:
    """After the backward: fold the gradients into ``accumulation`` (if
    any), then on an update the global-norm clip and Adam."""
    if accumulation is not None:
        accumulation.fold(update)
    if update:
        clip_by_global_norm_(list(model.parameters()), settings.grad_clip)
        optimizer.step()


def train_step(model, optimizer, batch, settings: TrainSettings,
               accumulation: Accumulation | None = None, update: bool = True):
    """One optimisation step; returns ``(loss, n_div)`` as device tensors,
    ``n_div`` the model's ``(2,)`` int64 count of the step's FGW solves that
    rolled back a Sinkhorn failure and of their Sinkhorn iterations
    (``ops/fgw/barycenter.py``). Gradients are set to None first, so under
    capture backward allocates them in the graph's memory pool. With an
    ``accumulation`` it is a mini-step, which updates the weights only where
    ``update``."""
    optimizer.zero_grad(set_to_none=True)
    pred, n_div = model(batch, use_barycenter=settings.use_barycenter)
    loss = task_loss(pred, batch, settings)
    loss.backward()
    _apply(model, optimizer, settings, accumulation, update)
    return loss.detach(), n_div


def eval_step(model, batch, settings: TrainSettings, rows: torch.Tensor | None = None):
    """One forward without gradient: ``(loss, pred, n_div)`` device tensors
    (``n_div`` as in ``train_step``, ``rows`` as in ``masked_mse``)."""
    with torch.no_grad():
        pred, n_div = model(batch, use_barycenter=settings.use_barycenter)
        return task_loss(pred, batch, settings, rows), pred, n_div


class SplitStep:
    """One rank's train step under data parallelism, split around the
    gradient all-reduce (the ``psum`` XLA inserts into the JAX step).

    ``before(batch, rows)``: zero the gradients, forward, the loss over the
    global batch's ``rows`` real molecules (so the ranks' losses sum to the
    global batch's mean, as JAX's ``sum(masked loss) / max(sum(mol_mask),
    1)`` over the sharded batch), backward, and the gradients, the loss and
    ``n_div`` (``(2,)``: divergences and Sinkhorn iterations) copied into
    ``flat``. ``reduce()``: ``all_reduce_`` of ``flat`` over the mesh.
    ``after()``: the summed gradients copied back, the global-norm clip and
    Adam; returns the summed ``(loss, n_div)``.
    ``flat`` is one f32 buffer, made at the first step (when the gradients
    the stage produces are known) and addressed by every later step, so
    that both halves can be CUDA graphs (``train/graphs.py``). With an
    ``accumulation``, ``after(update)`` folds the summed gradients into it
    and clips and steps Adam only where ``update``: each mini-step's
    gradient is the all-reduced one, as in the JAX package's sharded
    step."""

    def __init__(self, model, optimizer, settings: TrainSettings, mesh,
                 accumulation: Accumulation | None = None):
        self.model, self.optimizer, self.settings, self.mesh = model, optimizer, settings, mesh
        self.accumulation = accumulation
        self.params = list(model.parameters())
        self.flat: torch.Tensor | None = None
        self._views: list = []  # one view of flat per gradient, then loss and n_div (2,)

    def _grads(self) -> list:
        return [p.grad for p in self.params if p.grad is not None]

    def before(self, batch, rows: torch.Tensor) -> None:
        self.optimizer.zero_grad(set_to_none=True)
        pred, n_div = self.model(batch, use_barycenter=self.settings.use_barycenter)
        loss = task_loss(pred, batch, self.settings, rows)
        loss.backward()
        grads = self._grads()
        if self.flat is None:
            sizes = [g.numel() for g in grads] + [1, 2]
            self.flat = torch.empty(sum(sizes), dtype=torch.float32, device=loss.device)
            self._views = [v.view_as(g) for v, g in zip(self.flat.split(sizes), grads)]
            self._views += [self.flat[-3], self.flat[-2:]]
        if len(grads) + 2 != len(self._views):
            raise RuntimeError(f"{len(grads)} gradients, the all-reduce buffer holds"
                               f" {len(self._views) - 2}")
        torch._foreach_copy_(self._views, grads + [loss.detach(), n_div.to(torch.float32)])

    def reduce(self) -> None:
        collectives.all_reduce_(self.flat, self.mesh)

    def after(self, update: bool = True) -> tuple:
        torch._foreach_copy_(self._grads(), self._views[:-2])
        _apply(self.model, self.optimizer, self.settings, self.accumulation, update)
        return self.flat[-3].clone(), self.flat[-2:].to(torch.int64)


def step_graphs(model, optimizer, settings: TrainSettings, device, mesh=None,
                accumulation: Accumulation | None = None) -> StepGraphs:
    """``train_step`` and ``eval_step`` of ``model`` under ``settings``, to
    be captured per batch shape on the card (``train/graphs.py``). With a
    ``mesh`` the train step is ``SplitStep``'s two halves around its
    all-reduce, and both steps take the global batch's real rows. With an
    ``accumulation`` the train step has two kinds, a mini-step that only
    accumulates and one that also updates."""
    if mesh is None:
        train = functools.partial(train_step, model, optimizer, settings=settings,
                                  accumulation=accumulation)
        return StepGraphs(functools.partial(train, update=accumulation is None),
                          functools.partial(eval_step, model, settings=settings),
                          model.parameters(), device, accumulation=accumulation,
                          train_update_fn=functools.partial(train, update=True))
    split = SplitStep(model, optimizer, settings, mesh, accumulation)
    return StepGraphs((split.before, functools.partial(split.after, update=accumulation is None)),
                      lambda batch, rows: eval_step(model, batch, settings, rows),
                      model.parameters(), device, reduce=split.reduce, accumulation=accumulation,
                      train_update_fn=(split.before, functools.partial(split.after, update=True)))


def batch_iterator(
    records: Sequence[MoleculeRecord],
    batch_size: int,
    max_atoms: int,
    *,
    shuffle: bool = False,
    rng: np.random.Generator | None = None,
    prefetch: bool = True,
    bucketed: bool = False,
    pack: Callable = loader_lib.pack,
) -> Iterable[PackedBatch]:
    """The JAX package's ``batch_iterator``: bucketed or sequential
    batches, shuffled by ``rng`` with ``shuffle``, prefetched on a
    background thread unless ``prefetch=False``. ``pack`` packs each batch
    (by default natively)."""
    order = dict(shuffle=shuffle, rng=rng, pack=pack)
    if bucketed:
        buckets = bucket_boundaries(max_atoms)
        if prefetch:
            return loader_lib.prefetched_bucketed_batches(records, batch_size, buckets=buckets,
                                                          **order)
        return loader_lib.bucketed_batches(records, batch_size, buckets, **order)
    if prefetch:
        return loader_lib.prefetched_batches(records, batch_size, max_atoms, **order)
    return loader_lib.batches(records, batch_size, max_atoms, **order)


def epoch_rng(settings: TrainSettings, epoch: int) -> np.random.Generator | None:
    """The generator that shuffles epoch ``epoch``'s training batches, the
    JAX loop's ``np.random.default_rng([seed, epoch])`` (a resumed run
    reproduces any epoch's order); None without ``settings.shuffle``."""
    return np.random.default_rng([settings.seed, epoch]) if settings.shuffle else None


@contextlib.contextmanager
def step_batches(records, settings: TrainSettings, max_atoms: int, graphs=None, *,
                 prefetch: bool = True, native: bool = True, mesh=None, rng=None):
    """``batch_iterator`` over ``records`` at ``settings``' batch size,
    bucketed as ``settings.bucketed`` says and shuffled by ``rng`` where
    given (``epoch_rng``), for one pass of steps, closed on exit (its
    prefetch thread ends, also when the pass stops early). With ``native`` the native packer
    packs, into ``graphs``' pinned slots where it has them
    (``StepGraphs.stage``); otherwise the numpy packer. With a ``mesh``
    the batches are the global ones, and each is packed only in the rank's
    row block (``mesh.rank_packer``: ``batch_size // world`` rows at the
    global batch's bucket, its ``global_rows`` set). The set-up, the slots
    readied and the prefetch thread started, is the span ``epoch_start``;
    the thread's end, the span ``epoch_end`` (``data/loader.py``)."""
    rows = settings.batch_size if mesh is None else settings.batch_size // mesh.world
    with profiling.span("epoch_start"):
        pack = functools.partial(loader_lib.pack, native=native)
        if native and graphs is not None:
            # the batch shapes: every bucket, or max_atoms alone without buckets
            buckets = bucket_boundaries(max_atoms) if settings.bucketed else (max_atoms,)
            pack = graphs.stage(records, rows, buckets) or pack
        if mesh is not None:
            pack = mesh_lib.rank_packer(pack, mesh)
        it = batch_iterator(records, settings.batch_size, max_atoms, shuffle=rng is not None,
                            rng=rng, prefetch=prefetch, bucketed=settings.bucketed, pack=pack)
    with contextlib.closing(it):
        yield it


def bucket_boundaries(max_atoms: int) -> tuple:
    """Bucket ladder capped at ``max_atoms`` (itself always a boundary)."""
    return tuple(b for b in DEFAULT_BUCKETS if b < max_atoms) + (max_atoms,)


def dataset_max_atoms(records: Sequence[MoleculeRecord]) -> int:
    return bucket_for(max(r.num_atoms for r in records))


def evaluate(model, records, settings: TrainSettings, max_atoms: int, device, graphs=None, *,
             prefetch: bool = True, native: bool = True, mesh=None):
    """Full-split predictions and metrics: ``(metrics, pred, y)``. With
    ``graphs`` (``fit``'s ``StepGraphs``) the eval steps go through it, as
    the JAX package's ``eval_scan``; without (predict's single pass, where
    a capture would not pay) they run eagerly. ``prefetch`` and ``native``
    as in ``step_batches``. With a ``mesh`` each rank evaluates its row
    block of every batch, and the predictions, per-batch losses and
    ``n_div`` of every rank are gathered in rank order, so that every rank
    computes the same metrics (the JAX ``evaluate``'s multi-host gather)."""
    preds, masks, ys, losses, divs = [], [], [], [], []
    with step_batches(records, settings, max_atoms, graphs, prefetch=prefetch,
                      native=native, mesh=mesh) as batches:
        for pb in batches:
            # copied before the step: a pinned slot's batch is refilled once
            # its copy to the card has landed
            masks.append(pb.mol_mask.copy())
            ys.append(pb.y.copy())
            if graphs is not None:
                loss, pred, n_div = graphs.eval(pb)
            else:
                rows = None if mesh is None else torch.tensor(float(pb.global_rows), device=device)
                loss, pred, n_div = eval_step(model, pb.to(device), settings, rows)
            losses.append(loss)
            divs.append(n_div[0])
            preds.append(pred.reshape(-1))
    # (rows, batches); with a mesh every rank's rows in rank order, so that
    # column j holds global batch j's rows in order
    mask = collectives.host_concat(np.stack(masks, 1).view(np.uint8), mesh).T.astype(bool)
    pred = collectives.gather_to_host(torch.stack(preds, 1), mesh).T[mask]
    y = collectives.host_concat(np.stack(ys, 1), mesh).T[mask]
    if mesh is None:
        loss, n_div = float(torch.stack(losses).mean()), int(torch.stack(divs).sum())
    else:
        # a global batch's loss: the sum of its ranks' (each divided by the
        # global batch's real molecules)
        batch_losses = collectives.gather_to_host(torch.stack(losses)[None], mesh).sum(0)
        loss = float(torch.from_numpy(batch_losses).mean())
        n_div = int(collectives.gather_to_host(torch.stack(divs)[None], mesh).sum())
    if n_div:
        log.warning("FGW solver: %d Sinkhorn-diverged coupling solves rolled back "
                    "during evaluation", n_div)
    out = {"loss": loss}
    regression = settings.task == "regression"
    if settings.eval_guard:
        # the JAX package's divergence detector: report outliers, keep them
        # in the unguarded metrics
        bad = ~np.isfinite(pred)
        if regression:
            bad |= np.abs(pred - float(np.mean(y))) > GUARD_SIGMAS * max(float(np.std(y)), 1e-6)
        out["pred_outliers"] = int(bad.sum())
        if bad.any():
            log.warning(
                "eval guard: %d outlier prediction(s) at split indices %s "
                "(max |pred| %.3e vs label scale %.3e) — guarded metrics "
                "exclude them, unguarded metrics keep them",
                int(bad.sum()), np.flatnonzero(bad)[:16].tolist(),
                float(np.max(np.abs(pred[bad]))), float(np.std(y)),
            )
            if regression and (~bad).any():
                out["mse_guarded"] = metrics_lib.mse(pred[~bad], y[~bad])
                out["rmse_guarded"] = metrics_lib.rmse(pred[~bad], y[~bad])
    if regression:
        out["mse"] = metrics_lib.mse(pred, y)
        out["rmse"] = metrics_lib.rmse(pred, y)
        return out, pred, y
    try:
        out.update(metrics_lib.classification_metrics(pred, y, settings.trade_off))
    except ValueError:  # a single-class split
        log.warning("eval split contains a single class (%d positives of %d); "
                    "reporting auroc=prc=0.5 — check the split", int((y == 1).sum()), len(y))
        out.update({"auroc": 0.5, "prc": 0.5})
    return out, pred, y


@dataclasses.dataclass
class FitResult:
    best_metric: float
    best_epoch: int
    history: list
    model: torch.nn.Module
    # the fit's StepGraphs; the runner evaluates the test split through its
    # eval graphs
    graphs: StepGraphs


def _train_epoch(graphs: StepGraphs, records, settings: TrainSettings, max_atoms: int, dev,
                 epoch: int, **pipeline):
    """Epoch ``epoch``'s train steps through ``graphs``: ``(losses, n_divs,
    timing)``, ``n_divs`` each step's ``(2,)`` ``n_div``. A bucket's batches
    come one after another; ``timing`` holds each bucket's steps
    (``steps_n32``) and host seconds up to a synchronise at its end
    (``train_s_n32``; the span ``bucket_sync``). Then the epoch's Sinkhorn
    iterations are read from the idle card in one copy (the span
    ``epoch_end``) into the counter ``fgw.sinkhorn_iters``. ``pipeline``:
    ``step_batches``' ``prefetch``, ``native`` and ``mesh``."""
    losses, divs, timing = [], [], {}
    with step_batches(records, settings, max_atoms, graphs, rng=epoch_rng(settings, epoch),
                      **pipeline) as batches:
        for n, group in itertools.groupby(batches, key=lambda pb: pb.max_atoms):
            t0, steps = time.perf_counter(), 0
            for pb in group:
                loss, n_div = graphs.train(pb)
                losses.append(loss)
                divs.append(n_div)
                steps += 1
            if dev.type == "cuda":
                with profiling.span("bucket_sync", n):
                    torch.cuda.synchronize(dev)
            timing[f"steps_n{n}"] = steps
            timing[f"train_s_n{n}"] = time.perf_counter() - t0
    if divs:
        with profiling.span("epoch_end"):
            iters = int(torch.stack(divs).cpu()[:, 1].sum())
        profiling.add("fgw.sinkhorn_iters", iters)
    return losses, divs, timing


def fit(settings: TrainSettings,
        train_records: Sequence[MoleculeRecord] | Callable[[int], Sequence[MoleculeRecord]],
        val_records: Sequence[MoleculeRecord], *, model=None, device="cuda",
        checkpointer=None, resume: bool = False, prefetch: bool = True,
        native: bool = True, mesh=None) -> FitResult:
    """Epoch loop with plateau LR, early stopping on ``val_loss`` and
    best-checkpoint tracking on ``settings.monitor``.

    ``model`` defaults to a fresh flagship ``ConanModel`` seeded from
    ``settings.seed``; pass a model holding stage-1 weights to warm-start
    stage 2. ``train_records`` may be a callable taking the epoch and
    returning that epoch's records: it is called once per epoch, so a
    ``ConformerDataset`` draws a fresh K-subset of conformers every epoch.

    With a ``checkpointer`` (``train/checkpoints.py``) every epoch saves
    ``last`` and ``last_state``, and an improved monitor saves ``best``;
    ``resume=True`` restores the weights, Adam and the loop's state from
    ``last_state`` and continues at the epoch after it. With
    ``settings.accumulate_steps`` above 1 the accumulation carries over
    epochs, and ``last_state`` holds it, so a resume in the middle of an
    accumulation continues it.

    Each history row carries ``train_steps`` and ``train_s``, the host time
    of the epoch's training steps ending in a device synchronise, and the
    same by bucket (``steps_n32``, ``train_s_n32``, ...); and the epoch's
    change, its evaluation included, in the program's counters
    (``utils/profiling.py``): ``fgw_sinkhorn_iters`` (the training steps'
    Sinkhorn iterations, ``fgw.sinkhorn_iters``), the host seconds
    ``queue_wait_s`` (waiting for the prefetch thread), ``pack_s`` (packing,
    on that thread), ``slot_wait_s`` (waiting for a pinned slot's copy) and
    ``replay_s`` (graph replays), and ``graph_captures`` and
    ``graph_warm_ups`` (new batch shapes). ``evaluate`` and the checkpoint
    writes are the spans ``evaluate`` and ``checkpoint``.

    The steps go through one ``StepGraphs``, created after a resume has
    restored Adam's state; it is returned in ``FitResult.graphs``. Their
    batches are packed natively on a prefetch thread; ``prefetch=False``
    packs on the calling thread, ``native=False`` with the numpy packer
    (byte for byte the same batches).

    With a ``mesh`` (``parallel/mesh.py``) this is one rank's fit, on the
    mesh's device: every rank steps through the same global batches, each
    on its row block, with the gradients summed over the ranks
    (``SplitStep``), and evaluates through ``evaluate``'s gather, so that
    the ranks' schedule, early stopping and ``best`` epoch agree. The
    replicas' weights are checked equal before the first step.
    ``settings.batch_size`` must be a multiple of the ranks.
    """
    dev = resolve_device(device if mesh is None else mesh.device)
    if model is None:
        from conan_fgw_tpu_torch.models.heads import ConanModel

        model = ConanModel(seed=settings.seed, device=dev)
    model.to(dev)
    optimizer = make_optimizer(model, settings)
    accumulation = make_accumulation(model, settings, dev)
    epoch_records = train_records(0) if callable(train_records) else train_records
    max_atoms = settings.max_atoms or dataset_max_atoms(list(epoch_records) + list(val_records))
    plateau = metrics_lib.ReduceLROnPlateau(
        settings.learning_rate, settings.plateau_factor, settings.plateau_patience
    )
    stopper = metrics_lib.EarlyStopping(settings.es_patience, settings.es_min_delta)
    maximize = settings.monitor in MAXIMIZED
    best, best_epoch, history, start_epoch = -np.inf if maximize else np.inf, -1, [], 0

    if resume and checkpointer is not None and checkpointer.has("last_state"):
        meta = checkpointer.restore_state(model, optimizer, accumulation=accumulation)
        loop_meta = meta.get("loop", {})
        start_epoch = meta["epoch"] + 1
        plateau.lr = loop_meta.get("lr", plateau.lr)
        plateau.best = loop_meta.get("plateau_best", plateau.best)
        plateau.num_bad = loop_meta.get("plateau_num_bad", plateau.num_bad)
        stopper.best = loop_meta.get("stopper_best", stopper.best)
        stopper.num_bad = loop_meta.get("stopper_num_bad", stopper.num_bad)
        best = loop_meta.get("best", best)
        best_epoch = loop_meta.get("best_epoch", best_epoch)
        history = loop_meta.get("history", [])
        set_learning_rate(optimizer, plateau.lr)
        log.info("resumed from epoch %d (lr=%.2e)", start_epoch, plateau.lr)
    collectives.check_replicas(model, mesh)
    # after restore_state, which replaces Adam's state tensors: a graph
    # holds the addresses of the tensors it was captured with
    extra = {} if accumulation is None else {"accumulation": accumulation}
    graphs = (step_graphs(model, optimizer, settings, dev, **extra) if mesh is None
              else step_graphs(model, optimizer, settings, dev, mesh, **extra))
    pipeline = dict(prefetch=prefetch, native=native, mesh=mesh)

    for epoch in range(start_epoch, settings.num_epochs):
        t0 = time.perf_counter()
        before = profiling.counters.copy()
        if epoch != 0 and callable(train_records):
            # keyed on the epoch, so a resumed run redraws any epoch's subsets
            epoch_records = train_records(epoch)
        t_train = time.perf_counter()
        losses, divs, timing = _train_epoch(graphs, epoch_records, settings, max_atoms, dev,
                                            epoch, **pipeline)
        train_s = time.perf_counter() - t_train
        train_loss = float(torch.stack(losses).mean())
        epoch_divs = int(torch.stack(divs)[:, 0].sum())
        if epoch_divs:
            log.warning("FGW solver: %d Sinkhorn-diverged coupling solves rolled back "
                        "in epoch %d", epoch_divs, epoch)
        with profiling.span("evaluate"):
            val_metrics, _, _ = evaluate(model, val_records, settings, max_atoms, dev, graphs,
                                         **pipeline)
        val_loss = val_metrics["loss"]
        row = {
            "epoch": epoch,
            "train_loss": train_loss,
            "lr": plateau.lr,
            "fgw_diverged": epoch_divs,
            "train_steps": len(losses),
            "train_s": train_s,
            **timing,
            **{col: profiling.counters[key] - before[key] for col, key in COUNTER_COLUMNS.items()},
            "epoch_time_s": time.perf_counter() - t0,
            **{f"val_{k}": v for k, v in val_metrics.items() if k != "loss"},
            "val_loss": val_loss,
        }
        history.append(row)
        log.info("epoch %d train_loss=%.5f val_loss=%.5f %s lr=%.2e (%.1fs)",
                 epoch, train_loss, val_loss,
                 " ".join(f"val_{k}={v:.5f}" for k, v in val_metrics.items() if k != "loss"),
                 plateau.lr, row["epoch_time_s"])
        monitored = row.get(settings.monitor)
        if monitored is not None and (monitored > best if maximize else monitored < best):
            best, best_epoch = monitored, epoch
            if checkpointer is not None:
                with profiling.span("checkpoint"):
                    checkpointer.save_best(model, epoch, {settings.monitor: monitored})
        set_learning_rate(optimizer, plateau.step(val_loss))
        should_stop = stopper.step(val_loss)
        if checkpointer is not None:
            with profiling.span("checkpoint"):
                checkpointer.save_last(model, epoch)
                checkpointer.save_state(model, optimizer, epoch, accumulation=accumulation,
                                        loop_state={
                                            "lr": plateau.lr,
                                            "plateau_best": plateau.best,
                                            "plateau_num_bad": plateau.num_bad,
                                            "stopper_best": stopper.best,
                                            "stopper_num_bad": stopper.num_bad,
                                            "best": float(best),
                                            "best_epoch": best_epoch,
                                            "history": history,
                                        })
        if should_stop:
            log.info("early stopping at epoch %d", epoch)
            break
    return FitResult(float(best), best_epoch, history, model, graphs)
