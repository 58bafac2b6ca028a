"""Train step and epoch loop (port of ``conan_fgw_tpu/train/loop.py``).

One train step: forward (including the batched FGW barycenter in stage 2),
the task's loss (masked MSE for regression; for classification the stable
logit-space BCE scaled by ``loss_scale``), backward, global-norm clip at 1.0
written as
``optax.clip_by_global_norm``, and Adam (``torch.optim.Adam``, whose update
equals optax's). ``fit`` runs epochs over atom-count-bucketed batches with the
LR plateau schedule and early stopping on ``val_loss``, keeps the ``best``
checkpoint by ``TrainSettings.monitor`` (higher is better for ``val_auroc``,
``val_mean`` and ``val_prc``, lower for the rest) and the ``last`` and ``last_state``
ones every epoch, and resumes from ``last_state``. ``fit(..., model=m)``
continues from the weights ``m`` holds; the runner loads stage 1's ``best``
into ``m`` for the stage-2 warm start.
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import time
from typing import Callable, Sequence

import numpy as np
import torch

from conan_fgw_tpu_torch.data.loader import bucketed_batches
from conan_fgw_tpu_torch.data.packing import DEFAULT_BUCKETS, MoleculeRecord, bucket_for
from conan_fgw_tpu_torch.device import resolve_device
from conan_fgw_tpu_torch.train import metrics as metrics_lib

log = logging.getLogger("conan_fgw_tpu_torch")

# eval-guard outlier threshold, in label standard deviations (the JAX
# package's GUARD_SIGMAS: far outside any legitimate regressor output, and
# never reached by ordinary bad fits)
GUARD_SIGMAS = 50.0
# monitors for which a higher value is better
MAXIMIZED = ("val_auroc", "val_mean", "val_prc")


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
    # flag non-finite and outlier predictions in `evaluate` (pred_outliers)
    eval_guard: bool = False


def masked_mse(pred: torch.Tensor, batch) -> torch.Tensor:
    """Mean squared error over real molecules (``mol_mask``)."""
    y = batch.y[:, None]
    w = batch.mol_mask.to(pred.dtype)[:, None]
    denom = torch.clamp(w.sum(), min=1.0)
    sq = torch.where(w > 0, (pred - y) ** 2, torch.zeros_like(pred))
    return sq.sum() / denom


def masked_bce(pred: torch.Tensor, batch, scale: float | None = None) -> torch.Tensor:
    """Binary cross-entropy of logits over real molecules, times ``scale``:
    the stable form ``max(z, 0) - z y + log1p(exp(-|z|))``. The model
    returns logits; this equals the reference's probability-space BCE with
    its class-weight rescale, and keeps a gradient where the sigmoid
    saturates in f32."""
    y = batch.y[:, None]
    w = batch.mol_mask.to(pred.dtype)[:, None]
    denom = torch.clamp(w.sum(), min=1.0)
    bce = torch.clamp(pred, min=0.0) - pred * y + torch.log1p(torch.exp(-pred.abs()))
    total = torch.where(w > 0, bce, torch.zeros_like(bce)).sum() / denom
    return (1.0 if scale is None else scale) * total


def task_loss(pred: torch.Tensor, batch, settings: "TrainSettings") -> torch.Tensor:
    """The loss of ``settings.task``: masked MSE, or the scaled masked BCE."""
    if settings.task == "regression":
        return masked_mse(pred, batch)
    return masked_bce(pred, batch, settings.loss_scale)


def clip_by_global_norm_(params: Sequence[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale gradients in place as ``optax.clip_by_global_norm``: unchanged
    when the global norm is below ``max_norm``, else ``g / norm * max_norm``
    (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``)."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))
    return norm


def make_optimizer(model: torch.nn.Module, settings: TrainSettings) -> torch.optim.Optimizer:
    return torch.optim.Adam(model.parameters(), lr=settings.learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def train_step(model, optimizer, batch, settings: TrainSettings):
    """One optimisation step; returns ``(loss, n_div)`` as device tensors."""
    optimizer.zero_grad(set_to_none=True)
    pred, n_div = model(batch, use_barycenter=settings.use_barycenter)
    loss = task_loss(pred, batch, settings)
    loss.backward()
    clip_by_global_norm_(list(model.parameters()), settings.grad_clip)
    optimizer.step()
    return loss.detach(), n_div


def bucket_boundaries(max_atoms: int) -> tuple:
    """Bucket ladder capped at ``max_atoms`` (itself always a boundary)."""
    return tuple(b for b in DEFAULT_BUCKETS if b < max_atoms) + (max_atoms,)


def dataset_max_atoms(records: Sequence[MoleculeRecord]) -> int:
    return bucket_for(max(r.num_atoms for r in records))


def evaluate(model, records, settings: TrainSettings, max_atoms: int, device):
    """Full-split predictions and metrics: ``(metrics, pred, y)``."""
    preds, ys, losses, divs = [], [], [], []
    with torch.no_grad():
        for pb in bucketed_batches(records, settings.batch_size,
                                   buckets=bucket_boundaries(max_atoms)):
            batch = pb.to(device)
            pred, n_div = model(batch, use_barycenter=settings.use_barycenter)
            losses.append(task_loss(pred, batch, settings))
            divs.append(n_div)
            preds.append((pred.reshape(-1), pb.mol_mask))
            ys.append(pb.y[pb.mol_mask])
    pred = np.concatenate([p.cpu().numpy()[m] for p, m in preds])
    y = np.concatenate(ys)
    n_div = int(torch.stack(divs).sum())
    if n_div:
        log.warning("FGW solver: %d Sinkhorn-diverged coupling solves rolled back "
                    "during evaluation", n_div)
    out = {"loss": float(torch.stack(losses).mean())}
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


def _train_epoch(model, optimizer, records, settings: TrainSettings, buckets, dev):
    """One epoch of train steps: ``(losses, n_divs, timing)``. The buckets'
    batches come one bucket after another; ``timing`` holds each bucket's
    steps (``steps_n32``) and host seconds up to a synchronise at its end
    (``train_s_n32``)."""
    losses, divs, timing = [], [], {}
    batches = bucketed_batches(records, settings.batch_size, buckets=buckets)
    for n, group in itertools.groupby(batches, key=lambda pb: pb.max_atoms):
        t0, steps = time.perf_counter(), 0
        for pb in group:
            loss, n_div = train_step(model, optimizer, pb.to(dev), settings)
            losses.append(loss)
            divs.append(n_div)
            steps += 1
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        timing[f"steps_n{n}"] = steps
        timing[f"train_s_n{n}"] = time.perf_counter() - t0
    return losses, divs, timing


def fit(settings: TrainSettings,
        train_records: Sequence[MoleculeRecord] | Callable[[int], Sequence[MoleculeRecord]],
        val_records: Sequence[MoleculeRecord], *, model=None, device="cuda",
        checkpointer=None, resume: bool = False) -> FitResult:
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
    ``last_state`` and continues at the epoch after it.

    Each history row carries ``train_steps`` and ``train_s``, the host time
    of the epoch's training steps ending in a device synchronise, and the
    same by bucket (``steps_n32``, ``train_s_n32``, ...).
    """
    dev = resolve_device(device)
    if model is None:
        from conan_fgw_tpu_torch.models.heads import ConanModel

        model = ConanModel(seed=settings.seed, device=dev)
    model.to(dev)
    optimizer = make_optimizer(model, settings)
    epoch_records = train_records(0) if callable(train_records) else train_records
    max_atoms = settings.max_atoms or dataset_max_atoms(list(epoch_records) + list(val_records))
    buckets = bucket_boundaries(max_atoms)
    plateau = metrics_lib.ReduceLROnPlateau(
        settings.learning_rate, settings.plateau_factor, settings.plateau_patience
    )
    stopper = metrics_lib.EarlyStopping(settings.es_patience, settings.es_min_delta)
    maximize = settings.monitor in MAXIMIZED
    best, best_epoch, history, start_epoch = -np.inf if maximize else np.inf, -1, [], 0

    if resume and checkpointer is not None and checkpointer.has("last_state"):
        meta = checkpointer.restore_state(model, optimizer)
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

    for epoch in range(start_epoch, settings.num_epochs):
        t0 = time.perf_counter()
        if epoch != 0 and callable(train_records):
            # keyed on the epoch, so a resumed run redraws any epoch's subsets
            epoch_records = train_records(epoch)
        t_train = time.perf_counter()
        losses, divs, timing = _train_epoch(model, optimizer, epoch_records, settings, buckets, dev)
        train_s = time.perf_counter() - t_train
        train_loss = float(torch.stack(losses).mean())
        epoch_divs = int(torch.stack(divs).sum())
        if epoch_divs:
            log.warning("FGW solver: %d Sinkhorn-diverged coupling solves rolled back "
                        "in epoch %d", epoch_divs, epoch)
        val_metrics, _, _ = evaluate(model, val_records, settings, max_atoms, dev)
        val_loss = val_metrics["loss"]
        row = {
            "epoch": epoch,
            "train_loss": train_loss,
            "lr": plateau.lr,
            "fgw_diverged": epoch_divs,
            "train_steps": len(losses),
            "train_s": train_s,
            **timing,
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
                checkpointer.save_best(model, epoch, {settings.monitor: monitored})
        set_learning_rate(optimizer, plateau.step(val_loss))
        should_stop = stopper.step(val_loss)
        if checkpointer is not None:
            checkpointer.save_last(model, epoch)
            checkpointer.save_state(model, optimizer, epoch, {
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
    return FitResult(float(best), best_epoch, history, model)
