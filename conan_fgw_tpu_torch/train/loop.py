"""Train step and epoch loop (port of ``conan_fgw_tpu/train/loop.py``, the
regression path).

One train step: forward (including the batched FGW barycenter in stage 2),
masked MSE, backward, global-norm clip at 1.0 written as
``optax.clip_by_global_norm``, and Adam (``torch.optim.Adam``, whose update
equals optax's). ``fit`` runs epochs over atom-count-bucketed batches with the
LR plateau schedule and early stopping on ``val_loss``. Checkpoint files
come later: ``fit(..., model=m)`` continues from the weights ``m`` holds, which
is the in-memory warm start from stage 1 to stage 2.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Sequence

import numpy as np
import torch

from conan_fgw_tpu_torch.data.loader import bucketed_batches
from conan_fgw_tpu_torch.data.packing import DEFAULT_BUCKETS, MoleculeRecord, bucket_for
from conan_fgw_tpu_torch.device import resolve_device
from conan_fgw_tpu_torch.train import metrics as metrics_lib

log = logging.getLogger("conan_fgw_tpu_torch")


@dataclasses.dataclass
class TrainSettings:
    """Optimisation settings; defaults mirror the reference regression task."""

    learning_rate: float = 5e-4
    num_epochs: int = 80
    batch_size: int = 24
    grad_clip: float = 1.0
    plateau_patience: int = 10
    plateau_factor: float = 0.8
    es_patience: int = 50
    es_min_delta: float = 1e-4
    use_barycenter: bool = False
    seed: int = 5


def masked_mse(pred: torch.Tensor, batch) -> torch.Tensor:
    """Mean squared error over real molecules (``mol_mask``)."""
    y = batch.y[:, None]
    w = batch.mol_mask.to(pred.dtype)[:, None]
    denom = torch.clamp(w.sum(), min=1.0)
    sq = torch.where(w > 0, (pred - y) ** 2, torch.zeros_like(pred))
    return sq.sum() / denom


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
    loss = masked_mse(pred, batch)
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
            losses.append(masked_mse(pred, batch))
            divs.append(n_div)
            preds.append((pred.reshape(-1), pb.mol_mask))
            ys.append(pb.y[pb.mol_mask])
    pred = np.concatenate([p.cpu().numpy()[m] for p, m in preds])
    y = np.concatenate(ys)
    n_div = int(torch.stack(divs).sum())
    if n_div:
        log.warning("FGW solver: %d Sinkhorn-diverged coupling solves rolled back "
                    "during evaluation", n_div)
    out = {
        "loss": float(torch.stack(losses).mean()),
        "mse": metrics_lib.mse(pred, y),
        "rmse": metrics_lib.rmse(pred, y),
    }
    return out, pred, y


@dataclasses.dataclass
class FitResult:
    best_metric: float
    best_epoch: int
    history: list
    model: torch.nn.Module


def fit(settings: TrainSettings, train_records: Sequence[MoleculeRecord],
        val_records: Sequence[MoleculeRecord], *, model=None, device="cuda") -> FitResult:
    """Epoch loop with plateau LR and early stopping on ``val_loss``.

    ``model`` defaults to a fresh flagship ``ConanModel`` seeded from
    ``settings.seed``; pass a model holding stage-1 weights to warm-start
    stage 2. Each history row carries ``train_steps`` and ``train_s``, the
    host time of the epoch's training steps ending in a device synchronise.
    """
    dev = resolve_device(device)
    if model is None:
        from conan_fgw_tpu_torch.models.heads import ConanModel

        model = ConanModel(seed=settings.seed, device=dev)
    model.to(dev)
    optimizer = make_optimizer(model, settings)
    max_atoms = dataset_max_atoms(list(train_records) + list(val_records))
    buckets = bucket_boundaries(max_atoms)
    plateau = metrics_lib.ReduceLROnPlateau(
        settings.learning_rate, settings.plateau_factor, settings.plateau_patience
    )
    stopper = metrics_lib.EarlyStopping(settings.es_patience, settings.es_min_delta)
    best, best_epoch, history = np.inf, -1, []

    for epoch in range(settings.num_epochs):
        t0 = time.perf_counter()
        losses, divs = [], []
        for pb in bucketed_batches(train_records, settings.batch_size, buckets=buckets):
            loss, n_div = train_step(model, optimizer, pb.to(dev), settings)
            losses.append(loss)
            divs.append(n_div)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_s = time.perf_counter() - t0
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
            "epoch_time_s": time.perf_counter() - t0,
            **{f"val_{k}": v for k, v in val_metrics.items() if k != "loss"},
            "val_loss": val_loss,
        }
        history.append(row)
        log.info("epoch %d train_loss=%.5f val_loss=%.5f val_rmse=%.5f lr=%.2e (%.1fs)",
                 epoch, train_loss, val_loss, val_metrics["rmse"], plateau.lr,
                 row["epoch_time_s"])
        if row["val_mse"] < best:  # the regression monitor, val_mse
            best, best_epoch = row["val_mse"], epoch
        set_learning_rate(optimizer, plateau.step(val_loss))
        if stopper.step(val_loss):
            log.info("early stopping at epoch %d", epoch)
            break
    return FitResult(float(best), best_epoch, history, model)
