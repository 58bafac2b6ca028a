"""Evaluation metrics and host-side schedules (the port's own copy of
``conan_fgw_tpu/train/metrics.py``: MSE/RMSE, the LR plateau schedule and
early stopping)."""

from __future__ import annotations

import numpy as np


def mse(pred: np.ndarray, target: np.ndarray) -> float:
    pred = np.asarray(pred).reshape(-1)
    target = np.asarray(target).reshape(-1)
    return float(np.mean((pred - target) ** 2))


def rmse(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.sqrt(mse(pred, target)))


class ReduceLROnPlateau:
    """Host-side LR plateau schedule mirroring torch's defaults.

    The reference uses mode="min" with (patience=10, factor=0.8) for
    regression and (patience=5, factor=0.5) for classification
    (``common.py:253-262`` / ``common.py:53-66``), monitoring ``val_loss``.
    torch defaults replicated: relative threshold 1e-4, cooldown 0, min_lr 0.
    """

    def __init__(self, lr: float, factor: float, patience: int, threshold: float = 1e-4):
        self.lr = float(lr)
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> float:
        if metric < self.best * (1.0 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0
        return self.lr


class EarlyStopping:
    """``val_loss``-monitored early stop with ``min_delta``/``patience``
    (trainer.py:200-225, mode="min", check_finite)."""

    def __init__(self, patience: int, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.num_bad = 0

    def step(self, metric: float) -> bool:
        """Returns True when training should stop."""
        if not np.isfinite(metric):
            return True
        if metric < self.best - self.min_delta:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        return self.num_bad >= self.patience
