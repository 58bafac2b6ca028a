"""Evaluation metrics and host-side schedules (the port's own copy of
``conan_fgw_tpu/train/metrics.py``: MSE/RMSE, AUROC/PRC-AUC, the LR plateau
schedule and early stopping).

The JAX package computes the classification metrics with scikit-learn,
which the card's machine does not have: ``classification_metrics`` computes
them in numpy as ``roc_auc_score`` and ``precision_recall_curve`` + ``auc``
do, ties included (scores sorted descending, one curve point per distinct
score).
"""

from __future__ import annotations

import numpy as np


def mse(pred: np.ndarray, target: np.ndarray) -> float:
    pred = np.asarray(pred).reshape(-1)
    target = np.asarray(target).reshape(-1)
    return float(np.mean((pred - target) ** 2))


def rmse(pred: np.ndarray, target: np.ndarray) -> float:
    return float(np.sqrt(mse(pred, target)))


def _clf_curve(y: np.ndarray, score: np.ndarray):
    """False and true positives at each distinct score, in descending score
    order (scikit-learn's ``confusion_matrix_at_thresholds``)."""
    order = np.argsort(score, kind="mergesort")[::-1]
    score, y = score[order], y[order]
    last = np.r_[np.flatnonzero(np.diff(score)), y.size - 1]
    tps = np.cumsum(y)[last]
    return 1 + last - tps, tps


def _auc(x: np.ndarray, y: np.ndarray) -> float:
    """Trapezoidal area under ``y(x)`` for monotonic ``x`` (``auc``)."""
    dx = np.diff(x)
    direction = 1.0
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing: {x}")
        direction = -1.0
    return float(direction * (dx * (y[1:] + y[:-1]) / 2.0).sum())


def roc_auc(target: np.ndarray, pred: np.ndarray) -> float:
    """Area under the ROC curve; raises ``ValueError`` when ``target``
    holds one class, as ``roc_auc_score`` did before scikit-learn 1.7 (later
    versions return NaN), so that ``evaluate`` reports its documented
    fallback of 0.5."""
    if np.unique(target).size != 2:
        raise ValueError("Only one class present in y_true. ROC AUC score is not defined in "
                         "that case.")
    fps, tps = _clf_curve(target, pred)
    return _auc(np.r_[0, fps] / fps[-1], np.r_[0, tps] / tps[-1])


def prc_auc(target: np.ndarray, pred: np.ndarray) -> float:
    """Area under the precision-recall curve (``auc(recall, precision)``
    over ``precision_recall_curve``)."""
    fps, tps = _clf_curve(target, pred)
    ps = tps + fps
    precision = np.where(ps != 0, tps / np.where(ps != 0, ps, 1), 0.0)
    recall = tps / tps[-1] if tps[-1] != 0 else np.ones(tps.shape)
    return _auc(np.r_[recall[::-1], 0.0], np.r_[precision[::-1], 1.0])


def classification_metrics(pred: np.ndarray, target: np.ndarray, trade_off: bool = False) -> dict:
    """``{"auroc", "prc"}`` and, with ``trade_off``, their ``mean``; raises
    ``ValueError`` for a single-class ``target``."""
    pred = np.asarray(pred).reshape(-1)
    target = np.asarray(target).reshape(-1).astype(np.int64)
    out = {"auroc": roc_auc(target, pred), "prc": prc_auc(target, pred)}
    if trade_off:
        out["mean"] = (out["auroc"] + out["prc"]) / 2.0
    return out


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
