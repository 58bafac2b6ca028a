"""Run logging and multi-run aggregation (the port's own copy of
``conan_fgw_tpu/utils/runlog.py``).

Equivalents of the reference's ``conan_fgw/src/utils.py``: a rotating-file +
console logger (``build_logger``, ``utils.py:13-35``) and the mean±std
summary over the N-run loop (``AverageRuns``, ``utils.py:70-128``).
"""

from __future__ import annotations

import logging
import os
from logging.handlers import TimedRotatingFileHandler

import numpy as np


def build_logger(log_path: str | None = None, level=logging.INFO) -> logging.Logger:
    logger = logging.getLogger("conan_fgw_tpu_torch")
    logger.setLevel(level)
    if not any(isinstance(h, logging.StreamHandler) for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(sh)
    if log_path:
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        if not any(
            isinstance(h, TimedRotatingFileHandler)
            and getattr(h, "baseFilename", None) == os.path.abspath(log_path)
            for h in logger.handlers
        ):
            fh = TimedRotatingFileHandler(log_path, when="D", backupCount=7)
            fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
            logger.addHandler(fh)
    return logger


class AverageRuns:
    """Collects one metric dict per run; reports mean ± std per key."""

    def __init__(self):
        self.runs: list[dict] = []

    def register(self, metrics: dict):
        self.runs.append(dict(metrics))

    def summary(self) -> dict:
        keys = sorted({k for r in self.runs for k in r if isinstance(r[k], (int, float))})
        out = {}
        for k in keys:
            vals = np.asarray([r[k] for r in self.runs if k in r], dtype=np.float64)
            out[k] = {"mean": float(vals.mean()), "std": float(vals.std()), "n": len(vals)}
        return out

    def table(self) -> str:
        s = self.summary()
        if not s:
            return "(no runs)"
        width = max(len(k) for k in s) + 2
        lines = [f"{'metric'.ljust(width)}mean ± std (n)"]
        for k, v in s.items():
            lines.append(f"{k.ljust(width)}{v['mean']:.5f} ± {v['std']:.5f} ({v['n']})")
        return "\n".join(lines)
