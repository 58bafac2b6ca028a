"""Profiling, step timing and per-epoch metric logging (the port's
counterpart of ``conan_fgw_tpu/utils/profiling.py``): a ``torch.profiler``
trace context for the runner's ``--profile_dir``, a step timer with
percentile summaries, and the per-epoch ``metrics.csv`` writer."""

from __future__ import annotations

import contextlib
import csv
import os
import time

import numpy as np
import torch


@contextlib.contextmanager
def device_trace(logdir: str):
    """Trace the enclosed work with ``torch.profiler`` (the card's kernels
    too where a card is present) and write ``trace.json``, a Chrome trace,
    into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    """Wall-clock step timing with summary statistics. With a CUDA
    ``device`` each timed block ends in a synchronise of that card, so that
    a step's time includes the kernels it queued."""

    def __init__(self, skip_first: int = 1, device: str | torch.device | None = None):
        self.times: list[float] = []
        self.skip_first = skip_first
        self.device = None if device is None else torch.device(device)
        self._t0 = None

    def _sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.times.append(time.perf_counter() - self._t0)

    def summary(self) -> dict:
        """``steps``, ``mean_s``, ``p50_s``, ``p95_s`` and ``max_s`` over the
        times after the first ``skip_first`` (over all of them if that
        leaves none)."""
        t = np.asarray(self.times[self.skip_first:] or self.times)
        return {
            "steps": len(t),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "max_s": float(t.max()),
        }


class PhaseCSVLogger:
    """Append rows (one per epoch) to a CSV, the header from the first row."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._wrote_header = os.path.exists(path)

    def log(self, row: dict):
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(row))
            if not self._wrote_header:
                w.writeheader()
                self._wrote_header = True
            w.writerow(row)
