"""Profiling and per-epoch metric logging (the port's counterpart of
``conan_fgw_tpu/utils/profiling.py``): a ``torch.profiler`` trace context
for the runner's ``--profile_dir`` and the per-epoch ``metrics.csv``
writer."""

from __future__ import annotations

import contextlib
import csv
import os

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
