"""Profiling and per-epoch metric logging (the port's counterpart of
``conan_fgw_tpu/utils/profiling.py``): a ``torch.profiler`` trace context
for the runner's ``--profile_dir``, the program's spans and counters, and
the per-epoch ``metrics.csv`` writer.

``span(name, args, counter=...)`` marks one piece of the program's work.
Where a ``torch.profiler`` records on the calling thread, it opens a
``record_function`` range ``conan.<name>``, which lands in the profiler's
Chrome trace on the clock of the card's events, and keeps the span in
``recorded``. Otherwise it costs one check of the profiler's state (and,
with a ``counter``, a ``perf_counter`` pair). With a ``counter`` it adds its
seconds to ``counters[counter]`` either way. A profiler records only on the
thread that started it: on another thread (the prefetch thread's packing)
a span is its counter alone.

``counters`` holds the program's host and device tallies by name
(``pipeline.*``, ``graphs.*``, ``fgw.*``), beside the kernels' launch counts
(``ops.cuda.launches``), which it does not merge with; ``add`` adds to one.
Each name is written from one thread. ``recorded`` keeps, newest last, the
spans and additions made while a profiler recorded on their thread, as
``(name, args, start_us, end_us)`` on ``time.perf_counter``'s clock (an
addition has ``start_us == end_us`` and its value as ``args``), for a reader
in the same process that lines them up with the trace: the benchmark's,
until its trace reader keeps the ``conan.*`` ranges itself.
"""

from __future__ import annotations

import collections
import contextlib
import csv
import os
from time import perf_counter

import torch

# spans and additions ``recorded`` keeps: a traced epoch makes a few hundred
RECORDED = 1 << 16

counters: collections.Counter = collections.Counter()
recorded: collections.deque = collections.deque(maxlen=RECORDED)
_profiling = torch._C._autograd._profiler_enabled  # this thread's profiler state


def reset_counters() -> None:
    """Set every counter to zero."""
    counters.clear()


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        return False


_NOOP = _Noop()


class _Timed:
    """Adds the seconds it encloses to ``counters[key]``: one a counter
    (``_timer``), which one thread writes, so its spans do not nest."""

    __slots__ = ("key", "t0")

    def __init__(self, key: str):
        self.key = key

    def __enter__(self):
        self.t0 = perf_counter()
        return self

    def __exit__(self, kind, value, tb):
        counters[self.key] += perf_counter() - self.t0
        return False


_timers: dict = {}


def _timer(key: str) -> _Timed:
    """The ``_Timed`` of counter ``key``."""
    timer = _timers.get(key)
    if timer is None:
        timer = _timers[key] = _Timed(key)
    return timer


class _Recorded:
    """A span under a profiler: a ``record_function`` range, kept in
    ``recorded`` and, with a counter, added to it."""

    __slots__ = ("name", "args", "key", "t0", "range")

    def __init__(self, name: str, args, key: str | None):
        self.name, self.args, self.key = "conan." + name, args, key

    def __enter__(self):
        self.range = torch.profiler.record_function(
            self.name, None if self.args is None else str(self.args))
        self.range.__enter__()
        self.t0 = perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = perf_counter()
        self.range.__exit__(*exc)
        if self.key is not None:
            counters[self.key] += t1 - self.t0
        recorded.append((self.name, self.args, 1e6 * self.t0, 1e6 * t1))
        return False


def span(name: str, args=None, counter: str | None = None):
    """A context manager around one piece of the program's work: under a
    profiler on this thread the range ``conan.<name>`` (``args``, such as a
    step's bucket N, as its argument string), else a shared no-op; with a
    ``counter``, its seconds added to ``counters[counter]`` in both cases."""
    if _profiling():
        return _Recorded(name, args, counter)
    return _NOOP if counter is None else _timer(counter)


def add(key: str, value) -> None:
    """``counters[key] += value``, kept in ``recorded`` under a profiler on
    this thread."""
    counters[key] += value
    if _profiling():
        t = 1e6 * perf_counter()
        recorded.append((key, value, t, t))


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
