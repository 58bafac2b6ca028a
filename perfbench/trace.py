"""Reading the traced epochs from ``torch.profiler``'s Chrome trace: the
device's busy time, kernel time and executions by name, the device
operations that took most time, and the longest idle gaps named by the
benchmark's host span (``perfbench.step``: inside ``StepGraphs.train``;
``perfbench.wait``: between two calls) that the host was in when the gap
began.

The span is the CPU range of ``perfbench.epoch`` (``epochs`` whole epochs,
ending in the last one's bucket synchronise, so every kernel of them lies
inside).
"""

from __future__ import annotations

import bisect
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_SPANS = ("perfbench.step", "perfbench.wait")


def _name(raw: str) -> str:
    """A kernel's name without ``void`` and ``(anonymous namespace)::``."""
    for lead in ("void ", "(anonymous namespace)::"):
        if raw.startswith(lead):
            raw = raw[len(lead):]
    return raw


class Trace:
    def __init__(self, path, launches: dict, epochs: int):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans = [e for e in events if e.get("cat") == "user_annotation"
                 and e.get("name") == "perfbench.epoch"]
        if len(spans) != 1:
            raise RuntimeError(f"{len(spans)} perfbench.epoch spans in the trace, want 1")
        self.t0 = float(spans[0]["ts"])
        self.t1 = self.t0 + float(spans[0]["dur"])
        self.ops = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), _name(e["name"]))
            for e in events if e.get("cat") in DEVICE_CATS
            and self.t0 <= float(e["ts"]) < self.t1)
        self.host = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
            for e in events if e.get("cat") == "user_annotation" and e.get("name") in HOST_SPANS)
        self.host_starts = [a for a, _, _ in self.host]
        self.epochs = epochs
        self.launches = launches  # launch-counter deltas over the epoch
        self.intervals = self._merged()

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _merged(self) -> list[tuple[float, float]]:
        out: list[list[float]] = []
        for a, b, _ in self.ops:
            b = min(b, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.intervals) * 1e-6

    def seconds(self, prefixes) -> float:
        """Device seconds of the operations whose names start with any of
        ``prefixes``."""
        return sum(b - a for a, b, n in self.ops if n.startswith(tuple(prefixes))) * 1e-6

    def count(self, prefix: str) -> int:
        return sum(1 for _, _, n in self.ops if n.startswith(prefix))

    def top_ops(self, k: int = 10) -> list:
        by: dict[str, float] = {}
        for a, b, n in self.ops:
            by[n[:80]] = by.get(n[:80], 0.0) + (b - a) * 1e-6
        return [[n, s] for n, s in sorted(by.items(), key=lambda x: -x[1])[:k]]

    def _host_at(self, t: float) -> str:
        i = bisect.bisect_right(self.host_starts, t) - 1
        if i >= 0 and self.host[i][0] <= t < self.host[i][1]:
            return self.host[i][2]
        return "other"

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest stretches of the span with nothing on the device,
        each named by the host span it began in."""
        starts = [a for a, _ in self.intervals] + [self.t1]
        ends = [self.t0] + [b for _, b in self.intervals]
        gaps = sorted(((s - e, e) for e, s in zip(ends, starts) if s > e), reverse=True)
        return [[self._host_at(t), g * 1e-6] for g, t in gaps[:k]]
