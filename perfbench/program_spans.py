"""The program's own spans and counters, for the per-layer readers of the
``--trace 1`` run.

``conan_fgw_tpu_torch.utils.profiling`` keeps, in the benchmark's process,
its counters and the spans and additions made while a profiler recorded
(``recorded``: ``(name, args, start_us, end_us)`` on ``time.perf_counter``'s
clock). Host times are read from the counters less what the profiler saw
(``untraced_ms``): under CUPTI a graph's replay takes several times its
host time, so the traced epochs would read the profiler. The device's idle
gaps and the Sinkhorn count are read from the traced epochs, whose spans
are lined up with the trace through the graph replays:
each traced step's ``perfbench.step`` range (``Trace.host``) holds exactly
one ``conan.replay`` span, the last ones the program recorded. The clock
offset is the one that puts every replay inside its step, to within
``SLACK_US``; where no offset does, or the counts differ, or the program
keeps no spans (a version without them, or steps without graphs, as on the
CPU), the readers read nothing.
"""

from __future__ import annotations

import bisect

STEP = "perfbench.step"
REPLAY = "conan.replay"
SLACK_US = 50.0
# the loop's edges: a bucket's closing synchronise, a pass's set-up and its
# prefetch thread's end
EDGES = ("conan.bucket_sync", "conan.epoch_start", "conan.epoch_end")


def program():
    """The program's ``utils.profiling`` where it keeps spans and counters,
    else None."""
    try:
        from conan_fgw_tpu_torch.utils import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "recorded") and hasattr(profiling, "counters")):
        return None
    return profiling


def traced(trace, records) -> list | None:
    """``records`` that begin inside the traced epochs, on the trace's clock:
    ``[(name, args, start_us, end_us), ...]``, or None where they cannot be
    lined up with the trace's steps."""
    if trace is None:
        return None
    steps = [(a, b) for a, b, n in trace.host if n == STEP and trace.t0 <= a < trace.t1]
    replays = [r for r in records if r[0] == REPLAY]
    if not steps or len(replays) < len(steps):
        return None
    replays = replays[-len(steps):]
    lo = max(a - r[2] for (a, _), r in zip(steps, replays))
    hi = min(b - r[3] for (_, b), r in zip(steps, replays))
    if lo > hi + SLACK_US:
        return None
    off = 0.5 * (lo + hi)
    return [(n, v, a + off, b + off) for n, v, a, b in records if trace.t0 <= a + off < trace.t1]


def spans(run) -> tuple[list, int] | None:
    """The program's records of the traced epochs and their steps, or None."""
    prog = program()
    if prog is None or run.trace is None:
        return None
    recs = traced(run.trace, list(prog.recorded))
    if recs is None:
        return None
    return recs, run.trace.epochs * len(run.batch_counts)


def untraced_ms(name: str, counter: str) -> float | None:
    """Mean milliseconds a graphed step of ``counter``, the host seconds of
    the spans ``name``, outside the profiler's reach: the counter less the
    spans it recorded, over the replays (``graphs.replays``) less those it
    recorded. Both sides hold every pass of the run, the set-up's warm
    epochs too: a shape's eager first step and its capture add their waits
    to the counter and no replay, a few a shape against the window's
    thousands of replays."""
    prog = program()
    if prog is None:
        return None
    recs = list(prog.recorded)
    seconds = prog.counters[counter] - 1e-6 * sum(b - a for n, _, a, b in recs if n == name)
    steps = prog.counters["graphs.replays"] - sum(1 for r in recs if r[0] == REPLAY)
    return 1e3 * seconds / steps if steps > 0 else None


def total(run, name: str):
    """The sum of the traced epochs' additions to counter ``name``."""
    got = spans(run)
    if got is None:
        return None
    return sum(v for n, v, a, b in got[0] if n == name and a == b)


def innermost(recs) -> tuple[list, list]:
    """Change points ``(times, names)`` of the innermost open span (None
    where none is open) of properly nested spans."""
    times, names, stack = [], [], []

    def close_to(t):
        while stack and stack[-1][0] <= t:
            end, _ = stack.pop()
            times.append(end)
            names.append(stack[-1][1] if stack else None)

    for n, _, a, b in sorted((r for r in recs if r[3] > r[2]), key=lambda r: (r[2], -r[3])):
        close_to(a)
        stack.append((b, n))
        times.append(a)
        names.append(n)
    close_to(float("inf"))
    return times, names


def idle_by_span(run) -> dict | None:
    """Device-idle milliseconds an epoch of the traced epochs, by the
    innermost program span open where each gap begins (None: no span)."""
    got = spans(run)
    if got is None:
        return None
    t = run.trace
    times, names = innermost(got[0])
    starts = [a for a, _ in t.intervals] + [t.t1]
    ends = [t.t0] + [b for _, b in t.intervals]
    out: dict = {}
    for e, s in zip(ends, starts):
        if s > e:
            i = bisect.bisect_right(times, e) - 1
            name = names[i] if i >= 0 else None
            out[name] = out.get(name, 0.0) + (s - e) * 1e-3 / t.epochs
    return out
