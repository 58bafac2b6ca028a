"""The readers of the program's spans and counters
(``perfbench/program_spans.py``) on a small hand-written Chrome trace, and
the trace's other readings unchanged by the program's ``conan.*`` ranges."""

from __future__ import annotations

import collections
import json
import types

import pytest
from conftest import ROOT

from perfbench import core, program_spans
from perfbench import trace as trace_lib

OFF = 123456.0  # the trace's clock minus the program's, in microseconds
NEW = ("queue_wait_ms", "pack_ms", "slot_wait_ms", "replay_ms", "edge_idle_ms", "fgw_sweep_pct")
# (name, start, end) on the trace's clock
SPANS = [
    ("conan.epoch_start", 1100, 1900),
    ("conan.slot_wait", 1300, 1500),  # inside epoch_start: a gap there is the wait's
    ("conan.queue_wait", 1950, 1990),
    ("conan.replay", 2100, 2900),
    ("conan.queue_wait", 4500, 4900),
    ("conan.replay", 5100, 5900),
    ("conan.bucket_sync", 6000, 7000),
    ("conan.epoch_end", 7200, 9000),
]
KERNELS = [(1000, 1400), (1450, 1600), (2200, 4000), (5200, 6100), (6500, 7500)]


def _events(with_program: bool) -> list:
    ev = [{"ph": "X", "cat": "user_annotation", "name": "perfbench.epoch", "pid": 1, "tid": 1,
           "ts": 1000.0, "dur": 10000.0}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "perfbench.step", "pid": 1, "tid": 1,
            "ts": float(a), "dur": 1000.0} for a in (2000, 5000)]
    ev += [{"ph": "X", "cat": "user_annotation", "name": "perfbench.wait", "pid": 1, "tid": 1,
            "ts": 3000.0, "dur": 2000.0}]
    names = ["cfconv_fwd_kernel<128, 64>", "fgw_couplings_kernel<32, false>", "elementwise"]
    ev += [{"ph": "X", "cat": "kernel", "name": names[i % 3], "pid": 0, "tid": 7,
            "ts": float(a), "dur": float(b - a)} for i, (a, b) in enumerate(KERNELS)]
    if with_program:
        ev += [{"ph": "X", "cat": "user_annotation", "name": n, "pid": 1, "tid": 1,
                "ts": float(a), "dur": float(b - a)} for n, a, b in SPANS]
    return ev


def _trace(tmp_path, with_program: bool, name="trace.json"):
    path = tmp_path / name
    path.write_text(json.dumps({"traceEvents": _events(with_program)}))
    launches = {"cfconv_fwd": 2, "fgw_couplings": 2}
    return trace_lib.Trace(path, launches, epochs=1)


@pytest.fixture
def program(monkeypatch):
    """The program's records as its ``utils.profiling`` keeps them: on its
    own clock, by end, with a stale replay of an earlier profiler first; and
    its counters: these spans' seconds (the stale replay's 1 s too) and ten
    steps more outside the profiler, each with a 0.5 ms replay, a 0.2 ms
    slot wait and a 0.1 ms queue wait, 13 replays in all, and 15 batches
    packed in 12 ms (two that no step took: a step's mean is the replays')."""
    from conan_fgw_tpu_torch.utils import profiling

    recs = [("conan.replay", 32, -9e6, -8e6)]
    recs += [(n, 32, a - OFF, b - OFF) for n, a, b in sorted(SPANS, key=lambda s: s[2])]
    recs.append(("fgw.sinkhorn_iters", 300, 9500 - OFF, 9500 - OFF))
    monkeypatch.setattr(profiling, "recorded", collections.deque(recs))
    monkeypatch.setattr(profiling, "counters", collections.Counter({
        "pipeline.pack_s": 0.012, "pipeline.packs": 15, "graphs.replays": 13,
        "graphs.replay_s": 1.0016 + 0.005,
        "graphs.slot_wait_s": 0.0002 + 0.002, "pipeline.queue_wait_s": 0.00044 + 0.001}))
    return profiling


def _run(trace):
    cfg = {"fgw": {"outer_iters": 5, "pgd_iters": 5, "sinkhorn_iters": 5},
           "yaml": {"batch_size": 4}}
    return types.SimpleNamespace(trace=trace, batch_counts=[[], []], cfg=cfg, K=2)


def test_the_six_readers_on_a_small_trace(tmp_path, program):
    run = _run(_trace(tmp_path, with_program=True))
    got = {n: core.reader(n, ROOT / "perfbench").read(run) for n in NEW}
    want = {"queue_wait_ms": 0.1, "pack_ms": 12 / 15, "slot_wait_ms": 0.2, "replay_ms": 0.5,
            "edge_idle_ms": 4.5, "fgw_sweep_pct": 15.0}
    assert got == pytest.approx(want, rel=1e-9)
    # each gap by the innermost span where it begins: the one at 1400 inside
    # the slot wait inside epoch_start is the wait's; the one at 4000 no span's
    idle = program_spans.idle_by_span(run)
    assert idle == pytest.approx({"conan.slot_wait": 0.05, "conan.epoch_start": 0.6, None: 1.2,
                                  "conan.bucket_sync": 0.4, "conan.epoch_end": 3.5})


def test_readers_read_nothing_they_cannot_line_up(tmp_path, program):
    """A replay missing (the stale one then pairs with a step), a replay
    that no offset puts inside its step, no records, no trace: nothing."""
    run = _run(_trace(tmp_path, with_program=False))
    recs = list(program.recorded)
    assert program_spans.traced(run.trace, recs) is not None
    assert program_spans.traced(run.trace, [r for r in recs if r[2] != 5100 - OFF]) is None
    shifted = [("conan.replay", 32, a - OFF, b - OFF + 300) for _, a, b in SPANS[3:6:2]]
    assert program_spans.traced(run.trace, shifted) is None
    program.recorded.clear()
    for n in ("edge_idle_ms", "fgw_sweep_pct"):
        assert core.reader(n, ROOT / "perfbench").read(run) is None
    run.trace = None
    assert program_spans.spans(run) is None


def test_a_program_without_spans_reads_nothing(tmp_path, program, monkeypatch):
    """The parent's program keeps no ``recorded``: every new reader reads
    nothing and none raises."""
    monkeypatch.delattr(program, "recorded")
    run = _run(_trace(tmp_path, with_program=True))
    assert program_spans.program() is None
    assert all(core.reader(n, ROOT / "perfbench").read(run) is None for n in NEW)


def test_conan_ranges_change_no_other_reading(tmp_path):
    """The existing readers and the breakdown read the same numbers from a
    trace with and without the program's ranges."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    counts = types.SimpleNamespace(cfconv_least_s=lambda b, cfg: 1e-4,
                                   fgw_least_s=lambda b, cfg: 2e-5, step_flops=lambda b, cfg: 1e9)
    old = [m["name"] for m in bench["per_layer"] if m["name"] not in NEW]
    out = []
    for with_program in (False, True):
        t = _trace(tmp_path, with_program, f"t{with_program}.json")
        run = _run(t)
        run.counts = counts
        run.recorder = types.SimpleNamespace(wait=[1e-3], host=[2e-3], pos=[0, 1])
        run.window_s = 1.0
        readings = {n: core.reader(n, ROOT / "perfbench").read(run) for n in old}
        out.append((readings, t.top_ops(), t.idle_gaps(), t.busy_s, t.window_s, t.host))
    assert out[0] == out[1]
    assert out[0][0]["device_idle_pct"] > 0 and out[0][0]["cfconv_roofline_pct"] > 0
