"""The harness finds a cell, its configuration, traffic, cell file and
metrics from files alone, and the repository's ``BENCHMARK.json`` keeps to
the benchmark's contract."""

import json
import re
import types

from conftest import ROOT, TINY_CELL

from perfbench import core

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_throw_away_cell_found_from_files(tiny_root):
    bench = core.benchmark(tiny_root)
    base = tiny_root / "perfbench"
    w = core.workload(bench, TINY_CELL)
    cfg = core.config(bench, w["config"], tiny_root)
    assert cfg["name"] == "tiny_esol" and cfg["yaml"]["batch_size"] == 4
    assert core.traffic(w["traffic"], base)["molecules"] == 20
    assert "limits" in core.cell(TINY_CELL, base)
    names = [m["name"] for m in core.metrics_for(bench, TINY_CELL, "per_layer")]
    assert "steps_seen" in names and "mfu_pct" in names
    run = types.SimpleNamespace(recorder=types.SimpleNamespace(pos=[0, 1, 2]))
    assert core.reader("steps_seen", base).read(run) == 3.0
    assert core.module("drivers", cfg["driver"]).run is not None


def test_benchmark_json_keeps_the_contract():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert bench["paths"] == ["perfbench"] and 1 <= bench["run_seconds"] <= 51
    configs = {c["name"]: c for c in bench["configs"]}
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("perfbench/")
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.append(c["name"])
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in ("device_trace", "program_span",
                                                     "program_counter", "host_clock")
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").is_file()
        names.append(m["name"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert core.traffic(w["traffic"]) and set(core.cell(w["name"])["limits"])
        e2e_here = [m["name"] for m in core.metrics_for(bench, w["name"], "end_to_end")]
        assert "setup_s" in e2e_here and len(e2e_here) >= 2
        assert core.metrics_for(bench, w["name"], "per_layer")
        names.append(w["name"])
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
