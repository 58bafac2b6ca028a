"""What the harness finds by name: the benchmark's cells, configurations,
traffic mixes, cell files, metric readers and the modules a configuration
names (its driver, plain reference and counts).

``BENCHMARK.json`` at the checkout's root lists them; each lives in a file
of its own under ``perfbench/``:

- a configuration: the ``file`` its entry names (``configs/<name>.json``),
  which names its ``driver`` (``drivers/<driver>.py``), its ``reference``
  (``references/<reference>.py``) and its ``counts``
  (``counts/<counts>.py``);
- a traffic mix: ``traffic/<traffic>.json``;
- a cell: ``cells/<workload>.json`` (its check steps and the limits of the
  numbers its correctness check compares);
- a metric: ``metrics/<name>.py``, whose ``read(run)`` returns the value or
  None where the run has nothing for it to read.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return dict(load_json(root / c["file"]), name=name)
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return dict(load_json(base / "traffic" / f"{name}.json"), name=name)


def cell(name: str, base: Path = HERE) -> dict:
    return load_json(base / "cells" / f"{name}.json")


def metrics_for(bench: dict, cell_name: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell_name`` reports."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]


def module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` (a driver, a reference, counts)."""
    return importlib.import_module(f"perfbench.{kind}.{name}")


def reader(name: str, base: Path = HERE):
    """The reader of metric ``name``: ``perfbench/metrics/<name>.py``, loaded
    by its path (a name may hold dots)."""
    path = base / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def spread(values) -> float:
    """The distance between the first and third quartiles as a share of the
    median (``statistics.quantiles(values, n=4)``)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def dumps(obj) -> str:
    return json.dumps(obj, separators=(", ", ": "))
