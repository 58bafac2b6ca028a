"""Fixtures of the benchmark's own tests (``pytest perfbench/tests``).

``tiny_root`` is a throw-away benchmark in a temporary directory: the
``schnet_esol`` configuration cut to batch 4 and K=2, a traffic of small
molecules in two buckets, one cell and the real metric readers beside one
of its own, small enough to run whole on the CPU.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_CELL = "tiny_esol.stage2"


@pytest.fixture(autouse=True, scope="session")
def few_threads():
    """Two CPU threads a test process: the tests run beside others."""
    import torch

    torch.set_num_threads(2)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def write_tiny_root(root: Path, molecules: int = 20, limits: dict | None = None) -> Path:
    base = root / "perfbench"
    for sub in ("configs", "traffic", "cells"):
        (base / sub).mkdir(parents=True)
    shutil.copytree(ROOT / "perfbench" / "metrics", base / "metrics")
    (base / "metrics" / "steps_seen.py").write_text(
        '"""Steps the window ran (a throw-away metric of the tests)."""\n\n\n'
        "def read(run):\n    return float(len(run.recorder.pos))\n")
    cfg = json.loads((ROOT / "perfbench" / "configs" / "schnet_esol.json").read_text())
    cfg["yaml"] = dict(cfg["yaml"], batch_size=4, num_conformers=2)
    (base / "configs" / "tiny_esol.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "perfbench" / "traffic" / "esol.json").read_text())
    traffic.update(molecules=molecules,
                   sizes={"kind": "atom_ranges", "ranges": [[8, 30], [33, 40]], "size_seed": 3})
    (base / "traffic" / "tiny.json").write_text(json.dumps(traffic))
    real = json.loads((ROOT / "perfbench" / "cells" / "schnet_esol.stage2.json").read_text())
    # the real cell's limits, of the numbers the tiny traffic's buckets (32, 64) have
    kept = {k: v for k, v in real["limits"].items() if k.split(".")[-1] in (k, "32", "64")}
    (base / "cells" / f"{TINY_CELL}.json").write_text(json.dumps({"limits": limits or kept}))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny_esol", "source": "tests", "file": "perfbench/configs/tiny_esol.json",
                         "reduced": ["batch_size", "num_conformers"], "why": "tests"}]
    bench["workloads"] = [{"name": TINY_CELL, "config": "tiny_esol", "traffic": "tiny", "chips": 1,
                           "why": "tests"}]
    bench["per_layer"] = bench["per_layer"] + [
        {"name": "steps_seen", "unit": "steps", "better": "higher", "source": "program_counter",
         "layer": "tests", "moves": "train_graphs_per_s"}]
    for m in bench["per_layer"][:-1]:
        m["workloads"] = [TINY_CELL]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return write_tiny_root(tmp_path)


def tiny_run(root: Path, seed: int = 2**31 + 5, trace: int = 0, seconds: float = 0.2):
    """One CPU run of the throw-away cell: ``(result, check lines)``."""
    import time

    import torch

    from perfbench import run as run_lib

    torch.set_num_threads(2)
    args = run_lib.parse(["--workload", TINY_CELL, "--seed", str(seed), "--seconds", str(seconds),
                          "--trace", str(trace)])
    result, lines, _ = run_lib.measure(args, "cpu", root=root, t_start=time.perf_counter())
    return result, lines
