"""The benchmark of ``conan_fgw_tpu_torch`` on one card: one run of one cell.

    python3 perfbench/run.py --workload schnet_esol.stage2 --seed 7 --seconds 20 --trace 0

Prints a line of set-up phases, then as its last line one JSON object:
``correct``, ``attempted`` and ``failed`` (the window's steps and those
whose loss was not finite), ``metrics`` (the cell's end-to-end metrics,
or with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number the correctness check
compares beside its limit (also the last lines of standard error).
Everything a cell needs is found by name from ``BENCHMARK.json``
(``perfbench/core.py``). Exits non-zero without a result where there is
no card, fewer cards than the cell asks, or where JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "conan_fgw_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or the
    JAX package's (compared whole: ``conan_fgw_tpu_torch`` is not one)."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def measure(args, device: str, root: Path = ROOT, t_start: float | None = None):
    """One run on ``device`` of the benchmark at ``root`` (its
    ``BENCHMARK.json`` and ``perfbench/`` folder); returns ``(result dict,
    stderr check lines, set-up phases)``. The tests call it on the CPU with
    small throw-away cells."""
    import torch

    from perfbench import core
    from perfbench import trace as trace_lib

    base = root / "perfbench"
    bench = core.benchmark(root)
    w = core.workload(bench, args.workload)
    cfg = core.config(bench, w["config"], root)
    traffic = core.traffic(w["traffic"], base)
    cell = core.cell(args.workload, base)
    driver = core.module("drivers", cfg["driver"])
    out = driver.run(cfg, traffic, args.seed, args.seconds, bool(args.trace), device,
                     T_START if t_start is None else t_start)
    s = out["session"]
    trace = None
    if out["trace"] is not None:
        path, launches = out["trace"]
        trace = trace_lib.Trace(path, launches, driver.TRACE_EPOCHS)
        path.unlink()
        path.parent.rmdir()
    run = types.SimpleNamespace(
        recorder=out["recorder"], window_s=out["window_s"], setup_s=out["setup_s"],
        peak_bytes=out["peak_bytes"], trace=trace, counts=s.counts, cfg=cfg,
        K=cfg["yaml"]["num_conformers"], batch_counts=driver.batch_counts(s))
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in core.metrics_for(bench, args.workload, kind):
        value = core.reader(m["name"], base).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = cell["limits"]
    checks = {k: {"value": out["numbers"][k], "limit": v} for k, v in limits.items()}
    correct = all(v["value"] <= v["limit"] for v in checks.values())
    dev = torch.device(device)
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": w["chips"], "memory_peak_bytes": out["peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if trace is not None:
        device_info["busy_s"] = trace.busy_s
        device_info["window_s"] = trace.window_s
        result["breakdown"] = {"device_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    result["checks"] = checks
    lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    return result, lines, out["phases"]


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from perfbench import core

    bench = core.benchmark(ROOT)
    chips = core.workload(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA card(s);"
              f" {torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result, lines, phases = measure(args, "cuda")
    found = forbidden_modules()
    if found:
        print(f"perfbench: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    print("perfbench setup phases: " + core.dumps(phases), flush=True)
    print(core.dumps(result), flush=True)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
