"""Runs of one cell in turn, and each metric's spread: the tool that a
cell's bounds are set from.

    python3 perfbench/spread.py --workload schnet_esol.stage2 --seconds 20 \\
        --sets 2 --seeds 11 12 13 14 15 16 [--trace 0] [--out chiprun_out/spread.jsonl]

Each set runs ``perfbench/run.py`` once for every seed (a fresh process a
run, one after another); the sets use the same seeds. Prints each run's
result line, then per set and metric the median and the spread (the
distance between the first and third quartiles as a share of the median,
``statistics.quantiles(n=4)``), and how many runs were correct.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    from perfbench.core import dumps, spread

    rows = []
    for k in range(args.sets):
        for seed in args.seeds:
            t = time.perf_counter()
            proc = subprocess.run([sys.executable, str(ROOT / "perfbench" / "run.py"), "--workload",
                                   args.workload, "--seed", str(seed), "--seconds",
                                   str(args.seconds), "--trace", str(args.trace)],
                                  capture_output=True, text=True, cwd=ROOT)
            wall = time.perf_counter() - t
            lines = proc.stdout.strip().splitlines()
            if proc.returncode != 0 or not lines:
                print(f"set {k} seed {seed}: rc {proc.returncode}\n{proc.stderr[-4000:]}", flush=True)
                continue
            row = dict(json.loads(lines[-1]), set=k, seed=seed, wall_s=wall, phases=lines[-2])
            rows.append(row)
            print(dumps(row), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(dumps(row) + "\n")
    for k in range(args.sets):
        mine = [r for r in rows if r["set"] == k]
        if len(mine) < 2:
            continue
        for name in mine[0]["metrics"]:
            vals = [r["metrics"][name]["value"] for r in mine if name in r["metrics"]]
            print(f"set {k} {name}: median {statistics.median(vals)!r} spread {spread(vals)!r}"
                  f" over {len(vals)} runs", flush=True)
        print(f"set {k}: {sum(r['correct'] for r in mine)} of {len(mine)} correct", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
