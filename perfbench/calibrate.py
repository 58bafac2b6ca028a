"""The readings that a cell's correctness limits are set from, on the card:
for each seed, the program's checked steps against the plain reference
(the lower reading), and where asked the control and the faults in the
program's place against the same reference (the upper readings).

    python3 perfbench/calibrate.py --workload schnet_esol.stage2 --seeds 11 12 13 \\
        [--control] [--half]

- ``--control``: the reference in float32 with TF32 products (the nearest
  precision below the configurations' float32 with TF32 off);
- ``--half``: the reference on the first half of each batch, the mean over
  those rows (half of the batch left out): in every bucket, then in each
  bucket alone.

A state left unchanged reads 1 on ``grad_med`` and ``change_med`` by
their definitions (a first moment and a change of 0) and needs no run.
Prints one JSON line per seed and reading, with each first step's bucket
and loss gap.
The benchmark's own runs do not run this; each seed sets up the program
(data, model, warm epochs) without a window.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--half", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from perfbench import core
    from perfbench.drivers import conan_train as drv

    bench = core.benchmark(ROOT)
    w = core.workload(bench, args.workload)
    cfg = core.config(bench, w["config"], ROOT)
    traffic = core.traffic(w["traffic"])
    for seed in args.seeds:
        s = drv.Session(cfg, traffic, seed, args.device)
        s.warm()
        prog = s.checked_steps()
        s.free()
        ref = drv.reference_steps(s)
        buckets = drv.first_buckets(s)
        readings = {"program": prog}
        if args.control:
            readings["control_tf32"] = drv.reference_steps(s, dtype=torch.float32, tf32=True)
        if args.half:
            readings["fault_half_batch"] = drv.reference_steps(s, half=tuple(buckets))
            for N in dict.fromkeys(buckets):
                readings[f"fault_half_batch.{N}"] = drv.reference_steps(s, half=(N,))
        for name, out in readings.items():
            print(core.dumps({"seed": seed, "reading": name, **drv.gaps(out, ref, buckets),
                              "steps": list(zip(buckets, drv.step_gaps(out, ref)))}), flush=True)
        del s
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
