"""One table over the runner's ``--out_json`` summaries in a directory (the
port's counterpart of ``scripts/summarize_protocol.py``): a row a file, its
test metric's mean ± std over the runs and the number of runs.

    python -m conan_fgw_tpu_torch.tools.summarize_protocol [dir]

``dir`` defaults to ``outputs/protocol``.
"""

from __future__ import annotations

import glob
import json
import os
import sys


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    rows = []
    for path in sorted(glob.glob(os.path.join(argv[0] if argv else "outputs/protocol", "*.json"))):
        with open(path) as f:
            s = json.load(f)
        r = s.get("test_rmse") or s.get("test_auroc")
        if not r:
            continue
        rows.append((os.path.basename(path).removesuffix(".json"),
                     f"{r['mean']:.4f} ± {r['std']:.4f}", r.get("n", "")))
    w = max(len(r[0]) for r in rows) if rows else 8
    print(f"{'protocol':<{w}}  test metric (mean ± std)  n")
    for name, metric, n in rows:
        print(f"{name:<{w}}  {metric:<24}  {n}")


if __name__ == "__main__":
    main()
