#!/usr/bin/env python3
"""Chosen phases of ``chip_smoke.py`` on one NVIDIA card, each run
``--repeat`` times after the kernels are built: a short way to run one
phase again after a change to it, or to see whether a check holds over
many runs.

    python3 scripts/torch_smoke_phases.py esan [graphs ...] [--repeat N]

``dp`` (phase 15) runs phase 5 first, for the one-process test RMSE it is
held to.

Each phase prints what it prints in ``chip_smoke.py`` and checks what it
checks there; the first failed check ends the run with a non-zero code.
This is not the smoke test: ``chip_smoke.py`` alone drives the main path
and prints the result line. Needs the CUDA toolkit and a card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def _rows():
    return {name: {} for name in cs.REPLACES}


PHASES = {
    "kernels": lambda card: cs.phase_kernels("cuda"),
    "runner": lambda card: cs.phase_runner("cuda", card),
    "classification": lambda card: cs.phase_classification("cuda", card),
    "graphs": lambda card: cs.phase_graphs("cuda", card),
    "pipeline": lambda card: cs.phase_pipeline("cuda", card),
    "backbones": lambda card: cs.phase_backbones("cuda", card, _rows()),
    "esan": lambda card: cs.phase_esan("cuda", card, _rows()),
    "determinism": lambda card: cs.phase_determinism(),
    "bf16": lambda card: cs.phase_bf16("cuda", card, _rows()),
    "bf16_kernels": lambda card: cs.phase_bf16_kernels("cuda", _rows()),
    "fgw": lambda card: cs.phase_fgw("cuda", card, _rows()),
    "geom": lambda card: cs.phase_geom("cuda", card, _rows()),
    "dp": lambda card: cs.phase_dp("cuda", card, _rows(), _single(card)),
    "tools": lambda card: cs.phase_tools("cuda", card, _rows()),
    "last": lambda card: cs.phase_last("cuda", card, _rows()),
    "large": lambda card: cs.phase_large("cuda", card, _rows()),
}


def _single(card) -> dict:
    """Phase 5's one-process test RMSE by stage, which phase 15 holds its
    two-rank runner to."""
    out = cs.phase_runner("cuda", card)
    return {label: out[label]["test_rmse"] for label in ("stage 1", "stage 2")}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("phases", nargs="+", choices=sorted(PHASES))
    parser.add_argument("--repeat", type=int, default=1)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_smoke_phases: no CUDA device is available", file=sys.stderr)
        return 2
    from conan_fgw_tpu_torch.device import pin_full_f32

    pin_full_f32()
    card = cs.card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    cs.phase_build()
    for i in range(args.repeat):
        for name in args.phases:
            t = time.perf_counter()
            PHASES[name](card)
            print(f"[phases] {name}, run {i + 1} of {args.repeat}: {time.perf_counter() - t:.1f} s")
    print(f"[phases] all passed in {time.perf_counter() - t0:.1f} s on {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
