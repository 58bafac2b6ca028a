"""End-to-end two-stage training on synthetic molecules (the port's
counterpart of ``scripts/synthetic_e2e.py``).

Runs the whole training path on a deterministic synthetic dataset with a
learnable, geometry-dependent target, through
``run_experiment(datasets=...)``: stage 1 (``conan_fgw_pre``), then stage 2
(``conan_fgw``) warm-started from it, with early stopping, checkpoints and
the test evaluation. The molecules have K=3 conformers and the batch is 32,
so stage 2 solves 96 FGW couplings a step. Prints both stages' test RMSE
and the train target's standard deviation (the RMSE of predicting the
mean).

    python -m conan_fgw_tpu_torch.tools.synthetic_e2e [--device cpu] [--epochs 60] [--size 200]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import numpy as np

from conan_fgw_tpu_torch.data.synthetic import random_dataset
from conan_fgw_tpu_torch.train.config import ExperimentConfig
from conan_fgw_tpu_torch.train.runner import STAGE_BC, STAGE_PRE, run_experiment
from conan_fgw_tpu_torch.utils.runlog import build_logger

K, BATCH = 3, 32


def datasets(size: int, device) -> dict:
    """``random_dataset(123, size + 60, K=3)`` split into ``size`` train
    molecules, 30 valid and 30 test."""
    full = random_dataset(123, size + 60, num_conformers=K, heavy_range=(4, 9), device=device)
    return {"train": full[:size], "valid": full[size:size + 30], "test": full[size + 30:]}


def config(experiment: str, lr: float, epochs: int) -> ExperimentConfig:
    return ExperimentConfig(
        dataset_name=["synthetic"], target=["y"], num_conformers=K, batch_size=BATCH,
        experiment=experiment, num_epochs=epochs, learning_rate=lr,
        es_patience=max(10, epochs), max_atoms=32,
    )


def run(epochs: int, size: int, models_dir: str, device="cuda") -> dict:
    """Both stages; returns their summaries and histories (``stage1``,
    ``stage2``: ``(summary, per_run)`` as ``run_experiment`` returns them)
    and the train target's std."""
    data = datasets(size, device)
    common = dict(datasets=data, run_name="synth", run_id="0", models_dir=models_dir,
                  device=device)
    print("=== stage 1: conan_fgw_pre ===", flush=True)
    s1 = run_experiment(config("regression", 2e-3, epochs), stage=STAGE_PRE, **common)
    print("=== stage 2: conan_fgw (warm-started) ===", flush=True)
    s2 = run_experiment(config("regression_bc", 1e-3, epochs), stage=STAGE_BC, **common)
    return {"stage1": s1, "stage2": s2,
            "target_std": float(np.asarray([r.y for r in data["train"]]).std())}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card; cpu runs on the CPU)")
    ap.add_argument("--epochs", type=int, default=60)
    ap.add_argument("--size", type=int, default=200)
    ap.add_argument("--models_dir", default="outputs/synthetic_e2e/models")
    args = ap.parse_args(argv)
    build_logger()
    out = run(args.epochs, args.size, args.models_dir, args.device)
    r1 = out["stage1"][0]["test_rmse"]["mean"]
    r2 = out["stage2"][0]["test_rmse"]["mean"]
    print(f"\nstage-1 test RMSE: {r1:.4f}\nstage-2 test RMSE: {r2:.4f}")
    print(f"target std (predict-the-mean RMSE floor): {out['target_std']:.4f}")
    return out


if __name__ == "__main__":
    main()
