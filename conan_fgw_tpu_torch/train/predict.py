"""Batch inference: restore a checkpoint and predict over a dataset split
(port of ``conan_fgw_tpu/train/predict.py``).

Also exports the branches' embeddings before fusion, the reference's
visualisation workflow (``EmbeddingsVisualizationBaryCenter``,
``conan_fgw/src/model/schnet_based_models.py:372-417``). Usage, on the card
(``--device cpu`` runs on the CPU)::

    python -m conan_fgw_tpu_torch.train.predict --config config/schnet/sol250_5_bc.yaml \\
        --checkpoint outputs/models/run/0/run_conan_fgw:0 --split test --out preds.csv \\
        [--embeddings emb.npz]
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from conan_fgw_tpu_torch.data.loader import bucket_order, bucketed_batches
from conan_fgw_tpu_torch.device import resolve_device
from conan_fgw_tpu_torch.train import loop as loop_lib
from conan_fgw_tpu_torch.train import metrics as metrics_lib
from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer
from conan_fgw_tpu_torch.train.config import load_config
from conan_fgw_tpu_torch.train.runner import STAGE_BC, build_model, build_settings, load_datasets


def predict_records(model, records, settings, max_atoms=None, device="cuda"):
    """``(records_in_eval_order, predictions, targets)``: the evaluation
    iterator groups molecules by bucket, so its order is ``bucket_order``'s."""
    max_atoms = max_atoms or loop_lib.dataset_max_atoms(records)
    _, pred, y = loop_lib.evaluate(model, records, settings, max_atoms, resolve_device(device))
    order = bucket_order(records, buckets=loop_lib.bucket_boundaries(max_atoms))
    return [records[i] for i in order], pred, y


def export_embeddings(model, records, settings, max_atoms, out_path, device="cuda"):
    """Write ``out_path`` (npz): ``x3d`` (M, K, C) per conformer, ``x_bary``
    (M, C) and ``x_cov`` (M, C) per molecule, and the aligned ``mol_id``,
    ``smiles`` and ``y``."""
    dev = resolve_device(device)
    buckets = loop_lib.bucket_boundaries(max_atoms)
    keys = ("x3d", "x_bary", "x_cov")
    parts = {k: [] for k in keys}
    with torch.no_grad():
        for pb in bucketed_batches(records, settings.batch_size, buckets=buckets):
            out = model.embeddings(pb.to(dev))
            for k in keys:
                parts[k].append(out[k].cpu().numpy()[pb.mol_mask])
    ordered = [records[i] for i in bucket_order(records, buckets=buckets)]
    np.savez_compressed(
        out_path,
        **{k: np.concatenate(parts[k]) for k in keys},
        mol_id=np.asarray([r.mol_id for r in ordered]),
        smiles=np.asarray([r.smiles for r in ordered]),
        y=np.asarray([r.y for r in ordered], np.float32),
    )
    print(f"wrote embeddings for {len(ordered)} molecules to {out_path}")


def main(argv=None) -> float:
    """Predict one split; print and return its RMSE against the targets. A
    classification model's logits become probabilities (a float64 sigmoid),
    as the JAX tool prints and writes them."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--checkpoint", required=True, help="run directory with best/last")
    ap.add_argument("--which", default="best", choices=["best", "last"])
    ap.add_argument("--data_root", default=".")
    ap.add_argument("--split", default="test")
    ap.add_argument("--out", default=None)
    ap.add_argument("--embeddings", default=None, metavar="OUT_NPZ",
                    help="also export the embeddings before fusion (x3d/x_bary/x_cov)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card; cpu runs on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    config = load_config(args.config)
    model = build_model(config, device=dev)
    settings = build_settings(config, STAGE_BC)
    records = load_datasets(config, os.path.join(args.data_root, "data"))[args.split].records()
    max_atoms = settings.max_atoms or loop_lib.dataset_max_atoms(records)
    RunCheckpointer(args.checkpoint).restore_params(model, args.which)

    ordered, pred, y = predict_records(model, records, settings, max_atoms, dev)
    if settings.task == "classification":
        # the model emits logits; surface probabilities
        pred = 1.0 / (1.0 + np.exp(-np.asarray(pred, dtype=np.float64)))
    rows = [
        {"mol_id": r.mol_id, "smiles": r.smiles, "prediction": float(p), "target": float(t)}
        for r, p, t in zip(ordered, pred, y)
    ]
    if args.out:
        with open(args.out, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["mol_id", "smiles", "prediction", "target"])
            w.writeheader()
            w.writerows(rows)
        print(f"wrote {len(rows)} predictions to {args.out}")
    else:
        for r in rows[:20]:
            print(r)
    if args.embeddings:
        export_embeddings(model, records, settings, max_atoms, args.embeddings, dev)
    rmse = metrics_lib.rmse(pred, y)  # as the runner computes test_rmse
    print(f"{args.split} RMSE vs targets: {rmse!r}")
    return rmse


if __name__ == "__main__":
    main()
