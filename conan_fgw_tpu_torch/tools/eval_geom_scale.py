"""The eval path at GEOM-Drugs scale (the port's counterpart of
``scripts/eval_geom_scale.py``).

Builds a synthetic dataset of ``--n`` drug-size molecules (``random_dataset(7,
n, K=5, heavy_range=(8, 13))``; the GEOM sets hold 5-10k molecules of
comparable size), warms the flagship model's stage-1 ``evaluate`` up on the
first four batches, then times one eval epoch over all of them at B=96,
and prints one JSON line: ``n_molecules``, ``batch``, ``conformers``,
``mesh``, ``backend``, ``gen_s`` (making the records on the host),
``warmup_s``, ``eval_epoch_s``, ``molecules_per_s`` and ``val_loss``. The
predictions must be finite and aligned with the records they came from.

* By default one process on the card (``--device cpu``: on the CPU).
* ``--mesh``: 8 ranks on the CPU over gloo (``parallel/mesh.py::launch``),
  each evaluating its row block of every batch, the predictions gathered in
  rank order (``evaluate(..., mesh=)``), which the alignment check holds.

    python -m conan_fgw_tpu_torch.tools.eval_geom_scale [--n 8000] [--mesh] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from conan_fgw_tpu_torch.data.loader import bucket_order
from conan_fgw_tpu_torch.data.synthetic import random_dataset
from conan_fgw_tpu_torch.device import resolve_device
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.parallel import mesh as mesh_lib
from conan_fgw_tpu_torch.train import loop as loop_lib

K, BATCH = 5, 96
MESH_RANKS = 8


def records(n_mols: int, device) -> list:
    return random_dataset(7, n_mols, num_conformers=K, heavy_range=(8, 13), device=device)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run(n_mols: int, mesh=None, device="cuda", state_dict=None,
        batch: int = BATCH) -> tuple[dict, np.ndarray]:
    """One warmed eval epoch over ``n_mols`` molecules at ``batch``; returns
    the printed summary and the predictions in the records' order. The
    model is the seeded flagship, or carries ``state_dict``."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    t0 = time.perf_counter()
    recs = records(n_mols, dev)
    gen_s = time.perf_counter() - t0

    model = ConanModel(device=dev)
    if state_dict is not None:
        model.load_state_dict(state_dict)
    settings = loop_lib.TrainSettings(use_barycenter=False, batch_size=batch)
    max_atoms = loop_lib.dataset_max_atoms(recs)

    # the first batches of every bucket their records reach, before the timed epoch
    t0 = time.perf_counter()
    loop_lib.evaluate(model, recs[:4 * batch], settings, max_atoms, dev, mesh=mesh)
    _sync(dev)
    warmup_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    metrics, pred, y = loop_lib.evaluate(model, recs, settings, max_atoms, dev, mesh=mesh)
    _sync(dev)
    eval_s = time.perf_counter() - t0
    # evaluate's order is the buckets'; back to the records' own
    order = np.asarray(bucket_order(recs, buckets=loop_lib.bucket_boundaries(max_atoms)))
    if pred.shape[0] != len(recs) or order.shape[0] != len(recs):
        raise AssertionError(f"{pred.shape[0]} predictions for {len(recs)} records")
    in_order, y_in_order = np.empty_like(pred), np.empty_like(y)
    in_order[order], y_in_order[order] = pred, y
    want = np.asarray([r.y for r in recs], dtype=y.dtype)
    if not np.array_equal(y_in_order, want):
        raise AssertionError("the predictions are not aligned with their records")
    if not np.isfinite(pred).all():
        raise AssertionError("non-finite predictions")
    summary = {
        "n_molecules": len(recs),
        "batch": batch,
        "conformers": K,
        "mesh": f"{mesh.world}-device" if mesh is not None else None,
        "backend": dev.type,
        "gen_s": gen_s,
        "warmup_s": warmup_s,
        "eval_epoch_s": eval_s,
        "molecules_per_s": len(recs) / eval_s,
        "val_loss": float(metrics["loss"]),
    }
    return summary, in_order


def mesh_rank(mesh, n_mols: int, state_dict, batch: int) -> tuple[dict, np.ndarray]:
    """One rank of ``--mesh`` (run by ``mesh_lib.launch``)."""
    return run(n_mols, mesh=mesh, state_dict=state_dict, batch=batch)


def run_mesh(n_mols: int, ranks: int = MESH_RANKS, state_dict=None,
             batch: int = BATCH) -> tuple[dict, np.ndarray]:
    """``run`` on ``ranks`` CPU ranks over gloo; rank 0's result (every
    rank gathers the same predictions)."""
    return mesh_lib.launch(mesh_rank, ranks, n_mols, state_dict, batch, backend="gloo",
                           device="cpu")[0]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=8000)
    ap.add_argument("--mesh", action="store_true",
                    help=f"run on {MESH_RANKS} CPU ranks over gloo")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    summary, _ = run_mesh(args.n) if args.mesh else run(args.n, device=args.device)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
