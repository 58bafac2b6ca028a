"""Experiment runner: the two-stage N-run pipeline (port of
``conan_fgw_tpu/train/runner.py``).

Equivalent of the reference's ``conan_fgw/src/train_val.py``: for each of
``number_of_runs`` runs, build the model, warm-start stage ``conan_fgw``
from stage ``conan_fgw_pre``'s best checkpoint, fit with early stopping,
evaluate the best checkpoint on the test split, and aggregate mean ± std
across runs. Checkpoints go to
``{models_dir}/{run_name}/{run_id}/run_{stage}:{i}``.

Usage, on the card (``--device cpu`` runs on the CPU)::

    python -m conan_fgw_tpu_torch.train.runner --config config/schnet/sol250_5.yaml \\
        --stage conan_fgw_pre
    python -m conan_fgw_tpu_torch.train.runner --config config/schnet/sol250_5_bc.yaml \\
        --stage conan_fgw

The port carries ``ConanModel`` with the SchNet, ViSNet and DimeNet
backbones, for regression and classification, on the conformer datasets;
what else a config can ask for raises ``NotImplementedError`` naming its
``ROADMAP.md`` item (``check_supported``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os

import torch

from conan_fgw_tpu_torch.data.datasets import ConformerDataset, class_weight_ratio
from conan_fgw_tpu_torch.device import resolve_device
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.ops.fgw.barycenter import FGWConfig
from conan_fgw_tpu_torch.train import loop as loop_lib
from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer, find_pre_stage_dir
from conan_fgw_tpu_torch.train.config import ExperimentConfig, load_config
from conan_fgw_tpu_torch.utils.runlog import AverageRuns, build_logger

log = logging.getLogger("conan_fgw_tpu_torch")

STAGE_PRE = "conan_fgw_pre"
STAGE_BC = "conan_fgw"


def check_supported(config: ExperimentConfig, device: torch.device) -> None:
    """Raise for what a config asks and the port does not carry."""
    spec = config.spec
    if spec.dataset != "conformers":
        raise NotImplementedError(
            f"dataset: {spec.dataset} is not ported yet (ROADMAP.md §1, item 7)")
    if spec.model != "conan":
        raise NotImplementedError(
            f"the {spec.model!r} head family (aux and ESAN heads) is not ported yet "
            "(ROADMAP.md §1, item 5)")
    if config.model_name not in ("schnet", "visnet", "dimenet"):
        raise ValueError(f"unknown model_name {config.model_name!r}")
    if config.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype: {config.compute_dtype} is not ported yet (ROADMAP.md §1, item 9)")
    if device.type == "cuda":
        for key in ("use_pallas_cfconv", "use_pallas_fgw"):
            if getattr(config, key) is False:
                raise ValueError(
                    f"{key}: false asks for a plain PyTorch version, which the port runs "
                    "on the CPU only; on the card the kernels run")


def build_model(config: ExperimentConfig, *, seed: int = 0, device="cuda") -> ConanModel:
    """The config's backbone at hidden 128 for regression, 512 for
    classification, a cap of 32 neighbours, and the FGW solver. SchNet: 3
    interactions, cutoff 10, and 128 filters with 50 Gaussians for
    regression, 256 with 10 for classification. ViSNet: cutoff 5, the
    barycenter branch shifted by 1.0 and its columns L2-normalised. DimeNet:
    cutoff 5, the barycenter solved with alpha 0.5 and a fixed structure
    (as the JAX runner wires them, after the reference's wrappers)."""
    dev = resolve_device(device)
    check_supported(config, dev)
    if config.fgw_from_config:
        # opt-in: the YAML's max_iter/epsilon reach the solver
        fgw = FGWConfig(outer_iters=config.max_iter, epsilon=config.epsilon)
    else:
        # the reference hardcodes 5/5/5 iterations and epsilon=0.1 whatever
        # the YAML says (schnet_no_sum.py:294-300)
        fgw = FGWConfig()
    if config.fgw_pgd_iters is not None:
        fgw = dataclasses.replace(fgw, pgd_iters=config.fgw_pgd_iters)
    if config.fgw_sinkhorn_iters is not None:
        fgw = dataclasses.replace(fgw, sinkhorn_iters=config.fgw_sinkhorn_iters)
    task = config.spec.task
    common = dict(task=task, hidden_channels=512 if task == "classification" else 128,
                  agg_weight=config.agg_weight, bary_pad_mode=config.bary_pad_mode, seed=seed,
                  device=dev)
    if config.model_name == "visnet":
        # the wrapper's cutoff; the barycenter branch shifts by 1.0 and
        # L2-normalises the barycenter's columns (visnet.py:50,233-241)
        return ConanModel(backbone_name="visnet", cutoff=5.0, fgw=fgw, bary_shift=1.0,
                          bary_postnorm="l2col", **common)
    if config.model_name == "dimenet":
        # the barycenter with alpha 0.5 and the first conformer's structure
        # held fixed (dimenet.py:235-260)
        fgw = dataclasses.replace(fgw, alpha=0.5, fixed_structure=True)
        return ConanModel(backbone_name="dimenet", cutoff=5.0, fgw=fgw, bary_shift=0.5, **common)
    filters, gaussians = (256, 10) if task == "classification" else (128, 50)
    return ConanModel(backbone_name="schnet", num_filters=filters, num_gaussians=gaussians,
                      num_interactions=3, cutoff=10.0, fgw=fgw, **common)


def build_settings(config: ExperimentConfig, stage: str,
                   loss_scale: float | None = None) -> loop_lib.TrainSettings:
    """The task's schedule and monitor: regression plateau patience 10 and
    factor 0.8 on ``val_mse``; classification patience 5 and factor 0.5 on
    ``val_mean`` with ``trade_off``, else ``val_auroc``."""
    task = config.spec.task
    if task == "classification":
        schedule = dict(plateau_patience=5, plateau_factor=0.5,
                        monitor="val_mean" if config.trade_off else "val_auroc")
    else:
        schedule = dict(plateau_patience=10, plateau_factor=0.8, monitor="val_mse")
    return loop_lib.TrainSettings(
        task=task,
        loss_scale=loss_scale,
        trade_off=config.trade_off,
        learning_rate=config.learning_rate,
        num_epochs=config.num_epochs,
        batch_size=config.batch_size,
        use_barycenter=config.spec.barycenter and stage == STAGE_BC,
        es_patience=config.es_patience,
        es_min_delta=config.es_min_delta,
        max_atoms=config.max_atoms,
        eval_guard=config.eval_guard,
        **schedule,
    )


def load_datasets(config: ExperimentConfig, data_dir: str) -> dict[str, ConformerDataset]:
    name, target = config.dataset_name[0], config.target[0]
    return {
        mode: ConformerDataset(mode, data_dir, name, target, config.num_conformers,
                               prune_conformers=config.prune_conformers)
        for mode in ("train", "valid", "test")
    }


def _pre_stage_dir(pre_ckpt_dir, models_dir, run_name, run_id, run_idx) -> str:
    """Stage 1's checkpoint directory for run ``run_idx``: by default the
    same run_name/run_id; ``pre_ckpt_dir`` (the reference's
    ``--conan_fgw_pre_ckpt_dir``) may hold the per-run
    ``run_conan_fgw_pre:{i}`` directories or be one checkpoint directory."""
    if pre_ckpt_dir is None:
        return find_pre_stage_dir(models_dir, run_name, run_id, run_idx)
    candidate = os.path.join(pre_ckpt_dir, f"run_{STAGE_PRE}:{run_idx}")
    return candidate if os.path.isdir(candidate) else pre_ckpt_dir


def run_experiment(
    config: ExperimentConfig,
    *,
    stage: str = STAGE_PRE,
    data_dir: str = "data",
    number_of_runs: int = 1,
    run_name: str = "run",
    run_id: str = "0",
    models_dir: str = "outputs/models",
    resume: bool = False,
    profile_dir: str | None = None,
    metrics_dir: str | None = None,
    pre_ckpt_dir: str | None = None,
    allow_scratch: bool = False,
    device="cuda",
):
    """Train and evaluate ``number_of_runs`` times; returns ``(summary,
    per_run)``, the second a list of ``{"metrics", "history"}``."""
    dev = resolve_device(device)
    check_supported(config, dev)
    ds = load_datasets(config, data_dir)
    datasets = {m: ds[m].records() for m in ("train", "valid", "test")}

    def train_records(epoch: int):
        # stores holding more than K conformers re-draw the K-subset every
        # epoch (the reference's per-__getitem__ resampling,
        # conan_fgw/src/data/datasets.py:150-168), keyed on the epoch
        ds["train"].set_epoch(epoch)
        return ds["train"].records()

    loss_scale = None
    if config.spec.task == "classification":
        # the BCE's class-weight rescale from the train split's labels
        loss_scale = class_weight_ratio([{"y": r.y} for r in datasets["train"]])

    avg = AverageRuns()
    per_run = []
    for run_idx in range(number_of_runs):
        settings = build_settings(config, stage, loss_scale)
        settings.seed = settings.seed + run_idx
        model = build_model(config, seed=settings.seed, device=dev)
        ckpt = RunCheckpointer(
            os.path.join(models_dir, run_name, str(run_id), f"run_{stage}:{run_idx}"),
            monitor=settings.monitor,
        )
        warm = False
        if stage == STAGE_BC:
            pre_dir = _pre_stage_dir(pre_ckpt_dir, models_dir, run_name, run_id, run_idx)
            pre_ckpt = RunCheckpointer(pre_dir)
            if pre_ckpt.has("best"):
                settings.max_atoms = settings.max_atoms or loop_lib.dataset_max_atoms(
                    datasets["train"] + datasets["valid"])
                pre_ckpt.restore_params(model, "best")
                warm = True
                log.info("warm-started run %d from %s", run_idx, pre_dir)
            elif allow_scratch:
                log.warning("no stage-1 checkpoint at %s; training from scratch", pre_dir)
            else:
                # the reference fails on a missing stage-1 checkpoint
                # (utils.py:55-63); training from scratch is opt-in
                raise FileNotFoundError(
                    f"stage-2 warm start: no stage-1 best checkpoint under {pre_dir} "
                    "(run conan_fgw_pre first, pass pre_ckpt_dir, or allow_scratch=True)")

        if config.use_lr_finder and not warm:
            from conan_fgw_tpu_torch.train.lr_finder import lr_find

            found = lr_find(model, settings, datasets["train"], device=dev)
            log.info("lr finder suggestion: %.2e", found["suggestion"])
            settings.learning_rate = found["suggestion"]

        trace = contextlib.nullcontext()
        if profile_dir:
            from conan_fgw_tpu_torch.utils.profiling import device_trace

            trace = device_trace(os.path.join(profile_dir, f"run{run_idx}"))
        with trace:
            result = loop_lib.fit(settings, train_records, datasets["valid"], model=model,
                                  device=dev, checkpointer=ckpt, resume=resume)

        # the best checkpoint on the test split (trainer.test(ckpt_path="best"))
        if ckpt.has("best"):
            ckpt.restore_params(model, "best")
        max_atoms = settings.max_atoms or loop_lib.dataset_max_atoms(
            datasets["train"] + datasets["valid"] + datasets["test"])
        # through fit's eval graphs, as the JAX runner passes its eval_scan
        test_metrics, _, _ = loop_lib.evaluate(model, datasets["test"], settings, max_atoms, dev,
                                               result.graphs)
        run_metrics = {f"test_{k}": v for k, v in test_metrics.items()}
        run_metrics["best_epoch"] = result.best_epoch
        run_metrics[settings.monitor] = result.best_metric
        if metrics_dir:
            # per-epoch metrics CSV, the Lightning CSVLogger analog; the
            # whole history is rewritten on every fit, resumed or not
            from conan_fgw_tpu_torch.utils.profiling import PhaseCSVLogger

            csv_path = os.path.join(
                metrics_dir, run_name, str(run_id), f"run_{stage}:{run_idx}", "metrics.csv")
            if os.path.exists(csv_path):
                os.remove(csv_path)
            csv_log = PhaseCSVLogger(csv_path)
            for row in result.history:
                csv_log.log(row)
        avg.register(run_metrics)
        per_run.append({"metrics": run_metrics, "history": result.history})
        log.info("run %d done: %s", run_idx, run_metrics)

    log.info("\n%s", avg.table())
    return avg.summary(), per_run


def main(argv=None):
    ap = argparse.ArgumentParser(description="conan_fgw_tpu_torch experiment runner")
    ap.add_argument("--config", required=True)
    ap.add_argument("--stage", default=STAGE_PRE, choices=[STAGE_PRE, STAGE_BC])
    ap.add_argument("--data_root", default=".")
    ap.add_argument("--number_of_runs", type=int, default=1)
    ap.add_argument("--run_name", default="run")
    ap.add_argument("--run_id", default="0")
    ap.add_argument("--models_dir", default="outputs/models")
    ap.add_argument("--logs_dir", default="outputs/logs")
    ap.add_argument("--metrics_dir", default="outputs/metrics")
    ap.add_argument("--model_name", default=None, choices=[None, "schnet", "visnet", "dimenet"])
    ap.add_argument("--out_json", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue an interrupted run from its last epoch checkpoint")
    ap.add_argument("--pre_ckpt_dir", default=None,
                    help="stage-2 warm-start checkpoint dir override (the reference's "
                    "--conan_fgw_pre_ckpt_dir): base dir holding run_conan_fgw_pre:{i} "
                    "subdirs, or one checkpoint dir used for every run")
    ap.add_argument("--allow_scratch", action="store_true",
                    help="let stage 2 train from scratch when no stage-1 checkpoint exists "
                    "(default: an error, as in the reference)")
    ap.add_argument("--eval_guard", action="store_true",
                    help="flag non-finite/outlier predictions at eval time and report "
                    "pred_outliers per run")
    ap.add_argument("--profile_dir", default=None,
                    help="write a torch.profiler trace of each run's fit into this directory")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: the card; cpu runs on the CPU)")
    ap.add_argument("--num_devices", type=int, default=1,
                    help="data-parallel device count; the port runs on one device")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-host training; not ported")
    args = ap.parse_args(argv)

    if args.num_devices > 1 or args.distributed:
        raise NotImplementedError(
            "data-parallel training (--num_devices > 1, --distributed) is not ported yet "
            "(ROADMAP.md §1, item 8)")
    overrides = {"model_name": args.model_name} if args.model_name else {}
    if args.eval_guard:
        overrides["eval_guard"] = True
    config = load_config(args.config, **overrides)
    build_logger(
        os.path.join(args.logs_dir, args.run_name, args.run_id, f"run_{args.stage}", "log.txt")
    )
    summary, _ = run_experiment(
        config,
        stage=args.stage,
        data_dir=os.path.join(args.data_root, "data"),
        number_of_runs=args.number_of_runs,
        run_name=args.run_name,
        run_id=args.run_id,
        models_dir=args.models_dir,
        resume=args.resume,
        profile_dir=args.profile_dir,
        metrics_dir=args.metrics_dir,
        pre_ckpt_dir=args.pre_ckpt_dir,
        allow_scratch=args.allow_scratch,
        device=args.device,
    )
    if args.out_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)), exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
