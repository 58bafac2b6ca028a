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
backbones, for regression and classification, and the head families of
``experiment:`` other than ``conan`` (the ESAN variants and the aux heads,
``build_aux_model``), on the conformer and the GEOM datasets; what else a
config can ask for raises naming its ``ROADMAP.md`` item.

Data parallelism (``parallel/``): ``--num_devices N`` spawns N ranks, one
per card (``0``, the default, is every visible card; with ``--device cpu``
N CPU ranks over gloo), of which rank 0 alone writes checkpoints, logs,
metrics and ``--out_json``; ``--distributed`` joins the process group that
torchrun's environment describes, one rank per process, each writing where
its own arguments say::

    python -m conan_fgw_tpu_torch.train.runner --config ... --num_devices 4
    torchrun --nproc_per_node 4 -m conan_fgw_tpu_torch.train.runner --config ... --distributed
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
from typing import Callable, Sequence

import torch
import torch.distributed as dist

from conan_fgw_tpu_torch.data.datasets import ConformerDataset, class_weight_ratio
from conan_fgw_tpu_torch.data.geom import GEOMDataset
from conan_fgw_tpu_torch.device import compute_dtype, resolve_device
from conan_fgw_tpu_torch.models import aux_heads
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.ops.fgw.barycenter import FGWConfig
from conan_fgw_tpu_torch.parallel import mesh as mesh_lib
from conan_fgw_tpu_torch.train import loop as loop_lib
from conan_fgw_tpu_torch.train.checkpoints import RunCheckpointer, find_pre_stage_dir
from conan_fgw_tpu_torch.train.config import ExperimentConfig, load_config
from conan_fgw_tpu_torch.utils.runlog import AverageRuns, build_logger

log = logging.getLogger("conan_fgw_tpu_torch")

STAGE_PRE = "conan_fgw_pre"
STAGE_BC = "conan_fgw"


def check_supported(config: ExperimentConfig, device: torch.device) -> None:
    """Raise for what a config asks and the port does not carry."""
    if config.model_name not in ("schnet", "visnet", "dimenet"):
        raise ValueError(f"unknown model_name {config.model_name!r}")
    compute_dtype(config.compute_dtype)  # float32 or bfloat16, else it raises
    if device.type == "cuda":
        for key in ("use_pallas_cfconv", "use_pallas_fgw"):
            if getattr(config, key) is False:
                raise ValueError(
                    f"{key}: false asks for a plain PyTorch version, which the port runs "
                    "on the CPU only; on the card the kernels run")


def build_aux_model(spec_model: str, hidden: int, *, seed: int = 0, device="cuda"):
    """A head family other than ``conan`` (``ExperimentSpec.model``): the
    reference's GAT-only and baseline heads and the ESAN variants
    (``esan:<variant>``), as the JAX runner builds them."""
    if spec_model.startswith("esan:"):
        return aux_heads.ESANAggregation(spec_model.split(":", 1)[1], hidden, seed=seed,
                                         device=device)
    try:
        head = aux_heads.HEADS[spec_model]
    except KeyError:
        raise ValueError(f"unknown experiment model family {spec_model!r}; known: conan,"
                         f" esan:<variant>, {sorted(aux_heads.HEADS)}") from None
    return head(hidden, seed=seed, device=device)


def fgw_config(config: ExperimentConfig) -> FGWConfig:
    """The barycenter's solver budget from a config (before a backbone's
    own alpha and structure)."""
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
    return fgw


def build_model(config: ExperimentConfig, *, seed: int = 0, device="cuda"):
    """A head family other than ``conan`` comes from ``build_aux_model``.
    Otherwise the config's backbone at hidden 128 for regression, 512 for
    classification, a cap of 32 neighbours, and the FGW solver. SchNet: 3
    interactions, cutoff 10, and 128 filters with 50 Gaussians for
    regression, 256 with 10 for classification. ViSNet: cutoff 5, the
    barycenter branch shifted by 1.0 and its columns L2-normalised. DimeNet:
    cutoff 5, the barycenter solved with alpha 0.5 and a fixed structure
    (as the JAX runner wires them, after the reference's wrappers)."""
    dev = resolve_device(device)
    check_supported(config, dev)
    task = config.spec.task
    hidden = 512 if task == "classification" else 128
    if config.spec.model != "conan":
        return build_aux_model(config.spec.model, hidden, seed=seed, device=dev)
    fgw = fgw_config(config)
    # compute_dtype reaches the SchNet and DimeNet backbones (ConanModel), not
    # ViSNet or the aux heads, as in the JAX runner
    common = dict(task=task, hidden_channels=hidden,
                  agg_weight=config.agg_weight, bary_pad_mode=config.bary_pad_mode, seed=seed,
                  device=dev, compute_dtype=config.compute_dtype)
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


def load_datasets(config: ExperimentConfig, data_dir: str) -> dict:
    """The train, valid and test datasets: ``GEOMDataset`` for ``dataset:
    geom``, else ``ConformerDataset``."""
    name, target = config.dataset_name[0], config.target[0]
    if config.spec.dataset == "geom":
        return {mode: GEOMDataset(mode, data_dir, name, target, config.num_conformers)
                for mode in ("train", "valid", "test")}
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
    datasets: dict | None = None,
    records_provider: Callable[[str], Sequence] | None = None,
    resume: bool = False,
    profile_dir: str | None = None,
    metrics_dir: str | None = None,
    pre_ckpt_dir: str | None = None,
    allow_scratch: bool = False,
    device="cuda",
    mesh=None,
    writes: bool = True,
):
    """Train and evaluate ``number_of_runs`` times; returns ``(summary,
    per_run)``, the second a list of ``{"metrics", "history"}``.

    With a ``mesh`` this is one rank's run on the mesh's device: the batch
    size is padded up to a multiple of the ranks (the extra rows are
    ``mol_mask``-padded), and every rank trains on its row block of the
    same global batches. Without ``writes`` the run writes no checkpoint,
    metrics file or trace (the ranks of ``--num_devices`` other than 0).

    The records come from ``datasets`` (``{"train", "valid", "test"}`` to
    record lists, e.g. ``data/synthetic.py``'s), else from
    ``records_provider(split)``, else from the datasets under ``data_dir``;
    only the last re-draws the train split's K-subsets every epoch."""
    dev = resolve_device(device if mesh is None else mesh.device)
    check_supported(config, dev)
    if mesh is not None and config.batch_size % mesh.world:
        padded = -(-config.batch_size // mesh.world) * mesh.world
        log.info("batch_size %d not divisible by %d ranks; padding to %d (extra rows are "
                 "mol_mask-padded)", config.batch_size, mesh.world, padded)
        config = dataclasses.replace(config, batch_size=padded)
    if datasets is None and records_provider is not None:
        datasets = {m: records_provider(m) for m in ("train", "valid", "test")}
    if datasets is not None:
        train_records = datasets["train"]
    else:
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
            monitor=settings.monitor, writes=writes,
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

            found = lr_find(model, settings, datasets["train"], device=dev, mesh=mesh)
            log.info("lr finder suggestion: %.2e", found["suggestion"])
            settings.learning_rate = found["suggestion"]

        trace = contextlib.nullcontext()
        if profile_dir and writes:
            from conan_fgw_tpu_torch.utils.profiling import device_trace

            trace = device_trace(os.path.join(profile_dir, f"run{run_idx}"))
        with trace:
            result = loop_lib.fit(settings, train_records, datasets["valid"], model=model,
                                  device=dev, checkpointer=ckpt, resume=resume, mesh=mesh)

        if mesh is not None:
            # the writing rank's last checkpoint files are in place
            dist.barrier(group=mesh.host_group)
        # the best checkpoint on the test split (trainer.test(ckpt_path="best"))
        if ckpt.has("best"):
            ckpt.restore_params(model, "best")
        max_atoms = settings.max_atoms or loop_lib.dataset_max_atoms(
            datasets["train"] + datasets["valid"] + datasets["test"])
        # through fit's eval graphs, as the JAX runner passes its eval_scan
        test_metrics, _, _ = loop_lib.evaluate(model, datasets["test"], settings, max_atoms, dev,
                                               result.graphs, mesh=mesh)
        run_metrics = {f"test_{k}": v for k, v in test_metrics.items()}
        run_metrics["best_epoch"] = result.best_epoch
        run_metrics[settings.monitor] = result.best_metric
        if metrics_dir and writes:
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


def parse_args(argv=None) -> argparse.Namespace:
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
    ap.add_argument("--num_devices", type=int, default=0,
                    help="data-parallel ranks: 0 = every visible card (one on the CPU), 1 = one"
                    " device, N = N ranks spawned by this command; with --device cpu, N CPU"
                    " ranks over gloo")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group of torchrun's environment (RANK, WORLD_SIZE,"
                    " LOCAL_RANK, MASTER_ADDR, MASTER_PORT): one rank per process")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if args.distributed:
        joined = dist.is_initialized()
        mesh_lib.initialize_distributed(backend)
        try:
            world = dist.get_world_size() if dist.is_initialized() else 1
            if args.num_devices not in (0, world):
                raise ValueError(f"--num_devices {args.num_devices} with --distributed over"
                                 f" {world} processes")
            mesh = mesh_lib.create_mesh(world, args.device) if world > 1 else None
            summary = run_main(args, mesh, writes=True)
        finally:
            if not joined and dist.is_initialized():
                dist.destroy_process_group()
    else:
        n = num_ranks(args.num_devices, dev)
        if n > 1:
            summary = mesh_lib.launch(_rank_main, n, args, backend=backend,
                                      device=args.device)[0]
        else:
            summary = run_main(args, None, writes=True)
    print(json.dumps(summary, indent=2))
    return summary


def num_ranks(num_devices: int, device: torch.device) -> int:
    """The ranks of ``--num_devices``: 0 is every visible card (one on the
    CPU); more than the cards visible raises."""
    if device.type != "cuda":
        return num_devices or 1
    visible = torch.cuda.device_count()
    if num_devices > visible:
        raise ValueError(f"--num_devices {num_devices}: only {visible} CUDA device(s) are visible")
    return num_devices or visible


def _rank_main(mesh, args) -> dict:
    """One rank of ``--num_devices N`` (``mesh_lib.launch``): rank 0 alone
    writes."""
    return run_main(args, mesh, writes=mesh.rank == 0)


def run_main(args, mesh, writes: bool) -> dict:
    """``main``'s run of the parsed ``args`` on ``mesh`` (None: one
    process); returns the summary, written to ``--out_json`` if ``writes``."""
    overrides = {"model_name": args.model_name} if args.model_name else {}
    if args.eval_guard:
        overrides["eval_guard"] = True
    config = load_config(args.config, **overrides)
    log_path = os.path.join(args.logs_dir, args.run_name, args.run_id, f"run_{args.stage}",
                            "log.txt")
    build_logger(log_path if writes else None, logging.INFO if writes else logging.WARNING)
    if mesh is not None:
        log.info("data-parallel mesh: rank %d of %d on %s (%s)", mesh.rank, mesh.world,
                 mesh.device, mesh.backend)
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
        mesh=mesh,
        writes=writes,
    )
    if args.out_json and writes:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)), exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
