"""The rank side of ``tests/test_torch_parallel.py``: functions that
``parallel/mesh.py::launch`` runs in each spawned rank. They live apart
from the test file so that a rank imports neither JAX nor the JAX package,
which would cost each rank seconds."""

import torch

from conan_fgw_tpu_torch.data.packing import pack_batch
from conan_fgw_tpu_torch.data.synthetic import random_dataset
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.parallel import collectives
from conan_fgw_tpu_torch.parallel import mesh as mesh_lib
from conan_fgw_tpu_torch.train import checkpoints
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import runner as trunner
from conan_fgw_tpu_torch.train.lr_finder import lr_find
from conan_fgw_tpu_torch.train.predict import predict_records
from conan_fgw_tpu_torch.utils import profiling

LR = 5e-4
# tests/test_torch_model.py's SMALL
SMALL = dict(hidden_channels=32, num_filters=32, num_gaussians=10, num_interactions=2)
# the stage, and the real molecules of the global batch of 4
CASES = {"stage 1": (False, 4), "stage 2": (True, 4), "stage 2, 3 real rows": (True, 3)}
STEPS = 3


def global_batch(n_real: int):
    return pack_batch(random_dataset(7, n_real, num_conformers=2, heavy_range=(4, 9),
                                     device="cpu"), max_atoms=32, batch_size=4)


def eval_records():
    return random_dataset(5, 9, num_conformers=2, heavy_range=(3, 25), device="cpu")


def rank_worker(mesh, state):
    """Each case's steps on this rank's block of the global batch: the
    all-reduced buffer of the first step and the weights after each step;
    then ``evaluate`` with and without ``StepGraphs``, ``predict_records``,
    the lr finder and the small collectives."""
    out = {}
    for name, (bary, n_real) in CASES.items():
        model = ConanModel(device="cpu", **SMALL)
        model.load_state_dict(state)
        settings = tloop.TrainSettings(use_barycenter=bary, learning_rate=LR, batch_size=4)
        split = tloop.SplitStep(model, tloop.make_optimizer(model, settings), settings, mesh)
        pb = mesh_lib.shard_batch(global_batch(n_real), mesh).to("cpu")
        rows = torch.tensor(float(n_real))
        flat, weights = None, []
        for _ in range(STEPS):
            split.before(pb, rows)
            split.reduce()
            flat = split.flat.numpy().copy() if flat is None else flat
            split.after()
            weights.append({k: v.numpy().copy() for k, v in model.state_dict().items()})
        out[name] = (flat, weights)
    settings = tloop.TrainSettings(use_barycenter=True, batch_size=4)
    model = ConanModel(device="cpu", seed=2, **SMALL)
    graphs = tloop.step_graphs(model, tloop.make_optimizer(model, settings), settings, "cpu",
                               mesh)
    for label, g in (("evaluate", None), ("evaluate graphs", graphs)):
        out[label] = tloop.evaluate(model, eval_records(), settings, 64, "cpu", g, mesh=mesh)
    ordered, pred, y = predict_records(model, eval_records(), settings, 64, "cpu", mesh)
    out["predict"] = ([r.y for r in ordered], pred, y)
    out["lr_find"] = lr_find(model, settings, eval_records(), num_steps=4, mesh=mesh)
    out["mean"] = collectives.all_hosts_mean(float(mesh.rank), mesh)
    out["broadcast"] = collectives.broadcast_object({"from": mesh.rank}, mesh)
    if mesh.rank == 1:
        with torch.no_grad():
            next(model.parameters()).add_(1.0)
    try:
        collectives.check_replicas(model, mesh)
        out["replicas"] = "equal"
    except RuntimeError as e:
        out["replicas"] = str(e)
    return out


def spied_rank(mesh, args):
    """``runner._rank_main`` with the files each rank writes recorded."""
    written = []

    def spy(fn, what):
        def call(*a, **kw):
            written.append(what(*a))
            return fn(*a, **kw)
        return call

    checkpoints._write_npz = spy(checkpoints._write_npz, lambda path, arrays: path)
    profiling.PhaseCSVLogger.log = spy(profiling.PhaseCSVLogger.log, lambda self, row: "csv")
    return trunner._rank_main(mesh, args), written


def failing_rank(mesh):
    """Rank 1 raises while rank 0 waits for it in a collective."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    collectives.all_reduce_(torch.ones(3), mesh)
