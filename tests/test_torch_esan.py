"""Port parity: the ESAN variants (``models/esan.py``, through the runner's
``ESANAggregation`` head) against the JAX package's on the CPU, under weights
carried by ``params_from_flax``; ``SchNet3D.embed_simple`` on its own; a
strict load of a JAX runner checkpoint; and the unused heads through the
graphed step.

Inputs are seeded synthetic molecules (numpy) packed at N=32, B=4, K=3, at
hidden 32; every SchNet keeps its 128 filters, 50 Gaussians and 6
interactions, and the GATs their width of 64, as the JAX modules build them.
The tolerances are ``test_torch_aux_heads.py``'s."""

import contextlib
import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from conan_fgw_tpu.models.schnet import SchNet3D as JSchNet
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu.train import runner as jrunner
from conan_fgw_tpu.train.checkpoints import RunCheckpointer as JCheckpointer
from conan_fgw_tpu.train.config import load_config as jload
from conan_fgw_tpu_torch.convert import params_from_flax, state_dict_from_flax_checkpoint
from conan_fgw_tpu_torch.data.loader import bucketed_batches
from conan_fgw_tpu_torch.data.synthetic import random_dataset
from conan_fgw_tpu_torch.models import esan
from conan_fgw_tpu_torch.models.schnet import SchNet3D
from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import runner as trunner
from conan_fgw_tpu_torch.train.config import load_config as tload
from test_torch_aux_heads import (
    CONFIG_LR,
    HIDDEN,
    batch_pair,
    check_forward,
    check_gradients,
    check_train_steps,
    family_pair,
    one_cpu_thread,  # noqa: F401  (the autouse fixture)
    _close,
    _norm_close,
)
from test_torch_graphs import _FakeGraph, _FakeStream, _Rehearsed

K = 3
VARIANTS = tuple(f"esan:{v}" for v in esan.VARIANTS)
ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("family", VARIANTS)
def test_forward_matches_flax(family):
    check_forward(family, K)


@pytest.mark.parametrize("family", VARIANTS)
def test_gradients_match_flax(family):
    check_gradients(family, K)


@pytest.mark.parametrize("family", VARIANTS)
def test_three_train_steps_match_optax(family):
    unused = check_train_steps(family, K)
    # every SchNet reached through __call__ carries the barycenter heads
    # (flax creates them at init); the geometry variant's siamese SchNet,
    # reached only through embed_simple, has lin1 alone
    schnets = 2 if family == "esan:avg_conf_esan" else 1
    assert len(unused) == 4 * schnets


@pytest.mark.parametrize("family", VARIANTS[:2])
def test_three_train_steps_at_the_configs_lr(family):
    """As above at the configs' lr, but for the GATs-only variant (its loss
    falls 166-fold in three steps: see ``test_torch_aux_heads.py``)."""
    check_train_steps(family, K, lr=CONFIG_LR)


def test_geometry_siamese_has_the_simple_head_alone():
    _, params, tmodel = family_pair("esan:geometry_induced_esan", K)
    siamese = params["params"]["GeometryInducedESAN_0"]["siamese"]
    assert sorted(k for k in siamese if not k.startswith("blocks_")) == ["embedding", "lin1"]
    assert not hasattr(tmodel.net.siamese, "lin2")
    assert not hasattr(tmodel.net.siamese, "lin1_bary")


def test_embed_simple_matches_flax():
    """``embed_simple``: the features, the radius graph and its Gaussian
    edge features, and the features' gradients, against the JAX function
    (XLA formulation) with a binding neighbour cap."""
    jbatch, tbatch = batch_pair(seed=3, K=K, heavy=(9, 12))
    B, _, N = tbatch.z.shape
    zj, posj = jbatch.z.reshape(B * K, N), jbatch.pos.reshape(B * K, N, 3)
    maskj = np.repeat(np.asarray(jbatch.atom_mask), K, axis=0)
    z, pos = tbatch.z.reshape(B * K, N), tbatch.pos.reshape(B * K, N, 3)
    mask = tbatch.atom_mask.repeat_interleave(K, 0)
    jmodel = JSchNet(hidden_channels=HIDDEN, num_interactions=6, max_neighbors=6)
    params = jmodel.init(jax.random.PRNGKey(0), zj, posj, maskj, method="embed_simple")
    tmodel = SchNet3D(HIDDEN, num_interactions=6, max_neighbors=6, heads="simple")
    state = params_from_flax({"backbone": jax.tree.map(np.asarray, params["params"])})
    tmodel.load_state_dict({k.removeprefix("backbone."): v for k, v in state.items()}, strict=True)

    def loss_j(p):
        h, _, _ = jmodel.apply(p, zj, posj, maskj, method="embed_simple")
        return jax.numpy.sum(jax.numpy.sin(h))

    h_j, nbr_j, rbf_j = jmodel.apply(params, zj, posj, maskj, method="embed_simple")
    h, nbr, rbf = tmodel.embed_simple(z, pos, mask)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(nbr_j))
    uncapped = radius_graph_mask(pairwise_distances(pos), mask.bool(), 10.0, None)
    assert bool((uncapped.sum(-1) > 7).any())  # the cap binds
    _close(h, h_j)
    _close(rbf, rbf_j, atol=1e-6)
    torch.sum(torch.sin(h)).backward()
    gj = params_from_flax({"backbone": jax.tree.map(np.asarray,
                                                    jax.grad(loss_j)(params)["params"])})
    for name, p in tmodel.named_parameters():
        _norm_close(p.grad.numpy(), gj[f"backbone.{name}"].numpy(), name, 1e-8)


def test_info_sharing_input_is_the_average_conformer():
    _, tbatch = batch_pair(seed=4, K=K)
    z, pos, mask = esan.shared(tbatch)
    assert torch.equal(z, tbatch.z[:, 0]) and torch.equal(mask, tbatch.atom_mask)
    torch.testing.assert_close(pos, tbatch.pos.sum(1) / K, rtol=1e-6, atol=1e-7)


def test_jax_runner_checkpoint_loads_strictly(tmp_path):
    """A JAX runner's parameter checkpoint of ``config/esan/sol250_avg_conf.yaml``
    (full width) loads into the port runner's model with ``strict=True``
    and gives the JAX model's predictions."""
    cfg = str(ROOT / "config" / "esan" / "sol250_avg_conf.yaml")
    jbatch, tbatch = batch_pair(seed=6, n_mols=2, K=2, batch_size=2)
    jmodel = jrunner.build_model(jload(cfg), jrunner.STAGE_PRE)
    state = jloop.init_state(jmodel, jloop.TrainSettings(), jbatch)
    ckpt = JCheckpointer(str(tmp_path / "run"))
    ckpt.save_best(state, 0)
    ckpt.flush()
    tmodel = trunner.build_model(tload(cfg), device="cpu")
    tmodel.load_state_dict(state_dict_from_flax_checkpoint(str(tmp_path / "run" / "best.npz")),
                           strict=True)
    assert tmodel.net.siamese.blocks[5].filter_w2.shape == (128, 128)
    with torch.no_grad():
        pred, _ = tmodel(tbatch)
    _close(pred, jmodel.apply(state.params, jbatch))


def test_unused_heads_stay_unchanged_through_the_graphed_step(monkeypatch):
    """The barycenter heads get no gradient: through ``StepGraphs``' graphed
    branch (stand-ins for CUDA graphs and streams, as
    ``test_torch_graphs.py`` rehearses it) their gradients stay None in
    ``grads``, Adam keeps no state for them and they stay bit-unchanged,
    while every other parameter moves, as in eager steps, bit for bit."""
    for name, fake in (("CUDAGraph", _FakeGraph), ("Stream", _FakeStream),
                       ("current_stream", _FakeStream),
                       ("graph", lambda g: contextlib.nullcontext()),
                       ("stream", lambda s: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, fake)
    recs = random_dataset(4, 8, num_conformers=2, heavy_range=(3, 6), device="cpu")
    batches = list(bucketed_batches(recs, 2, buckets=(32,)))
    settings = tloop.TrainSettings(batch_size=2, learning_rate=1e-3)
    runs = {}
    for mode in ("eager", "graphed"):
        model = trunner.build_aux_model("esan:avg_conf_esan", HIDDEN, seed=3, device="cpu")
        before = {k: p.detach().clone() for k, p in model.named_parameters()}
        opt = tloop.make_optimizer(model, settings)
        if mode == "eager":
            for pb in batches:
                tloop.train_step(model, opt, pb.to("cpu"), settings)
            grads = [p.grad for p in model.parameters()]
        else:
            fns = {"train": functools.partial(tloop.train_step, model, opt, settings=settings),
                   "eval": functools.partial(tloop.eval_step, model, settings=settings)}
            graphs = _Rehearsed(fns, fns["train"], fns["eval"], model.parameters(), "cpu")
            for pb in batches:
                graphs.train(pb)
            (step,) = graphs.steps.values()
            assert step.graph.replays == len(batches) - 1
            grads = graphs.grads
        names = [k for k, _ in model.named_parameters()]
        bary = {k for k in names if "_bary" in k}
        assert len(bary) == 8
        for k, p, g in zip(names, model.parameters(), grads):
            moved = not torch.equal(p.detach(), before[k])
            assert (g is None) == (k in bary) and moved == (k not in bary), k
            assert (p in opt.state) == (k not in bary), k
        runs[mode] = model
    for p, q in zip(runs["eager"].parameters(), runs["graphed"].parameters()):
        assert torch.equal(p, q)
