"""Port parity: the auxiliary head families (``models/aux_heads.py``) against
the JAX package's on the CPU, under weights carried by ``params_from_flax``,
and the covalent interaction block on its own.

Inputs are seeded synthetic molecules (numpy) packed at N=32, B=4, K=2, at
hidden 32; the SchNets keep their 128 filters, 50 Gaussians and depth (3 or
6, with 6 covalent blocks), as the JAX heads build them. The JAX side runs
its XLA path. Tolerances: predictions rtol 1e-4, atol 1e-5; each parameter's
gradient ||g_port - g_jax|| <= 1e-4 ||g_jax|| + 1e-7 ||G_jax||, ``G`` all the
gradients: the floor is float32's rounding at the gradients' scale. It holds
the parameters whose exact gradient is zero, because a softmax does not see
a constant added along its axis: the GATs' ``att_dst`` (and, with
all-positive logits, ``att_edge`` and ``lin_edge``) and the attention head's
``k.bias``; the port gives them rounding noise up to 3e-8 ||G||, XLA zeros.
Three optimiser steps of ``train_step`` against the JAX package's jitted
train step on the same batches at lr 1e-4: each loss rtol 1e-4, each weight
||w_port - w_jax|| <= 1e-4 ||w_jax|| + 1e-2 lr sqrt(its size), the second
term an RMS of 1e-2 lr (Adam's normalised step amplifies the noise of
gradient elements near zero, as ``test_torch_train.py`` says); a weight whose first
gradient is below the floor gets Adam's normalised step of noise, up to the learning
rate a step in either framework, each its own way, and is held to that:
|w_port - w_jax| <= 2 steps lr. The barycenter heads every SchNet carries get no gradient and
must stay bit-unchanged in the port (optax leaves them unchanged too).

After the steps both models predict a fresh batch (rtol 1e-4, atol 1e-5):
the weights left to noise must not reach the output.

The steps run at lr 1e-4, and again at the ESAN configs' 1e-3 for every
family but the GATs-only ESAN variant: at 1e-3 its loss, from predictions
near 1e2, falls 166-fold in three steps, so the third loss is the residual
of terms a hundred times larger, and the port and XLA, each rounding in
float32, differ there by 4e-4 in it and by 2e-3 in a GAT's attention
vector."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.data.packing import PackedBatch as JBatch
from conan_fgw_tpu.data.packing import pack_batch as jpack
from conan_fgw_tpu.data.synthetic import random_dataset as jdataset
from conan_fgw_tpu.models.schnet import InteractionBlock as JBlock
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu.train import runner as jrunner
from conan_fgw_tpu_torch.convert import params_from_flax
from conan_fgw_tpu_torch.data.packing import pack_batch as tpack
from conan_fgw_tpu_torch.data.synthetic import random_dataset as tdataset
from conan_fgw_tpu_torch.models import aux_heads
from conan_fgw_tpu_torch.models.schnet import CovalentInteractionBlock, SchNet3D
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import runner as trunner

RTOL, ATOL, FLOOR = 1e-4, 1e-5, 1e-7
HIDDEN = 32
LR = 1e-4  # of the three train steps
CONFIG_LR = 1e-3  # the ESAN configs' (config/esan/sol250_*.yaml)
FAMILIES = ("gat_only", "scalars", "embeddings", "covalent", "attention")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One CPU thread runs these shapes about as fast as many and keeps the
    file from fighting other test workers for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def batch_pair(seed=7, n_mols=4, K=2, heavy=(4, 9), batch_size=4):
    """One packed batch of ``n_mols`` seeded molecules, padded to
    ``batch_size``, for JAX and for the port."""
    pb = jpack(jdataset(seed, n_mols, num_conformers=K, heavy_range=heavy), max_atoms=32,
               batch_size=batch_size)
    jbatch = JBatch(**jax.tree.map(jnp.asarray, dataclasses.asdict(pb)))
    tbatch = tpack(tdataset(seed, n_mols, num_conformers=K, heavy_range=heavy, device="cpu"),
                   max_atoms=32, batch_size=batch_size).to("cpu")
    return jbatch, tbatch


def family_pair(family, K=2, seed=0):
    """The JAX runner's model of a head family (``ExperimentSpec.model``)
    with its parameters, and the port runner's holding the same weights
    (a strict load)."""
    jbatch, _ = batch_pair(K=K)
    jmodel = jrunner.build_aux_model(family, HIDDEN)
    params = jmodel.init(jax.random.PRNGKey(seed), jbatch, use_barycenter=True)
    tmodel = trunner.build_aux_model(family, HIDDEN, device="cpu")
    state = params_from_flax(jax.tree.map(np.asarray, params))
    assert len(state) == len(jax.tree.leaves(params))
    tmodel.load_state_dict(state, strict=True)
    return jmodel, params, tmodel


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def _norm_close(got, want, what, floor=0.0, rtol=RTOL):
    diff = np.linalg.norm(got - want)
    assert diff <= rtol * np.linalg.norm(want) + floor, f"{what}: {diff} of {np.linalg.norm(want)}"


def jax_grads(jmodel, params, jbatch):
    """``(loss, {port name: gradient}, floor)`` of the JAX model, the floor
    ``FLOOR`` times the norm of all the gradients."""
    js = jloop.TrainSettings(learning_rate=LR)
    (loss, _), grads = jax.value_and_grad(jloop.make_loss_fn(jmodel, js), has_aux=True)(
        params, jbatch)
    gj = {k: v.numpy() for k, v in params_from_flax(jax.tree.map(np.asarray, grads)).items()}
    return float(loss), gj, FLOOR * np.sqrt(sum(np.sum(g * g) for g in gj.values()))


def check_forward(family, K):
    jmodel, params, tmodel = family_pair(family, K)
    jbatch, tbatch = batch_pair(seed=5, K=K)
    with torch.no_grad():
        pred, n_div = tmodel(tbatch)
    assert pred.shape == (4, 1) and n_div.dtype == torch.int64 and n_div.tolist() == [0, 0]
    _close(pred, jmodel.apply(params, jbatch))


def check_gradients(family, K):
    jmodel, params, tmodel = family_pair(family, K, seed=1)
    jbatch, tbatch = batch_pair(seed=9, K=K)
    loss_j, gj, floor = jax_grads(jmodel, params, jbatch)
    pred, _ = tmodel(tbatch)
    loss = tloop.masked_mse(pred, tbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), loss_j, rtol=RTOL)
    for name, p in tmodel.named_parameters():
        got = np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
        _norm_close(got, gj[name], name, floor)


def check_train_steps(family, K, steps=3, lr=LR):
    """``steps`` optimiser steps of the port's ``train_step`` at ``lr``
    against the JAX package's train step on the same batches, then both
    models' predictions on a fresh batch."""
    jmodel, params, tmodel = family_pair(family, K, seed=2)
    js = jloop.TrainSettings(learning_rate=lr)
    state = jloop.TrainState.create(apply_fn=jmodel.apply, params=params,
                                    tx=jloop.make_optimizer(js))
    jstep, _ = jloop.make_step_fns(jmodel, js)
    ts = tloop.TrainSettings(learning_rate=lr)
    opt = tloop.make_optimizer(tmodel, ts)
    unused = {k: p.detach().clone() for k, p in tmodel.named_parameters() if "_bary" in k}
    _, gj, floor = jax_grads(jmodel, params, batch_pair(seed=20, K=K)[0])
    noise = {k for k, g in gj.items() if np.linalg.norm(g) <= floor and k not in unused}
    for i in range(steps):
        jbatch, tbatch = batch_pair(seed=20 + i, K=K)
        state, loss_j, _ = jstep(state, jbatch)
        loss_t, n_div = tloop.train_step(tmodel, opt, tbatch, ts)
        np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=RTOL, err_msg=f"step {i}")
        assert n_div.tolist() == [0, 0]
    new_j = {k: v.numpy() for k, v in params_from_flax(jax.tree.map(np.asarray,
                                                                     state.params)).items()}
    for name, p in tmodel.named_parameters():
        w = p.detach().numpy()
        if name in noise:
            np.testing.assert_allclose(w, new_j[name], rtol=0, atol=2 * steps * lr, err_msg=name)
        else:
            _norm_close(w, new_j[name], name, 1e-2 * lr * np.sqrt(w.size))
    for name, before in unused.items():
        p = dict(tmodel.named_parameters())[name]
        assert p.grad is None and torch.equal(p.detach(), before), name
    # the weights whose gradient is noise (their exact gradient is zero) do
    # not reach the predictions, however far they drifted
    jbatch, tbatch = batch_pair(seed=30, K=K)
    with torch.no_grad():
        pred, _ = tmodel(tbatch)
    _close(pred, jmodel.apply(state.params, jbatch))
    return unused


@pytest.mark.parametrize("family", FAMILIES)
def test_forward_matches_flax(family):
    check_forward(family, K=2)


@pytest.mark.parametrize("family", FAMILIES)
def test_gradients_match_flax(family):
    check_gradients(family, K=2)


@pytest.mark.parametrize("family", FAMILIES)
def test_three_train_steps_match_optax(family):
    unused = check_train_steps(family, K=2)
    assert bool(unused) == (family != "gat_only")


@pytest.mark.parametrize("family", FAMILIES)
def test_three_train_steps_at_the_configs_lr(family):
    check_train_steps(family, K=2, lr=CONFIG_LR)


def test_attention_spans_the_whole_batch_padding_included():
    """The attention head softmaxes over every conformer of the packed batch,
    padding molecules included: on a batch of 3 molecules padded to 4 it
    matches JAX, the padding molecule's prediction too."""
    jmodel, params, tmodel = family_pair("attention")
    jbatch, tbatch = batch_pair(seed=5, n_mols=3, batch_size=4)
    assert not bool(tbatch.mol_mask[3])
    with torch.no_grad():
        pred, _ = tmodel(tbatch)
    _close(pred, jmodel.apply(params, jbatch))
    assert torch.isfinite(pred).all()


def test_covalent_block_matches_flax():
    """One covalent block against the JAX block on the XLA path (bond
    attributes as the RBF, unit distances, the bond graph as the
    neighbours), its filter computed once per molecule for its K
    conformers; values and gradients."""
    jbatch, tbatch = batch_pair(seed=3, K=3)
    B, K, N = tbatch.z.shape
    rng = np.random.default_rng(0)
    h = rng.standard_normal((B * K, N, HIDDEN)).astype(np.float32)
    adj = np.repeat(np.asarray(jbatch.bond_adj), K, axis=0)
    attr = np.repeat(np.asarray(jbatch.bond_attr), K, axis=0)
    jblock = JBlock(HIDDEN, 128, 10.0)
    params = jblock.init(jax.random.PRNGKey(4), h, attr, np.ones(adj.shape, np.float32), adj)
    block = CovalentInteractionBlock(HIDDEN, 128, 10.0)
    state = params_from_flax({"backbone": {"blocks_cov_0": jax.tree.map(np.asarray,
                                                                         params["params"])}})
    block.load_state_dict({k.removeprefix("backbone.blocks_cov.0."): v for k, v in state.items()},
                          strict=True)
    ones = np.ones(adj.shape, np.float32)

    def loss_j(p, x):
        return jnp.sum(jnp.sin(jblock.apply(p, x, attr, ones, adj)))

    out_j = jblock.apply(params, h, attr, ones, adj)
    gp, gx = jax.grad(loss_j, argnums=(0, 1))(params, h)
    x = torch.from_numpy(h).requires_grad_(True)
    out = block(x, tbatch.bond_adj, tbatch.bond_attr)
    _close(out, out_j)
    torch.sin(out).sum().backward()
    _norm_close(x.grad.numpy(), np.asarray(gx), "h")
    gj = params_from_flax({"backbone": {"blocks_cov_0": jax.tree.map(np.asarray, gp["params"])}})
    for name, p in block.named_parameters():
        _norm_close(p.grad.numpy(), gj[f"backbone.blocks_cov.0.{name}"].numpy(), name)


def test_covalent_trunk_needs_the_bond_graph():
    model = SchNet3D(32, num_interactions=1, use_covalent=True)
    _, tbatch = batch_pair()
    z, pos = tbatch.z.reshape(8, 32), tbatch.pos.reshape(8, 32, 3)
    with pytest.raises(ValueError, match="bond_adj"):
        model(z, pos, tbatch.atom_mask.repeat_interleave(2, 0))


def test_unknown_families_raise():
    with pytest.raises(ValueError, match="unknown experiment model family"):
        trunner.build_aux_model("nope", 32, device="cpu")
    with pytest.raises(ValueError, match="unknown ESAN variant"):
        trunner.build_aux_model("esan:nope", 32, device="cpu")
    assert isinstance(trunner.build_aux_model("gat_only", 32, device="cpu"),
                      aux_heads.EmbeddingsWithGAT)
