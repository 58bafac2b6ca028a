"""Port parity: SchNet's ``neighbor_cap_mode`` and ``remat`` options against
the JAX package, on the CPU, at a small size (hidden 32, 2 interactions,
N=32, B=4, K=2).

The JAX ``ConanModel`` builds its SchNet with both options at their
defaults, so the JAX side here is ``ConanModel`` over a ``SchNet3D``
subclass that changes the one default (the parameter tree is the same).
The nearest cap is held where it binds (at most 8 neighbours; the test
checks that rows reach the cap and that the two rules keep other sets).

Tolerances, as ``tests/test_torch_model.py`` and
``tests/test_torch_train.py`` hold the default SchNet: the neighbour mask
equal; the trunk's heads rtol 1e-4 (atol 1e-5); a training step's loss
rtol 1e-4 and each gradient leaf within 1e-4 of its norm, in stage 1 and
in stage 2. ``remat=True`` against ``remat=False`` in the port: bit for
bit, outputs and gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.models import heads as jheads
from conan_fgw_tpu.models.schnet import SchNet3D as JSchNet3D
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu_torch.convert import params_from_flax
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.train import loop as tloop
from test_torch_model import SMALL, make_pair

RTOL, ATOL = 1e-4, 1e-5
CAP = 8


class _NearestSchNet(JSchNet3D):
    neighbor_cap_mode: str = "nearest"


class _RematSchNet(JSchNet3D):
    remat: bool = True


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _port(params, **options):
    model = ConanModel(device="cpu", max_neighbors=CAP, **SMALL, **options)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    return model


def _jax_step(jmodel, params, jbatch, bary):
    js = jloop.TrainSettings(use_barycenter=bary)
    (loss, _), grads = jax.value_and_grad(jloop.make_loss_fn(jmodel, js), has_aux=True)(
        params, jbatch)
    return float(loss), params_from_flax(jax.tree.map(np.asarray, grads))


def _port_step(model, tbatch, bary):
    model.zero_grad(set_to_none=True)
    pred, _ = model(tbatch, use_barycenter=bary)
    loss = tloop.masked_mse(pred, tbatch)
    loss.backward()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
             for k, p in model.named_parameters()}
    return pred.detach(), loss.detach(), grads


def _assert_step_close(loss_t, grads_t, loss_j, grads_j):
    np.testing.assert_allclose(float(loss_t), loss_j, rtol=RTOL)
    for name, g in grads_t.items():
        want = grads_j[name].numpy()
        assert np.linalg.norm(g.numpy() - want) <= RTOL * np.linalg.norm(want) + 1e-9, name


def test_nearest_neighbor_graph_and_trunk_match_flax(monkeypatch):
    monkeypatch.setattr(jheads, "SchNet3D", _NearestSchNet)
    jmodel, params, jbatch, _, tbatch = make_pair(max_neighbors=CAP)
    tmodel = _port(params, neighbor_cap_mode="nearest")
    B, K, N = jbatch.z.shape
    z, pos = jbatch.z.reshape(B * K, N), jbatch.pos.reshape(B * K, N, 3)
    mask = jnp.repeat(jbatch.atom_mask, K, axis=0)
    h3_j, hb_j, nbr_j = jmodel.apply(params, z, pos, mask,
                                     method=lambda m, *a: m.backbone.embed_dual(*a))
    with torch.no_grad():
        h3_t, hb_t, nbr_t = tmodel.backbone.embed_dual(
            tbatch.z.reshape(B * K, N), tbatch.pos.reshape(B * K, N, 3),
            tbatch.atom_mask.repeat_interleave(K, dim=0))
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))
    # the cap binds, and the nearest rule keeps another set than the index rule
    assert int(nbr_t.sum(-1).max()) == CAP
    index = ConanModel(device="cpu", max_neighbors=CAP, **SMALL).backbone
    assert not torch.equal(index.neighbor_graph(tbatch.pos.reshape(B * K, N, 3),
                                                tbatch.atom_mask.repeat_interleave(K, dim=0))[1],
                           nbr_t)
    np.testing.assert_allclose(h3_t.numpy(), np.asarray(h3_j), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hb_t.numpy(), np.asarray(hb_j), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stage", [1, 2])
def test_nearest_train_step_matches_flax(stage, monkeypatch):
    monkeypatch.setattr(jheads, "SchNet3D", _NearestSchNet)
    jmodel, params, jbatch, _, tbatch = make_pair(max_neighbors=CAP, batch_seed=11)
    bary = stage == 2
    loss_j, grads_j = _jax_step(jmodel, params, jbatch, bary)
    _, loss_t, grads_t = _port_step(_port(params, neighbor_cap_mode="nearest"), tbatch, bary)
    _assert_step_close(loss_t, grads_t, loss_j, grads_j)


@pytest.mark.parametrize("cap_mode", ["index", "nearest"])
def test_remat_is_bit_identical_to_no_remat(cap_mode):
    """The recomputed blocks give the same outputs and gradients bit for
    bit (stage 2, both cap rules); without gradients nothing is recomputed."""
    _, params, _, _, tbatch = make_pair(max_neighbors=CAP, batch_seed=5)
    plain = _port(params, neighbor_cap_mode=cap_mode)
    remat = _port(params, neighbor_cap_mode=cap_mode, remat=True)
    pred_p, loss_p, grads_p = _port_step(plain, tbatch, True)
    pred_r, loss_r, grads_r = _port_step(remat, tbatch, True)
    assert torch.equal(pred_p, pred_r) and torch.equal(loss_p, loss_r)
    for name, g in grads_p.items():
        assert torch.equal(g, grads_r[name]), name
    with torch.no_grad():
        assert torch.equal(remat(tbatch, use_barycenter=True)[0], pred_p)


def test_remat_blocks_are_recomputed_in_the_backward(monkeypatch):
    """Each interaction block runs twice a train step under remat: once in
    the forward, once in the backward."""
    from conan_fgw_tpu_torch.models import schnet

    calls = []
    cfconv = schnet.cfconv
    monkeypatch.setattr(schnet, "cfconv", lambda *a, **k: calls.append(1) or cfconv(*a, **k))
    _, params, _, _, tbatch = make_pair(max_neighbors=CAP)
    for remat in (False, True):
        calls.clear()
        _port_step(_port(params, remat=remat), tbatch, True)
        assert len(calls) == (1 + remat) * SMALL["num_interactions"], remat


@pytest.mark.parametrize("stage", [1, 2])
def test_remat_train_step_matches_flax_remat(stage, monkeypatch):
    monkeypatch.setattr(jheads, "SchNet3D", _RematSchNet)
    jmodel, params, jbatch, _, tbatch = make_pair(max_neighbors=CAP, batch_seed=11)
    bary = stage == 2
    loss_j, grads_j = _jax_step(jmodel, params, jbatch, bary)
    _, loss_t, grads_t = _port_step(_port(params, remat=True), tbatch, bary)
    _assert_step_close(loss_t, grads_t, loss_j, grads_j)
