"""Port parity: one training step against the JAX/optax step, and the epoch
loop on the CPU.

Tolerances: loss and gradients rtol 1e-4 (each gradient leaf is held in
norm: ||g_port - g_jax|| <= 1e-4 ||g_jax||); updated parameters atol
1e-2 * lr, since Adam's first step normalises each element and so amplifies
noise where |g| is near 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu.train import metrics as jmetrics
from conan_fgw_tpu_torch.convert import params_from_flax
from conan_fgw_tpu_torch.data.synthetic import random_dataset
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import metrics as tmetrics
from test_torch_model import SMALL, make_pair

RTOL = 1e-4
LR = 5e-4


@pytest.mark.parametrize("stage", [1, 2])
def test_train_step_matches_optax(stage):
    jmodel, params, jbatch, tmodel, tbatch = make_pair(batch_seed=11)
    bary = stage == 2
    js = jloop.TrainSettings(use_barycenter=bary, learning_rate=LR)
    (loss_j, _), grads_j = jax.value_and_grad(jloop.make_loss_fn(jmodel, js), has_aux=True)(
        params, jbatch
    )
    state = jloop.TrainState.create(apply_fn=jmodel.apply, params=params,
                                    tx=jloop.make_optimizer(js))
    train_step, _ = jloop.make_step_fns(jmodel, js)
    state, _, _ = train_step(state, jbatch)

    ts = tloop.TrainSettings(use_barycenter=bary, learning_rate=LR)
    opt = tloop.make_optimizer(tmodel, ts)
    opt.zero_grad()
    pred, _ = tmodel(tbatch, use_barycenter=bary)
    loss_t = tloop.masked_mse(pred, tbatch)
    loss_t.backward()
    # stage 1 leaves the barycenter head without a gradient; optax sees zeros
    grads_t = {k: torch.zeros_like(p) if p.grad is None else p.grad.clone()
               for k, p in tmodel.named_parameters()}
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=RTOL)
    gj = params_from_flax(jax.tree.map(np.asarray, grads_j))
    for name, g in grads_t.items():
        diff = np.linalg.norm(g.numpy() - gj[name].numpy())
        assert diff <= RTOL * np.linalg.norm(gj[name].numpy()) + 1e-9, name

    tloop.clip_by_global_norm_(list(tmodel.parameters()), ts.grad_clip)
    opt.step()
    new_j = params_from_flax(jax.tree.map(np.asarray, state.params))
    for name, p in tmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), new_j[name].numpy(), atol=1e-2 * LR, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("scale", [0.3, 30.0])
def test_clip_matches_optax(scale):
    rng = np.random.default_rng(int(scale))
    gs = [rng.standard_normal(s).astype(np.float32) * scale for s in ((3, 4), (5,))]
    clipped, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(g) for g in gs], None)
    ps = [torch.nn.Parameter(torch.zeros(g.shape)) for g in gs]
    for p, g in zip(ps, gs):
        p.grad = torch.from_numpy(g.copy())
    tloop.clip_by_global_norm_(ps, 1.0)
    for p, c in zip(ps, clipped):
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(c), rtol=1e-6)


def test_schedules_match_jax_copy():
    vals = [1.0, 0.9, 0.95, 0.95, 0.95, 0.8, 0.8, 0.8, 0.8, float("nan")]
    jp, tp = jmetrics.ReduceLROnPlateau(1.0, 0.5, 2), tmetrics.ReduceLROnPlateau(1.0, 0.5, 2)
    je, te = jmetrics.EarlyStopping(3, 1e-4), tmetrics.EarlyStopping(3, 1e-4)
    for v in vals:
        assert jp.step(v) == tp.step(v)
        assert je.step(v) == te.step(v)
    a, b = np.arange(5.0), np.arange(5.0)[::-1]
    assert tmetrics.rmse(a, b) == jmetrics.rmse(a, b)


def test_fit_runs_two_steps_on_cpu():
    recs = random_dataset(3, 8, num_conformers=2, heavy_range=(4, 7), device="cpu")
    model = ConanModel(device="cpu", **SMALL)
    s1 = tloop.TrainSettings(num_epochs=1, batch_size=4)
    r1 = tloop.fit(s1, recs, recs[:4], model=model, device="cpu")
    s2 = tloop.TrainSettings(num_epochs=1, batch_size=4, use_barycenter=True)
    r2 = tloop.fit(s2, recs, recs[:4], model=r1.model, device="cpu")
    assert r1.history[0]["train_steps"] == 2 and r2.history[0]["train_steps"] == 2
    for r in (r1, r2):
        assert np.isfinite(r.history[0]["train_loss"]) and np.isfinite(r.history[0]["val_loss"])
    assert r2.model is model


def test_fit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        tloop.fit(tloop.TrainSettings(num_epochs=1), [], [])
