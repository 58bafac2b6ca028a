"""Port parity: the ViSNet backbone and ``ConanModel(backbone_name="visnet")``
against the JAX package on the CPU, under weights copied by
``params_from_flax``, at a small size (hidden 32, 4 heads, 2 layers, 8 RBFs
for the backbone; N=32, B=4, K=2).

Tolerances: backbone outputs rtol 1e-4, atol 1e-5; the model's stage 1 rtol
1e-4 and stage 2 rtol 1e-3 (the barycenter's bound), as
``tests/test_torch_model.py``; stage-2 gradients 1e-3 of each leaf's norm;
the neighbour masks exactly. Neither backbone has a Pallas path: the JAX
side is its XLA module."""

import dataclasses
import logging
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.data.packing import PackedBatch as JBatch
from conan_fgw_tpu.data.packing import pack_batch as jpack
from conan_fgw_tpu.data.synthetic import random_dataset as jdataset
from conan_fgw_tpu.models import visnet as jvisnet
from conan_fgw_tpu.models.heads import ConanModel as JConan
from conan_fgw_tpu.ops.graph import pairwise_distances as jdist
from conan_fgw_tpu.ops.graph import radius_graph_mask as jradius
from conan_fgw_tpu.ops.rbf import expnorm_initial_params as j_expnorm_params
from conan_fgw_tpu.ops.rbf import expnorm_smearing as j_expnorm
from conan_fgw_tpu.train import config as jconfig
from conan_fgw_tpu.train.checkpoints import _save_pytree
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu.train import runner as jrunner
from conan_fgw_tpu_torch.convert import params_from_flax, state_dict_from_flax_checkpoint
from conan_fgw_tpu_torch.data.packing import pack_batch as tpack
from conan_fgw_tpu_torch.data.synthetic import random_dataset as tdataset
from conan_fgw_tpu_torch.models import visnet as tvisnet
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.ops.graph import pairwise_distances as tdist
from conan_fgw_tpu_torch.ops.graph import radius_graph_mask as tradius
from conan_fgw_tpu_torch.ops.rbf import expnorm_initial_params, expnorm_smearing
from conan_fgw_tpu_torch.train import config as tconfig
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import predict as tpredict
from conan_fgw_tpu_torch.train import runner as trunner
from conan_fgw_tpu_torch.train.graphs import StepGraphs
from test_torch_runner import _cli, tiny_dataset, write_config

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(hidden_channels=32, num_heads=4, num_layers=2, num_rbf=8)
RTOL, ATOL = 1e-4, 1e-5
STAGE2_RTOL = 1e-3
MODEL = dict(backbone_name="visnet", hidden_channels=32, cutoff=5.0, bary_shift=1.0,
             bary_postnorm="l2col")
CONFIGS = ("sol250_5", "sol250_5_bc", "sol250_5_bc_agg0", "sol250_5_bc_lowlr", "solflex_5",
           "solflex_5_bc_agg0", "solflex_5_bc_agg1")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One CPU thread runs these shapes about as fast as many and keeps the
    file from fighting other test workers for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def flat_inputs(seed=7, heavy=(4, 9), n_mols=4, max_atoms=32):
    """One batch's conformers as ``(z, pos, mask)`` flattened to ``B*K``
    graphs, for JAX and for the port."""
    pb = jpack(jdataset(seed, n_mols, num_conformers=2, heavy_range=heavy), max_atoms=max_atoms,
               batch_size=n_mols)
    B, K, N = pb.z.shape
    j = (jnp.asarray(pb.z.reshape(B * K, N)), jnp.asarray(pb.pos.reshape(B * K, N, 3)),
         jnp.asarray(np.repeat(pb.atom_mask, K, axis=0)))
    t = tuple(torch.from_numpy(np.array(a)) for a in j)
    return j, t


def backbone_pair(**options):
    """A flax ``ViSNet3D`` with its parameters and the port's holding the
    same weights."""
    (z, pos, mask), _ = flat_inputs()
    jmodel = jvisnet.ViSNet3D(**SMALL, **options)
    params = jmodel.init(jax.random.PRNGKey(0), z, pos, mask)
    tmodel = tvisnet.ViSNet3D(**SMALL, **options)
    state = params_from_flax({"backbone": jax.tree.map(np.asarray, params["params"])})
    tmodel.load_state_dict({k.removeprefix("backbone."): v for k, v in state.items()})
    return jmodel, params, tmodel


def grads_of(model) -> dict:
    """Each parameter's gradient as numpy, zeros where it has none (the
    last gated block's vector projection feeds nothing; JAX gives zeros)."""
    return {k: np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
            for k, p in model.named_parameters()}


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=rtol, atol=atol)


def test_expnorm_smearing_matches():
    means_j, betas_j = j_expnorm_params(32, 5.0)
    means, betas = expnorm_initial_params(32, 5.0)
    _close(means, means_j, rtol=1e-6, atol=0)
    _close(betas, betas_j, rtol=1e-6, atol=0)
    d = np.linspace(0.0, 6.0, 50, dtype=np.float32)
    _close(expnorm_smearing(torch.from_numpy(d), means, betas, 5.0),
           j_expnorm(jnp.asarray(d), means_j, betas_j, 5.0), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cap", [32, 6])
def test_self_loop_mask_matches_and_differs_from_the_radius_graph(cap):
    """The structure matrix is ViSNet's own self-loop mask without its
    diagonal, whose cap counts self: with a binding cap it is not SchNet's
    radius graph, which keeps ``cap + 1`` candidates and then drops self."""
    (_, pos_j, mask_j), (_, pos, mask) = flat_inputs(seed=3, heavy=(9, 12))
    want = jvisnet._self_loop_graph_mask(jdist(pos_j), mask_j, 5.0, cap)
    got = tvisnet._self_loop_graph_mask(tdist(pos), mask, 5.0, cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    nbr = got & ~torch.eye(got.shape[-1], dtype=torch.bool)
    radius = tradius(tdist(pos), mask, 5.0, cap)
    np.testing.assert_array_equal(radius.numpy(),
                                  np.asarray(jradius(jdist(pos_j), mask_j, 5.0, cap)))
    if cap == 6:
        within = tradius(tdist(pos), mask, 5.0, None).sum(-1)
        assert bool((within > cap).any()), "the inputs never engage the cap"
        assert not torch.equal(nbr, radius)


@pytest.mark.parametrize("options", [{}, {"max_neighbors": 6}], ids=["default", "cap6"])
def test_backbone_matches_flax(options):
    jmodel, params, tmodel = backbone_pair(**options)
    (z_j, pos_j, mask_j), (z, pos, mask) = flat_inputs(seed=5)
    h3_j, hb_j, nbr_j = jmodel.apply(params, z_j, pos_j, mask_j, method="embed_dual")
    x_j, vec_j, _ = jmodel.apply(params, z_j, pos_j, mask_j, method="trunk")
    with torch.no_grad():
        h3, hb, nbr = tmodel.embed_dual(z, pos, mask)
        x, vec, _ = tmodel.trunk(z, pos, mask)
        out = tmodel(z, pos, mask)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(nbr_j))
    _close(x, x_j)
    _close(vec, vec_j)
    _close(h3, h3_j)
    _close(hb, hb_j)
    _close(out, jmodel.apply(params, z_j, pos_j, mask_j))


def test_backbone_gradient_matches_flax():
    """The backbone's parameter gradients (each block recomputed in the
    backward) against JAX's, with a binding neighbour cap."""
    jmodel, params, tmodel = backbone_pair(max_neighbors=6)
    (z_j, pos_j, mask_j), (z, pos, mask) = flat_inputs(seed=9)

    def loss_j(p):
        h3, hb, _ = jmodel.apply(p, z_j, pos_j, mask_j, method="embed_dual")
        return jnp.sum(h3 ** 2) + jnp.sum(jnp.sin(hb))

    grads_j = params_from_flax(
        {"backbone": jax.tree.map(np.asarray, jax.grad(loss_j)(params)["params"])})
    h3, hb, _ = tmodel.embed_dual(z, pos, mask)
    (torch.sum(h3 ** 2) + torch.sum(torch.sin(hb))).backward()
    for name, g in grads_of(tmodel).items():
        want = grads_j[f"backbone.{name}"].numpy()
        assert np.linalg.norm(g - want) <= RTOL * np.linalg.norm(want) + 1e-8, name


def test_rbf_parameters_are_constant_buffers():
    model = tvisnet.ViSNet3D(**SMALL)
    means, betas = expnorm_initial_params(SMALL["num_rbf"], 5.0)
    assert torch.equal(model.rbf.means, means) and torch.equal(model.rbf.betas, betas)
    assert "rbf.means" not in model.state_dict()
    assert not any(n.startswith("rbf.") for n, _ in model.named_parameters())


def model_pair(seed=0, batch_seed=7):
    recs = jdataset(batch_seed, 4, num_conformers=2, heavy_range=(4, 9))
    jbatch = JBatch(**jax.tree.map(jnp.asarray, dataclasses.asdict(
        jpack(recs, max_atoms=32, batch_size=4))))
    jmodel = JConan(**MODEL)
    params = jmodel.init(jax.random.PRNGKey(seed), jbatch, use_barycenter=True)
    params = {k: v for k, v in params.items() if k != "diagnostics"}
    tmodel = ConanModel(device="cpu", **MODEL)
    state = params_from_flax(jax.tree.map(np.asarray, params))
    assert len(state) == len(tmodel.state_dict())
    tmodel.load_state_dict(state)
    tbatch = tpack(tdataset(batch_seed, 4, num_conformers=2, heavy_range=(4, 9), device="cpu"),
                   max_atoms=32, batch_size=4).to("cpu")
    return jmodel, params, jbatch, tmodel, tbatch


def test_flax_checkpoint_reader_and_unmapped_leaves(tmp_path):
    """A JAX parameter checkpoint of the model reads into the state dict
    ``params_from_flax`` gives, which loads into the port's model; a leaf
    that no rule maps raises."""
    _, params, _, _, _ = model_pair()
    _save_pytree(str(tmp_path / "best"), params)
    got = state_dict_from_flax_checkpoint(str(tmp_path / "best.npz"))
    want = params_from_flax(jax.tree.map(np.asarray, params))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    ConanModel(device="cpu", **MODEL).load_state_dict(got)
    tree = jax.tree.map(np.asarray, params)["params"]
    bad = {**tree, "backbone": {**tree["backbone"], "extra": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="extra"):
        params_from_flax(bad)


@pytest.mark.parametrize("stage", [1, 2])
def test_model_matches_flax(stage):
    jmodel, params, jbatch, tmodel, tbatch = model_pair()
    bary = stage == 2
    out_j, muts = jmodel.apply(params, jbatch, use_barycenter=bary, mutable=["diagnostics"])
    with torch.no_grad():
        out_t, n_div = tmodel(tbatch, use_barycenter=bary)
    _close(out_t, out_j, rtol=STAGE2_RTOL if bary else RTOL)
    n_j = int(np.sum(np.asarray(muts["diagnostics"]["fgw_diverged"][0]))) if bary else 0
    assert int(n_div[0]) == n_j


def test_stage2_loss_and_gradients_match_flax():
    jmodel, params, jbatch, tmodel, tbatch = model_pair(batch_seed=11)
    js = jloop.TrainSettings(use_barycenter=True)
    (loss_j, _), grads_j = jax.value_and_grad(jloop.make_loss_fn(jmodel, js), has_aux=True)(
        params, jbatch)
    pred, _ = tmodel(tbatch, use_barycenter=True)
    loss = tloop.masked_mse(pred, tbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=STAGE2_RTOL)
    gj = params_from_flax(jax.tree.map(np.asarray, grads_j))
    for name, g in grads_of(tmodel).items():
        want = gj[name].numpy()
        assert np.linalg.norm(g - want) <= (
            STAGE2_RTOL * np.linalg.norm(want) + 1e-9), name


def test_l2col_postnorm_zeroes_a_non_finite_barycenter():
    model = ConanModel(device="cpu", **MODEL)
    hb = torch.rand(2, 2, 6, 16) + 0.1
    hb[1, 0, 2, 3] = float("nan")
    nbr = torch.rand(4, 6, 6) > 0.5
    x_bary, _ = model._barycenter_readout(hb, nbr, torch.ones(2, 6, dtype=torch.bool))
    assert torch.isfinite(x_bary[0]).all() and torch.equal(x_bary[1], torch.zeros(16))


def test_initialisation_follows_flax_scheme():
    m = ConanModel(device="cpu", seed=3, **MODEL)
    bb = m.backbone
    assert torch.equal(bb.prior_model.embedding.weight, torch.zeros(100, 1))
    assert torch.equal(bb.layers[0].layernorm.weight, torch.ones(32))
    assert torch.equal(bb.layers[0].q_proj.bias, torch.zeros(32))
    assert abs(float(bb.embedding.weight.detach().std()) - 1.0) < 0.1
    w = bb.layers[0].q_proj.weight.detach()
    limit = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
    assert float(w.abs().max()) <= limit and float(w.std()) > 0.3 * limit
    m2 = ConanModel(device="cpu", seed=3, **MODEL)
    for a, b in zip(m.parameters(), m2.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", CONFIGS)
def test_build_model_follows_the_jax_runner(name):
    path = str(ROOT / "config" / "visnet" / f"{name}.yaml")
    jm = jrunner.build_model(jconfig.load_config(path), "conan_fgw")
    tm = trunner.build_model(tconfig.load_config(path), device="cpu")
    assert jm.backbone_name == "visnet" and isinstance(tm.backbone, tvisnet.ViSNet3D)
    assert tm.backbone.cutoff == jm.cutoff == 5.0
    assert (tm.bary_shift, tm.bary_postnorm) == (jm.bary_shift, jm.bary_postnorm) == (1.0, "l2col")
    assert (tm.fgw.alpha, tm.fgw.fixed_structure) == (jm.fgw.alpha, jm.fgw.fixed_structure)
    assert tm.agg_weight == jm.agg_weight
    assert tm.backbone.layers[0].q_proj.in_features == jm.hidden_channels == 128
    assert len(tm.backbone.layers) == 6 and tm.backbone.max_neighbors == 32


def test_one_fit_step_through_step_graphs():
    """One stage-2 step through ``StepGraphs``' eager path on the CPU
    equals a plain ``train_step`` on a copy of the model, bit for bit."""
    import copy

    model = ConanModel(device="cpu", seed=1, **MODEL)
    twin = copy.deepcopy(model)
    settings = tloop.TrainSettings(batch_size=4, use_barycenter=True)
    pb = tpack(tdataset(13, 4, num_conformers=2, heavy_range=(4, 9), device="cpu"),
               max_atoms=32, batch_size=4)
    graphs = tloop.step_graphs(model, tloop.make_optimizer(model, settings), settings, "cpu")
    assert isinstance(graphs, StepGraphs) and not graphs.graphed
    loss, _ = graphs.train(pb)
    loss_t, _ = tloop.train_step(twin, tloop.make_optimizer(twin, settings), pb.to("cpu"), settings)
    assert torch.isfinite(loss) and torch.equal(loss, loss_t)
    for a, b in zip(model.parameters(), twin.parameters()):
        assert torch.equal(a, b)


def test_runner_two_stages_resume_and_predict(tmp_path, caplog):
    """The runner's CLI at full width on a tiny slice of sol250 (12 train
    molecules, K=2, batch 4): stage 1, stage 2 warm-started from its best,
    a ``--resume`` to one more epoch, and predict on stage 2's best, which
    gives the runner's test RMSE."""
    root = tiny_dataset(tmp_path)
    pre = write_config(tmp_path, "pre.yaml", "pre", epochs=1)
    bc = write_config(tmp_path, "bc.yaml", "bc", epochs=1)
    more = write_config(tmp_path, "bc2.yaml", "bc", epochs=2)
    override = ("--model_name", "visnet")
    with caplog.at_level(logging.INFO, logger="conan_fgw_tpu_torch"):
        trunner.main(_cli(root, pre, "conan_fgw_pre", *override))
        trunner.main(_cli(root, bc, "conan_fgw", *override))
        summary = trunner.main(_cli(root, more, "conan_fgw", "--resume", *override))
    stage1 = root / "models/cli/1/run_conan_fgw_pre:0"
    assert f"warm-started run 0 from {stage1}" in caplog.text
    assert "resumed from epoch 1" in caplog.text
    rows = (root / "metrics/cli/1/run_conan_fgw:0/metrics.csv").read_text().splitlines()
    assert len(rows) == 3
    text = Path(more).read_text().replace("model_name: schnet", "model_name: visnet")
    Path(more).write_text(text)
    rmse = tpredict.main(["--config", more, "--checkpoint", str(root / "models/cli/1/run_conan_fgw:0"),
                          "--data_root", str(root), "--device", "cpu"])
    assert np.isfinite(rmse) and rmse == summary["test_rmse"]["mean"]
