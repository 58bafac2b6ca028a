"""Port parity: the DimeNet backbone, ``ConanModel(backbone_name="dimenet")``
and the barycenter's ``fixed_structure`` against the JAX package on the CPU,
under weights copied by ``params_from_flax``, at a small size (hidden 16, 2
blocks for the backbone; N=32, B=4, K=2).

Tolerances: the bases and backbone outputs rtol 1e-4, atol 1e-5 of the
largest magnitude (at least 1e-5): DimeNet's outputs at the flax
initialisation reach the hundreds and more, where a float32 ulp exceeds
1e-5; the model's stage 1 rtol 1e-4 and stage 2 rtol 1e-3 (the barycenter's
bound), as ``tests/test_torch_model.py``, and at the same rtol with the
output blocks scaled down, where the prediction is O(1); gradients 1e-4 (backbone) and 1e-3
(stage 2) of each leaf's norm, with a floor of 1e-9 of the global norm: at
this initialisation the loss is near 1e13 and the GAT's attention vectors
get gradients 1e-15 of the global norm, below what float32 resolves; the
barycenter atol 1e-3 and its gradient 1e-4 in norm, as
``tests/test_torch_fgw.py``; slots, triplets and neighbour masks exactly."""

import copy
import dataclasses
import logging
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.data.packing import PackedBatch as JBatch
from conan_fgw_tpu.data.packing import pack_batch as jpack
from conan_fgw_tpu.data.synthetic import random_dataset as jdataset
from conan_fgw_tpu.models import dimenet as jdimenet
from conan_fgw_tpu.models.heads import ConanModel as JConan
from conan_fgw_tpu.ops.fgw.barycenter import FGWConfig as JFGWConfig
from conan_fgw_tpu.ops.fgw.barycenter import fgw_barycenter_batch as j_bary
from conan_fgw_tpu.train import config as jconfig
from conan_fgw_tpu.train.checkpoints import _save_pytree
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu.train import runner as jrunner
from conan_fgw_tpu_torch.convert import params_from_flax, state_dict_from_flax_checkpoint
from conan_fgw_tpu_torch.data.packing import pack_batch as tpack
from conan_fgw_tpu_torch.data.synthetic import random_dataset as tdataset
from conan_fgw_tpu_torch.models import dimenet as tdimenet
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.ops.fgw.barycenter import FGWConfig, fgw_barycenter_batch
from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask
from conan_fgw_tpu_torch.train import config as tconfig
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import predict as tpredict
from conan_fgw_tpu_torch.train import runner as trunner
from test_torch_runner import _cli, tiny_dataset, write_config
from test_torch_visnet import flat_inputs, grads_of

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(hidden_channels=16, num_blocks=2)
RTOL, ATOL = 1e-4, 1e-5
STAGE2_RTOL = 1e-3
BARY_ATOL, GRAD_RTOL = 1e-3, 1e-4
GRAD_FLOOR = 1e-9
FIXED = dict(alpha=0.5, fixed_structure=True)
MODEL = dict(backbone_name="dimenet", hidden_channels=16, cutoff=5.0, bary_shift=0.5)
CONFIGS = ("sol250_5", "sol250_5_bc", "sol250_5_bc_agg0")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One CPU thread runs these shapes about as fast as many and keeps the
    file from fighting other test workers for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def backbone_pair(**options):
    (z, pos, mask), _ = flat_inputs()
    jmodel = jdimenet.DimeNet3D(**SMALL, remat=False, **options)
    params = jmodel.init(jax.random.PRNGKey(0), z, pos, mask)
    tmodel = tdimenet.DimeNet3D(**SMALL, **options)
    state = params_from_flax({"backbone": jax.tree.map(np.asarray, params["params"])})
    tmodel.load_state_dict({k.removeprefix("backbone."): v for k, v in state.items()})
    return jmodel, params, tmodel


def assert_grads_close(model, want: dict, rtol: float, prefix: str = ""):
    """Each leaf's gradient to ``rtol`` of its norm, with a floor of
    ``GRAD_FLOOR`` of the global norm."""
    floor = GRAD_FLOOR * np.sqrt(sum(np.sum(w.numpy() ** 2) for w in want.values()))
    for name, g in grads_of(model).items():
        w = want[prefix + name].numpy()
        assert np.linalg.norm(g - w) <= rtol * np.linalg.norm(w) + floor, name


def _close(got, want, rtol=RTOL, atol=ATOL):
    """``rtol``, and ``atol`` of the largest magnitude (at least ``atol``)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol, atol=atol * scale)


def test_spherical_bessel_roots():
    roots = tdimenet._spherical_jn_roots(3, 3)
    np.testing.assert_allclose(roots, jdimenet._spherical_jn_roots(3, 3), rtol=1e-12)
    np.testing.assert_allclose(roots[0], [math.pi, 2 * math.pi, 3 * math.pi], rtol=1e-6)
    for l in range(3):
        for r in roots[l]:
            assert abs(float(tdimenet._spherical_jn(l, torch.tensor(r, dtype=torch.float64)))) < 1e-9


def test_envelope_and_bases_match():
    x = np.linspace(0.0, 1.3, 60, dtype=np.float32)
    _close(tdimenet.envelope(torch.from_numpy(x), 5), jdimenet.envelope(jnp.asarray(x), 5))
    assert (tdimenet.envelope(torch.tensor([1.0, 2.0]), 5) == 0).all()
    c = np.linspace(-1.0, 1.0, 60, dtype=np.float32)
    for l in range(4):
        # the closed forms cancel near 0, the more the higher l, in both
        # packages alike: l = 2, 3 (which the model's 2 spherical orders
        # do not reach) are held from x = 2 on
        xs = np.linspace(0.05 if l < 2 else 2.0, 12.0, 60, dtype=np.float32)
        _close(tdimenet._spherical_jn(l, torch.from_numpy(xs)),
               jdimenet._spherical_jn(l, jnp.asarray(xs)))
        _close(tdimenet._legendre_cos(l, torch.from_numpy(c)),
               jdimenet._legendre_cos(l, jnp.asarray(c)))


def reference_slots(nbr: np.ndarray, m_slots: int):
    """Neighbour slots by definition: row i's sources in index order in its
    first slots; a triplet (i, m, m') is valid where both slots are and
    k = idx[j, m'] is not i."""
    G, N, _ = nbr.shape
    slot = np.zeros((G, N, m_slots), bool)
    idx = np.zeros((G, N, m_slots), np.int64)
    for g in range(G):
        for i in range(N):
            src = np.flatnonzero(nbr[g, i])
            slot[g, i, :len(src)] = True
            idx[g, i, :len(src)] = src
    tmask = np.zeros((G, N, m_slots, m_slots), bool)
    for g, i, m in zip(*np.nonzero(slot)):
        j = idx[g, i, m]
        for mm in np.flatnonzero(slot[g, j]):
            tmask[g, i, m, mm] = idx[g, j, mm] != i
    return idx, slot, tmask


@pytest.mark.parametrize("cap", [32, 6])
def test_slots_and_triplets(cap, monkeypatch):
    """The stable argsort's slots and the triplet mask, with the cap
    binding at 6, against their definition; and the trunk's neighbour mask
    against JAX's."""
    seen = {}
    original = tdimenet.InteractionBlock.forward

    def spy(self, x, rbf, sbf, slot, tmask, idx):
        seen.update(slot=slot, tmask=tmask, idx=idx)
        return original(self, x, rbf, sbf, slot, tmask, idx)

    monkeypatch.setattr(tdimenet.InteractionBlock, "forward", spy)
    jmodel, params, tmodel = backbone_pair(max_neighbors=cap)
    (z_j, pos_j, mask_j), (z, pos, mask) = flat_inputs(seed=3, heavy=(9, 12))
    with torch.no_grad():
        _, nbr = tmodel.trunk(z, pos, mask)
    _, nbr_j = jmodel.apply(params, z_j, pos_j, mask_j, method="trunk")
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(nbr_j))
    within = radius_graph_mask(pairwise_distances(pos), mask, 5.0, None).sum(-1)
    if cap == 6:
        assert bool((within > cap + 1).any()), "the inputs never engage the cap"
    m_slots = min(cap + 1, z.shape[-1])
    idx, slot, tmask = reference_slots(nbr.numpy(), m_slots)
    np.testing.assert_array_equal(seen["slot"].numpy(), slot)
    np.testing.assert_array_equal(seen["tmask"].numpy(), tmask)
    np.testing.assert_array_equal(np.where(slot, seen["idx"].numpy(), 0), idx)


@pytest.mark.parametrize("cap", [32, 6])
def test_backbone_matches_flax(cap):
    jmodel, params, tmodel = backbone_pair(max_neighbors=cap)
    (z_j, pos_j, mask_j), (z, pos, mask) = flat_inputs(seed=5)
    h3_j, hb_j, nbr_j = jmodel.apply(params, z_j, pos_j, mask_j, method="embed_dual")
    with torch.no_grad():
        h3, hb, nbr = tmodel.embed_dual(z, pos, mask)
        out = tmodel(z, pos, mask)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(nbr_j))
    _close(h3, h3_j)
    _close(hb, hb_j)
    _close(out, jmodel.apply(params, z_j, pos_j, mask_j))


def test_backbone_gradient_matches_flax():
    """Parameter gradients through the deterministic gathers and the
    recomputed blocks, with the cap binding, against JAX's."""
    jmodel, params, tmodel = backbone_pair(max_neighbors=6)
    (z_j, pos_j, mask_j), (z, pos, mask) = flat_inputs(seed=9)

    def loss_j(p):
        out = jmodel.apply(p, z_j, pos_j, mask_j)
        return jnp.sum(jnp.sin(out))

    grads_j = params_from_flax(
        {"backbone": jax.tree.map(np.asarray, jax.grad(loss_j)(params)["params"])})
    torch.sum(torch.sin(tmodel(z, pos, mask))).backward()
    assert_grads_close(tmodel, grads_j, RTOL, prefix="backbone.")


def barycenter_inputs(seed=0, B=3, K=4, N=10, D=6):
    rng = np.random.default_rng(seed)
    Ys = rng.random((B, K, N, D)).astype(np.float32) + 0.1
    Cs = (rng.random((B, K, N, N)) > 0.6).astype(np.float32)
    Cs = np.maximum(Cs, Cs.transpose(0, 1, 3, 2))
    return Ys, Cs


def test_fixed_structure_barycenter_matches_jax():
    Ys, Cs = barycenter_inputs()
    jcfg = JFGWConfig(**FIXED)
    Y_j, C_j, n_j = j_bary(jnp.asarray(Ys), jnp.asarray(Cs), config=jcfg, return_diverged=True)
    Ys_t = torch.from_numpy(Ys).requires_grad_(True)
    Y_t, C_t, n_t = fgw_barycenter_batch(Ys_t, torch.from_numpy(Cs), config=FGWConfig(**FIXED))
    np.testing.assert_allclose(Y_t.detach().numpy(), np.asarray(Y_j), atol=BARY_ATOL)
    np.testing.assert_array_equal(C_t.numpy(), Cs[:, 0])
    np.testing.assert_array_equal(np.asarray(C_j), Cs[:, 0])
    assert int(n_t) == int(n_j)
    # the structure stays the first conformer's: the plans differ from a free solve's
    Y_free, C_free, _ = fgw_barycenter_batch(torch.from_numpy(Ys), torch.from_numpy(Cs),
                                             config=FGWConfig(alpha=0.5))
    assert not torch.equal(C_free, C_t)
    w = np.random.default_rng(1).standard_normal(Y_t.shape).astype(np.float32)
    g_j = jax.grad(lambda y: jnp.sum(j_bary(y, jnp.asarray(Cs), config=jcfg)[0] * w))(
        jnp.asarray(Ys))
    torch.sum(Y_t * torch.from_numpy(w)).backward()
    g_t = Ys_t.grad.numpy()
    assert np.linalg.norm(g_t - np.asarray(g_j)) <= GRAD_RTOL * np.linalg.norm(np.asarray(g_j))


def scale_outputs(params, scale: float):
    """The flax tree with the last Dense kernel of every output block times
    ``scale``."""
    bb = dict(params["params"]["backbone"])
    for name in [k for k in bb if k.startswith("outputs_")]:
        last = f"Dense_{len(bb[name]) - 1}"
        bb[name] = {**bb[name], last: {"kernel": bb[name][last]["kernel"] * scale}}
    return {**params, "params": {**params["params"], "backbone": bb}}


def model_pair(seed=0, batch_seed=7, output_scale=1.0):
    recs = jdataset(batch_seed, 4, num_conformers=2, heavy_range=(4, 9))
    jbatch = JBatch(**jax.tree.map(jnp.asarray, dataclasses.asdict(
        jpack(recs, max_atoms=32, batch_size=4))))
    jmodel = JConan(fgw=JFGWConfig(**FIXED), **MODEL)
    params = jmodel.init(jax.random.PRNGKey(seed), jbatch, use_barycenter=True)
    params = {k: v for k, v in params.items() if k != "diagnostics"}
    if output_scale != 1.0:
        params = scale_outputs(params, output_scale)
    tmodel = ConanModel(device="cpu", fgw=FGWConfig(**FIXED), **MODEL)
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
    ConanModel(device="cpu", fgw=FGWConfig(**FIXED), **MODEL).load_state_dict(got)
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
    assert int(n_div) == n_j


def test_stage2_loss_and_gradients_match_flax():
    jmodel, params, jbatch, tmodel, tbatch = model_pair(batch_seed=11)
    js = jloop.TrainSettings(use_barycenter=True)
    (loss_j, _), grads_j = jax.value_and_grad(jloop.make_loss_fn(jmodel, js), has_aux=True)(
        params, jbatch)
    pred, _ = tmodel(tbatch, use_barycenter=True)
    loss = tloop.masked_mse(pred, tbatch)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=STAGE2_RTOL)
    assert_grads_close(tmodel, params_from_flax(jax.tree.map(np.asarray, grads_j)), STAGE2_RTOL)


# The last Dense layers of the output blocks times 1e-8 bring the prediction
# from up to 3e7 (the flax initialisation) to O(1), where the barycenter
# branch, agg_weight * tbary(x_bary), is a large part of it: the stage-2
# comparison then sees the fixed-structure barycenter and the GAT.
SMALL_OUTPUTS = 1e-8


def test_stage2_prediction_with_small_outputs_matches_flax():
    jmodel, params, jbatch, tmodel, tbatch = model_pair(output_scale=SMALL_OUTPUTS)
    out_j, muts = jmodel.apply(params, jbatch, use_barycenter=True, mutable=["diagnostics"])
    out_3d, _ = jmodel.clone(agg_weight=0.0).apply(params, jbatch, use_barycenter=True,
                                                   mutable=["diagnostics"])
    out_j, bary_j = np.asarray(out_j), np.asarray(out_j) - np.asarray(out_3d)
    assert np.abs(out_j).max() < 10.0
    assert np.abs(bary_j).min() > 100 * STAGE2_RTOL * np.abs(out_j).max(), "branch too small"
    with torch.no_grad():
        out_t, n_div = tmodel(tbatch, use_barycenter=True)
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=STAGE2_RTOL, atol=ATOL)
    assert int(n_div) == int(np.sum(np.asarray(muts["diagnostics"]["fgw_diverged"][0])))


def test_stage2_gradients_with_small_outputs_match_flax():
    jmodel, params, jbatch, tmodel, tbatch = model_pair(batch_seed=11,
                                                        output_scale=SMALL_OUTPUTS)
    js = jloop.TrainSettings(use_barycenter=True)
    (loss_j, _), grads_j = jax.value_and_grad(jloop.make_loss_fn(jmodel, js), has_aux=True)(
        params, jbatch)
    pred, _ = tmodel(tbatch, use_barycenter=True)
    loss = tloop.masked_mse(pred, tbatch)
    loss.backward()
    assert float(loss_j) < 100.0
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=STAGE2_RTOL)
    assert_grads_close(tmodel, params_from_flax(jax.tree.map(np.asarray, grads_j)), STAGE2_RTOL)


def test_initialisation_follows_flax_scheme():
    m = ConanModel(device="cpu", seed=3, **MODEL)
    bb = m.backbone
    assert torch.equal(bb.bessel_freq.detach(), torch.arange(1, 4, dtype=torch.float32) * math.pi)
    emb = bb.embedding.weight.detach()
    assert float(emb.abs().max()) <= math.sqrt(3.0) and float(emb.std()) > 0.8
    w = bb.blocks[0].lin_ji.weight.detach()
    np.testing.assert_allclose(float(w.var(unbiased=False)), 2.0 / 32, rtol=1e-4)
    assert torch.equal(bb.blocks[0].lin_ji.bias.detach(), torch.zeros(16))
    bil = bb.blocks[0].bilinear.detach()
    assert abs(float(bil.std()) - 2.0 / 8) < 0.05
    out = bb.outputs[0].lins[-1].weight.detach()
    assert float(out.abs().max()) <= (6.0 / sum(out.shape)) ** 0.5
    m2 = ConanModel(device="cpu", seed=3, **MODEL)
    for a, b in zip(m.parameters(), m2.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("name", CONFIGS)
def test_build_model_follows_the_jax_runner(name):
    path = str(ROOT / "config" / "dimenet" / f"{name}.yaml")
    jm = jrunner.build_model(jconfig.load_config(path), "conan_fgw")
    tm = trunner.build_model(tconfig.load_config(path), device="cpu")
    assert jm.backbone_name == "dimenet" and isinstance(tm.backbone, tdimenet.DimeNet3D)
    assert tm.backbone.cutoff == jm.cutoff == 5.0
    assert (tm.bary_shift, tm.bary_postnorm) == (jm.bary_shift, jm.bary_postnorm) == (0.5, "none")
    assert (tm.fgw.alpha, tm.fgw.fixed_structure) == (jm.fgw.alpha, jm.fgw.fixed_structure) == (
        0.5, True)
    assert tm.agg_weight == jm.agg_weight
    assert tm.backbone.embedding.weight.shape == (95, jm.hidden_channels) == (95, 128)
    assert tm.backbone.outputs[0].lins[-1].out_features == 64
    assert len(tm.backbone.blocks) == 6 and tm.backbone.max_neighbors == 32


@pytest.mark.parametrize("backbone", ["visnet", "dimenet"])
def test_check_supported_accepts_the_backbones_and_bf16(backbone, tmp_path):
    src = ROOT / "config" / backbone / "sol250_5_bc.yaml"
    trunner.check_supported(tconfig.load_config(str(src)), torch.device("cpu"))
    bf16 = tmp_path / "bf16.yaml"
    bf16.write_text(src.read_text() + "compute_dtype: bfloat16\n")
    config = tconfig.load_config(str(bf16))
    assert config.compute_dtype == "bfloat16"
    trunner.check_supported(config, torch.device("cpu"))
    f16 = tmp_path / "f16.yaml"
    f16.write_text(src.read_text() + "compute_dtype: float16\n")
    trunner.check_supported(tconfig.load_config(str(f16)), torch.device("cpu"))
    lacking = tmp_path / "complex.yaml"
    lacking.write_text(src.read_text() + "compute_dtype: complex64\n")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        trunner.check_supported(tconfig.load_config(str(lacking)), torch.device("cpu"))
    bad = tmp_path / "bad.yaml"
    bad.write_text(src.read_text() + "compute_dtype: bf16\n")
    with pytest.raises(ValueError, match="compute_dtype"):
        trunner.check_supported(tconfig.load_config(str(bad)), torch.device("cpu"))


def test_one_fit_step_through_step_graphs():
    """One stage-2 step through ``StepGraphs``' eager path on the CPU
    equals a plain ``train_step`` on a copy of the model, bit for bit."""
    model = ConanModel(device="cpu", seed=1, fgw=FGWConfig(**FIXED), **MODEL)
    twin = copy.deepcopy(model)
    settings = tloop.TrainSettings(batch_size=4, use_barycenter=True)
    pb = tpack(tdataset(13, 4, num_conformers=2, heavy_range=(4, 9), device="cpu"),
               max_atoms=32, batch_size=4)
    graphs = tloop.step_graphs(model, tloop.make_optimizer(model, settings), settings, "cpu")
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
    override = ("--model_name", "dimenet")
    with caplog.at_level(logging.INFO, logger="conan_fgw_tpu_torch"):
        trunner.main(_cli(root, pre, "conan_fgw_pre", *override))
        trunner.main(_cli(root, bc, "conan_fgw", *override))
        summary = trunner.main(_cli(root, more, "conan_fgw", "--resume", *override))
    stage1 = root / "models/cli/1/run_conan_fgw_pre:0"
    assert f"warm-started run 0 from {stage1}" in caplog.text
    assert "resumed from epoch 1" in caplog.text
    rows = (root / "metrics/cli/1/run_conan_fgw:0/metrics.csv").read_text().splitlines()
    assert len(rows) == 3
    text = Path(more).read_text().replace("model_name: schnet", "model_name: dimenet")
    Path(more).write_text(text)
    rmse = tpredict.main(["--config", more, "--checkpoint", str(root / "models/cli/1/run_conan_fgw:0"),
                          "--data_root", str(root), "--device", "cpu"])
    assert np.isfinite(rmse) and rmse == summary["test_rmse"]["mean"]
