"""Port parity above 128 atoms, on the CPU: what the card runs through K3's
cluster route and ``csrc/cfconv_wgmma.cu``, held against the JAX package.

- ``fgw_couplings_flat`` at n=130 and n=160 (S=2; padded to 160) against
  the JAX flat solver (``pallas_fgw_couplings_flat`` in interpret mode,
  which takes any n), atol 2.5e-6 (K3's gate on the card), flags equal.
- ``fgw_barycenter_batch`` at N=130 (B=1, K=2) against JAX's, Y and C
  within 1e-3 (the barycenter amplifies f32 rounding about 10^3-fold).
- The plain cfconv at N=160 against JAX's ``_cfconv_xla`` (F=16), rtol
  5e-4 with a 1e-5 floor; the kernels' edge formulation (``edge_list``,
  ``cfconv_edges`` in 3xTF32) at N=160 and N=192 in both cap modes,
  against the plain version within 5e-4 of the largest, in the kernels'
  order.
- One SchNet stage-2 train step at N=160 (B=1, K=2, hidden 16) against
  JAX's, loss and gradients within 1e-4 of their norms.
- ``dataset_max_atoms``/``bucket_for``/``bucket_boundaries`` at 192 as
  JAX's, raising as JAX's does above the largest bucket.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.data.packing import PackedBatch as JBatch
from conan_fgw_tpu.data.packing import bucket_for as j_bucket_for
from conan_fgw_tpu.data.packing import pack_batch as jpack
from conan_fgw_tpu.data.synthetic import random_dataset as jdataset
from conan_fgw_tpu.models.heads import ConanModel as JConan
from conan_fgw_tpu.ops.fgw.barycenter import FGWConfig as JFGWConfig
from conan_fgw_tpu.ops.fgw.barycenter import fgw_barycenter_batch as j_bary
from conan_fgw_tpu.ops.pallas.cfconv import _cfconv_xla
from conan_fgw_tpu.ops.pallas.fgw import pallas_fgw_couplings_flat
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu_torch.convert import params_from_flax
from conan_fgw_tpu_torch.data.packing import bucket_for
from conan_fgw_tpu_torch.data.packing import pack_batch as tpack
from conan_fgw_tpu_torch.data.synthetic import random_dataset as tdataset
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.ops.cuda import fgw as k3
from conan_fgw_tpu_torch.ops.cuda.cfconv import _cfconv_plain, cfconv_edges, edge_list, split_mm
from conan_fgw_tpu_torch.ops.fgw.barycenter import FGWConfig, fgw_barycenter_batch
from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask
from conan_fgw_tpu_torch.train import loop as tloop
from test_torch_fgw import KW, _solves, _t

FGW_ATOL = 2.5e-6
BARY_ATOL = 1e-3
CF_RTOL, CF_ATOL = 5e-4, 1e-5
STEP_RTOL = 1e-4
TINY = dict(hidden_channels=16, num_filters=16, num_gaussians=10, num_interactions=2)


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


# -------------------------------------------------------------------- K3
@pytest.mark.parametrize("n", [130, 160])
def test_flat_solve_above_the_largest_bucket_matches_jax(n):
    args = _solves(s=2, n=n, seed=n)
    T_j, div_j = pallas_fgw_couplings_flat(*map(jnp.asarray, args), interpret=True, **KW)
    T_t, (div_t, _) = k3.fgw_couplings_flat(*_t(*args), **KW)
    assert T_t.shape == (2, n, n)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=FGW_ATOL, rtol=0)
    np.testing.assert_array_equal(div_t.numpy(), np.asarray(div_j))


def test_barycenter_batch_above_the_largest_bucket_matches_jax():
    """One molecule of 130 atoms in two conformers: five padded flat solves
    of 160 rows (K3's cluster route on the card)."""
    rng = np.random.default_rng(130)
    Ys = (rng.standard_normal((1, 2, 130, 3)) * 0.5 + 1).astype(np.float32)
    a = (rng.random((1, 2, 130, 130)) < 0.1).astype(np.float32)
    Cs = np.maximum(a, a.transpose(0, 1, 3, 2))
    Y_j, C_j, n_j = j_bary(jnp.asarray(Ys), jnp.asarray(Cs), config=JFGWConfig(),
                           return_diverged=True)
    Y_t, C_t, (n_t, _) = fgw_barycenter_batch(*_t(Ys, Cs), config=FGWConfig())
    np.testing.assert_allclose(Y_t.numpy(), np.asarray(Y_j), atol=BARY_ATOL)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), atol=BARY_ATOL)
    assert int(n_t) == int(n_j)


# ------------------------------------------------------------------ K1/K2
def _graphs(n, seed, g=2, f=16, gauss=10):
    """``g`` graphs of ``n`` slots: synthetic molecules (``heavy`` atoms
    chosen so that they fill most of the slots), the rest padding."""
    heavy = {160: (80, 88), 192: (96, 104)}[n]
    recs = tdataset(seed, g, num_conformers=1, heavy_range=heavy, device="cpu")
    pb = tpack(recs, max_atoms=n, batch_size=g)
    pos = torch.from_numpy(pb.pos.reshape(g, n, 3).copy())
    mask = torch.from_numpy(pb.atom_mask.astype(np.float32))
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    weights = (rnd(g, n, f), rnd(gauss, f, scale=0.3), rnd(f, scale=0.1), rnd(f, f, scale=0.2),
               rnd(f, scale=0.1))
    return pos, mask, weights, rnd(g, n, f)


@pytest.mark.parametrize("cap", [32, 8])
def test_plain_cfconv_at_n160_matches_jax(cap):
    pos, mask, (x, w1, b1, w2, b2), cot = _graphs(160, seed=7)

    def jloss(x, w1, b1, w2, b2):
        out = _cfconv_xla(jnp.asarray(pos.numpy()), jnp.asarray(mask.numpy()), x, w1, b1, w2, b2,
                          cutoff=10.0, num_gaussians=10, max_neighbors=cap)
        return jnp.sum(out * jnp.asarray(cot.numpy())), out

    (_, out_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a.numpy()) for a in (x, w1, b1, w2, b2)))
    leaves = [a.clone().requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    out_t = _cfconv_plain(pos, mask, *leaves, 10.0, 10, cap)
    (out_t * cot).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=CF_RTOL,
                               atol=CF_ATOL)
    for name, a, gj in zip(("x", "w1", "b1", "w2", "b2"), leaves, grads_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(gj), rtol=CF_RTOL, atol=CF_ATOL,
                                   err_msg=f"grad {name}")


@pytest.mark.parametrize("cap_mode", ["index", "nearest"])
@pytest.mark.parametrize("n", [160, 192])
def test_kernel_edge_formulation_above_128_atoms(n, cap_mode):
    """The large kernels' edge lists (K1 by graph, target, source; K2 by
    graph, source, target) hold every edge of the capped radius graph once,
    in that order, and their 3xTF32 formulation gives the plain version's
    forward and gradients within 5e-4 of the largest."""
    pos, mask, (x, w1, b1, w2, b2), cot = _graphs(n, seed=n + len(cap_mode))
    nbr = radius_graph_mask(pairwise_distances(pos), mask > 0.5, 10.0, 32, cap_mode)
    within = radius_graph_mask(pairwise_distances(pos), mask > 0.5, 10.0, None).sum(-1)
    assert bool((within > 32).any()), "the cap never binds"
    for source_major in (False, True):
        g, i, j = edge_list(pos, mask, 10.0, 32, source_major=source_major, cap_mode=cap_mode)
        assert len(g) == int(nbr.sum()) and bool(nbr[g, i, j].all())
        a, b = (j, i) if source_major else (i, j)
        key = (g * n + a) * n + b
        assert bool((key[1:] > key[:-1]).all())
    out_k, grads_k = cfconv_edges(pos, mask, x, w1, b1, w2, b2, cot, 10.0, 32, mm=split_mm,
                                  cap_mode=cap_mode)
    leaves = [a.clone().requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    out_p = _cfconv_plain(pos, mask, *leaves, 10.0, 10, 32, cap_mode)
    grads_p = torch.autograd.grad(out_p, leaves, cot)
    assert _rel(out_k, out_p.detach()) <= CF_RTOL
    for name, gk, gp in zip(("dx", "dw1", "db1", "dw2", "db2"), grads_k, grads_p):
        assert _rel(gk, gp) <= CF_RTOL, name


# ------------------------------------------------------------------ model
def test_schnet_stage2_step_at_n160_matches_jax():
    """One regression stage-2 train step (masked MSE through the
    barycenter) on one molecule of 140 atoms in two conformers,
    padded to N=160: the loss and each parameter's gradient in norm."""
    recs = jdataset(160, 1, num_conformers=2, heavy_range=(88, 96))
    pb = jpack(recs, max_atoms=160, batch_size=1)
    assert pb.z.shape[-1] == 160 and 128 < recs[0].num_atoms <= 160
    jbatch = JBatch(**jax.tree.map(jnp.asarray, dataclasses.asdict(pb)))
    jmodel = JConan(**TINY)
    params = jmodel.init(jax.random.PRNGKey(160), jbatch, use_barycenter=True)
    params = {k: v for k, v in params.items() if k != "diagnostics"}
    js = jloop.TrainSettings(use_barycenter=True)
    (loss_j, _), grads_j = jax.value_and_grad(jloop.make_loss_fn(jmodel, js), has_aux=True)(
        params, jbatch)
    tmodel = ConanModel(device="cpu", **TINY)
    tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    tbatch = tpack(tdataset(160, 1, num_conformers=2, heavy_range=(88, 96), device="cpu"),
                   max_atoms=160, batch_size=1).to("cpu")
    pred, _ = tmodel(tbatch, use_barycenter=True)
    loss_t = tloop.masked_mse(pred, tbatch)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=STEP_RTOL)
    gj = {k: v.numpy() for k, v in params_from_flax(jax.tree.map(np.asarray, grads_j)).items()}
    norm_j = np.sqrt(sum(np.sum(g * g) for g in gj.values()))
    for name, p in tmodel.named_parameters():
        g = np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.numpy()
        assert np.linalg.norm(g - gj[name]) <= STEP_RTOL * np.linalg.norm(gj[name]) + \
            1e-7 * norm_j, name


# ----------------------------------------------------------------- buckets
def test_buckets_at_192_atoms_are_the_jax_packages():
    """``max_atoms: 192`` gives JAX's ladder; without it a molecule above
    128 atoms raises in both packages with the same message."""
    assert tloop.bucket_boundaries(192) == jloop.bucket_boundaries(192) == (32, 64, 96, 128, 192)
    for n in (129, 181, 192):
        assert bucket_for(n, tloop.bucket_boundaries(192)) == j_bucket_for(
            n, jloop.bucket_boundaries(192)) == 192
    recs = tdataset(181, 3, num_conformers=1, heavy_range=(96, 104), device="cpu")
    assert max(r.num_atoms for r in recs) > 128
    jrecs = jdataset(181, 3, num_conformers=1, heavy_range=(96, 104))
    with pytest.raises(ValueError) as t_err:
        tloop.dataset_max_atoms(recs)
    with pytest.raises(ValueError) as j_err:
        jloop.dataset_max_atoms(jrecs)
    assert str(t_err.value) == str(j_err.value)
    small = dict(num_conformers=1, heavy_range=(40, 50))
    assert tloop.dataset_max_atoms(tdataset(5, 3, device="cpu", **small)) == \
        jloop.dataset_max_atoms(jdataset(5, 3, **small))
