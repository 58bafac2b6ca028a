"""Port parity: ``ConanModel`` (regression, SchNet backbone) against the flax
model under weights copied by ``params_from_flax``, on the CPU, at a small
size (hidden 32, 2 interactions, N=32, B=4, K=2).

Tolerances: stage 1 rtol 1e-4; stage 2 rtol 1e-3, which carries the
barycenter's 1e-3 bound; the divergence count exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.data.packing import PackedBatch as JBatch
from conan_fgw_tpu.data.packing import pack_batch as jpack
from conan_fgw_tpu.data.synthetic import random_dataset as jdataset
from conan_fgw_tpu.models.heads import ConanModel as JConan
from conan_fgw_tpu_torch.convert import params_from_flax
from conan_fgw_tpu_torch.data.packing import pack_batch as tpack
from conan_fgw_tpu_torch.data.synthetic import random_dataset as tdataset
from conan_fgw_tpu_torch.models.heads import ConanModel

SMALL = dict(hidden_channels=32, num_filters=32, num_gaussians=10, num_interactions=2)
STAGE1_RTOL, STAGE2_RTOL, ATOL = 1e-4, 1e-3, 1e-5


def make_pair(pad_mode="reference", max_neighbors=32, seed=0, batch_seed=7, heavy=(4, 9)):
    """A flax model with its parameters and the port's model holding the
    same weights, plus one batch in both forms."""
    recs = jdataset(batch_seed, 4, num_conformers=2, heavy_range=heavy)
    pb = jpack(recs, max_atoms=32, batch_size=4)
    jbatch = JBatch(**jax.tree.map(jnp.asarray, dataclasses.asdict(pb)))
    jmodel = JConan(max_neighbors=max_neighbors, bary_pad_mode=pad_mode, **SMALL)
    params = jmodel.init(jax.random.PRNGKey(seed), jbatch, use_barycenter=True)
    params = {k: v for k, v in params.items() if k != "diagnostics"}
    tmodel = ConanModel(max_neighbors=max_neighbors, bary_pad_mode=pad_mode, device="cpu", **SMALL)
    tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    tbatch = tpack(tdataset(batch_seed, 4, num_conformers=2, heavy_range=heavy, device="cpu"),
                   max_atoms=32, batch_size=4).to("cpu")
    return jmodel, params, jbatch, tmodel, tbatch


def test_params_from_flax_maps_every_leaf():
    _, params, _, tmodel, _ = make_pair()
    state = params_from_flax(jax.tree.map(np.asarray, params))
    n_leaves = len(jax.tree.leaves(params))
    assert len(state) == n_leaves == len(tmodel.state_dict())
    bad = {"params": {**params["params"], "extra": {"kernel": np.zeros((2, 2))}}}
    with pytest.raises(KeyError, match="extra"):
        params_from_flax(jax.tree.map(np.asarray, bad))


@pytest.mark.parametrize(
    "stage,pad_mode,cap",
    [(1, "reference", 32), (2, "reference", 32), (2, "masked", 32), (2, "reference", 6)],
)
def test_forward_matches_flax(stage, pad_mode, cap):
    jmodel, params, jbatch, tmodel, tbatch = make_pair(pad_mode, cap)
    bary = stage == 2
    out_j, muts = jmodel.apply(params, jbatch, use_barycenter=bary, mutable=["diagnostics"])
    with torch.no_grad():
        out_t, n_div = tmodel(tbatch, use_barycenter=bary)
    rtol = STAGE2_RTOL if bary else STAGE1_RTOL
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=rtol, atol=ATOL)
    if bary:
        n_j = int(np.sum(np.asarray(muts["diagnostics"]["fgw_diverged"][0])))
        assert int(n_div) == n_j
    else:
        assert int(n_div) == 0


def test_dual_heads_and_neighbor_mask_match():
    jmodel, params, jbatch, tmodel, tbatch = make_pair(max_neighbors=6)
    B, K, N = jbatch.z.shape
    z, pos = jbatch.z.reshape(B * K, N), jbatch.pos.reshape(B * K, N, 3)
    mask = jnp.repeat(jbatch.atom_mask, K, axis=0)
    h3_j, hb_j, nbr_j = jmodel.apply(
        params, z, pos, mask, method=lambda m, *a: m.backbone.embed_dual(*a)
    )
    with torch.no_grad():
        h3_t, hb_t, nbr_t = tmodel.backbone.embed_dual(
            tbatch.z.reshape(B * K, N), tbatch.pos.reshape(B * K, N, 3),
            tbatch.atom_mask.repeat_interleave(K, dim=0),
        )
    np.testing.assert_array_equal(nbr_t.numpy(), np.asarray(nbr_j))
    np.testing.assert_allclose(h3_t.numpy(), np.asarray(h3_j), rtol=STAGE1_RTOL, atol=ATOL)
    np.testing.assert_allclose(hb_t.numpy(), np.asarray(hb_j), rtol=STAGE1_RTOL, atol=ATOL)


def test_initialisation_follows_flax_scheme():
    m = ConanModel(device="cpu", seed=3, **SMALL)
    assert torch.all(m.backbone.blocks[0].filter_b1 == 0)
    w = m.backbone.blocks[0].filter_w2.detach()
    limit = (6.0 / (w.shape[0] + w.shape[1])) ** 0.5
    assert float(w.abs().max()) <= limit and float(w.std()) > 0.3 * limit
    emb = m.backbone.embedding.weight.detach()
    assert abs(float(emb.std()) - 1.0) < 0.1
    m2 = ConanModel(device="cpu", seed=3, **SMALL)
    for a, b in zip(m.parameters(), m2.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
