"""Port parity: graph primitives, radial bases and the data layer against the
JAX package, on the CPU. Tolerance for the ops: rtol 1e-5."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.data import synthetic as jsyn
from conan_fgw_tpu.data.packing import pack_batch as jpack
from conan_fgw_tpu.ops import graph as jgraph
from conan_fgw_tpu.ops import rbf as jrbf
from conan_fgw_tpu_torch.data import synthetic as tsyn
from conan_fgw_tpu_torch.data.loader import bucketed_batches
from conan_fgw_tpu_torch.data.packing import pack_batch as tpack
from conan_fgw_tpu_torch.ops import graph as tgraph
from conan_fgw_tpu_torch.ops import rbf as trbf

RTOL = 1e-5


def _pos(seed=0, g=3, n=20):
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((g, n, 3)) * 2.5).astype(np.float32)
    mask = np.ones((g, n), bool)
    mask[:, n - 4:] = False
    pos[:, n - 4:] += 1e4
    return pos, mask


def test_pairwise_distances():
    pos, _ = _pos()
    d_j = np.asarray(jgraph.pairwise_distances(jnp.asarray(pos)))
    d_t = tgraph.pairwise_distances(torch.from_numpy(pos)).numpy()
    # the Gram form loses ~sqrt(eps * |x|^2) near the diagonal; compare
    # off-diagonal entries of the real atoms at rtol, the rest absolutely
    real = ~np.eye(pos.shape[1], dtype=bool)
    np.testing.assert_allclose(d_t[:, :16, :16][:, real[:16, :16]],
                               d_j[:, :16, :16][:, real[:16, :16]], rtol=RTOL)


@pytest.mark.parametrize("cap", [None, 4, 32])
def test_radius_graph_mask(cap):
    pos, mask = _pos(1)
    dist = np.asarray(jgraph.pairwise_distances(jnp.asarray(pos)))
    nbr_j = np.asarray(jgraph.radius_graph_mask(jnp.asarray(dist), jnp.asarray(mask), 4.0, cap))
    nbr_t = tgraph.radius_graph_mask(torch.from_numpy(dist.copy()), torch.from_numpy(mask), 4.0, cap)
    np.testing.assert_array_equal(nbr_t.numpy(), nbr_j)
    if cap == 4:
        assert (nbr_j.sum(-1) < (dist <= 4.0).sum(-1) - 1).any(), "cap never took effect"


def test_masked_sum():
    rng = np.random.default_rng(2)
    h = rng.standard_normal((3, 7, 5)).astype(np.float32)
    m = rng.random((3, 7)) > 0.3
    np.testing.assert_allclose(
        tgraph.masked_sum(torch.from_numpy(h), torch.from_numpy(m)).numpy(),
        np.asarray(jgraph.masked_sum(jnp.asarray(h), jnp.asarray(m))), rtol=RTOL, atol=1e-6,
    )


def test_rbf_cutoff_activation():
    rng = np.random.default_rng(3)
    d = (rng.random((4, 9, 9)) * 12).astype(np.float32)
    x = (rng.standard_normal((50,)) * 10).astype(np.float32)
    # the Gaussian centres come from two linspace implementations that differ
    # by one ulp; exp() turns that into ~1e-5 relative on values near 0.04,
    # so the RBF also carries an absolute 1e-6
    np.testing.assert_allclose(
        trbf.gaussian_smearing(torch.from_numpy(d), 50, 0.0, 10.0).numpy(),
        np.asarray(jrbf.gaussian_smearing(jnp.asarray(d), 50, 0.0, 10.0)), rtol=RTOL, atol=1e-6,
    )
    np.testing.assert_allclose(
        trbf.cosine_cutoff(torch.from_numpy(d), 10.0).numpy(),
        np.asarray(jrbf.cosine_cutoff(jnp.asarray(d), 10.0)), rtol=RTOL, atol=1e-7,
    )
    np.testing.assert_allclose(
        trbf.shifted_softplus(torch.from_numpy(x)).numpy(),
        np.asarray(jrbf.shifted_softplus(jnp.asarray(x))), rtol=RTOL, atol=1e-7,
    )


def test_random_dataset_bit_identical():
    a = jsyn.random_dataset(17, 5, num_conformers=3, heavy_range=(4, 9))
    b = tsyn.random_dataset(17, 5, num_conformers=3, heavy_range=(4, 9), device="cpu")
    for ra, rb in zip(a, b):
        for f in dataclasses.fields(ra):
            va, vb = getattr(ra, f.name), getattr(rb, f.name)
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype
                np.testing.assert_array_equal(va, vb)
            else:
                assert va == vb


def test_pack_batch_matches():
    recs_t = tsyn.random_dataset(4, 3, num_conformers=2, heavy_range=(4, 7), device="cpu")
    recs_j = jsyn.random_dataset(4, 3, num_conformers=2, heavy_range=(4, 7))
    pj = jpack(recs_j, max_atoms=32, batch_size=4)
    pt = tpack(recs_t, max_atoms=32, batch_size=4)
    for f in dataclasses.fields(pj):
        np.testing.assert_array_equal(getattr(pt, f.name), getattr(pj, f.name))
    dev = pt.to("cpu")
    assert isinstance(dev.pos, torch.Tensor) and dev.pos.shape == (4, 2, 32, 3)


def test_bucketed_batches_group_by_bucket():
    recs = tsyn.random_dataset(5, 6, num_conformers=1, heavy_range=(4, 14), device="cpu")
    shapes = [pb.max_atoms for pb in bucketed_batches(recs, 4)]
    assert sorted(set(shapes)) == sorted({32 if r.num_atoms <= 32 else 64 for r in recs})
