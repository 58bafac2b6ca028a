"""The traffic generator: deterministic per seed, the same sizes for every
seed, the stated bucket shares and labels, valences kept, and the batching
rule the harness states equal to the program's loader."""

import collections
from statistics import NormalDist

import numpy as np
import pytest

from perfbench import core, traffic


@pytest.fixture(scope="module")
def esol():
    return core.traffic("esol")


def small(t, molecules):
    return dict(t, molecules=molecules)


def test_same_seed_same_molecules_other_seed_same_sizes(esol):
    t = small(esol, 40)
    a, b = traffic.generate(t, 2**31 + 11, 3), traffic.generate(t, 2**31 + 11, 3)
    c = traffic.generate(t, 7, 3)
    for x, y in zip(a, b):
        for f in ("z", "pos", "x2d", "bonds", "bond_attr"):
            assert np.array_equal(getattr(x, f), getattr(y, f))
        assert x.y == y.y
    assert sorted(m.n for m in a) == sorted(m.n for m in c) == sorted(traffic.sizes(t))
    assert any(not np.array_equal(x.pos, y.pos) for x, y in zip(a, c) if x.n == y.n)
    # every seed meets the buckets in one order, the smallest first
    for mols in (a, c):
        b = [traffic.bucket_of(m.n) for m in mols]
        assert b == sorted(b)


def test_lognormal_fits_its_published_mean_and_largest():
    # GEOM-Drugs: 44.4 atoms on average, 181 the largest of about 430,000
    s = traffic.lognormal_sigma(44.4, 181, 430_000)
    mu = np.log(44.4) - s * s / 2
    assert np.exp(mu + s * s / 2) == pytest.approx(44.4)
    z = (np.log(181) - mu) / s
    assert z == pytest.approx(NormalDist().inv_cdf(1 - 1 / 430_000))
    draws = traffic.lognormal_draws(np.random.default_rng(0), {"mean": 44.4, "largest": 181,
                                    "of": 430_000, "min": 1, "max": 10_000}, 20_000)
    assert np.mean(draws) == pytest.approx(44.4, rel=0.01)


def bucket_steps(sizes, batch):
    return collections.Counter(N for N, _ in traffic.epoch_batches(
        [traffic.Molecule(np.zeros(n), None, None, None, None, 0.0) for n in sizes], batch))


def test_esol_sizes_and_bucket_shares(esol):
    sizes = traffic.sizes(esol)
    assert len(sizes) == 902 and min(sizes) >= 2 and max(sizes) <= 96
    heavy = [traffic.original_size(np.random.default_rng(k), h) for k, h in
             enumerate(traffic.lognormal_draws(np.random.default_rng(1), esol["sizes"], 4000))]
    assert np.mean(heavy) == pytest.approx(np.mean(sizes), rel=0.05)
    steps = bucket_steps(sizes, 24)
    assert set(steps) == {32, 64, 96}
    # the heavier buckets hold more than 5% of the steps: the p95 falls among them
    assert (steps[64] + steps[96]) / sum(steps.values()) > 0.05


def test_cov2_sizes_bucket_shares_and_actives():
    t = core.traffic("cov2")
    sizes = traffic.sizes(t)
    assert len(sizes) == 640 and max(sizes) <= 128
    assert np.mean(sizes) == pytest.approx(44.4, rel=0.05)
    steps = bucket_steps(sizes, 18)
    assert set(steps) == {32, 64, 96, 128}
    assert (steps[96] + steps[128]) / sum(steps.values()) > 0.05
    mols = traffic.generate(small(t, 30), 5, 2)
    assert sum(m.y for m in mols) == 3 and {m.y for m in mols} == {0.0, 1.0}


def test_valences_and_features(esol):
    valence = {6: 4, 7: 3, 8: 2, 9: 1, 1: 1}
    for m in traffic.generate(small(esol, 30), 3, 2):
        deg = np.bincount(m.bonds.ravel(), minlength=m.n)
        assert all(deg[i] == valence[int(z)] for i, z in enumerate(m.z))
        assert m.pos.shape == (2, m.n, 3) and m.pos.dtype == np.float32
        assert np.array_equal(m.x2d[:, 0], m.z) and np.array_equal(m.x2d[:, 2], deg)
        heavy = m.z != 1
        hs = [int(sum(m.z[j] == 1 for j in m.bonds[(m.bonds == i).any(1)].ravel() if j != i))
              for i in range(m.n)]
        assert np.array_equal(m.x2d[:, 4], np.where(heavy, hs, 0))
        # one bond between heavy atoms more than a tree needs at most (a ring)
        assert len(m.bonds) - (m.n - 1) in (0, 1)


def test_relaxed_bonds_near_their_length(esol):
    for m in traffic.generate(small(esol, 10), 9, 1):
        d = np.linalg.norm(m.pos[0, m.bonds[:, 0]] - m.pos[0, m.bonds[:, 1]], axis=1)
        assert 0.8 < np.median(d) < 2.2


def test_batching_rule_is_the_programs(esol):
    from conan_fgw_tpu_torch.data.loader import bucketed_batches
    from conan_fgw_tpu_torch.data.packing import MoleculeRecord, pack_batch
    from conan_fgw_tpu_torch.train.loop import bucket_boundaries, dataset_max_atoms

    mols = traffic.generate(small(esol, 60), 21, 2)
    records = [MoleculeRecord(z=m.z, pos=m.pos, x2d=m.x2d, bonds=m.bonds, bond_attr=m.bond_attr,
                              y=m.y) for m in mols]
    top = dataset_max_atoms(records)
    got = [(pb.max_atoms, pb.y[pb.mol_mask].tolist()) for pb in
           bucketed_batches(records, 8, bucket_boundaries(top), pack=pack_batch)]
    want = [(N, [np.float32(mols[i].y).item() for i in idx])
            for N, idx in traffic.epoch_batches(mols, 8)]
    assert got == want
