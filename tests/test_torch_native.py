"""The port's native packer (``conan_fgw_tpu_torch/native/packer.cpp``
through ``data/native.py``) against the JAX package's two packers and the
port's numpy packer, byte for byte; its errors against the JAX package's;
packing into a reused (dirty) buffer; and its build: its own library under
``conan_fgw_tpu_torch/_build``, and an error naming g++ where the build
fails, never a fallback. Small batches (B <= 8, N <= 64, K = 5) from numpy
seeds. The packer builds with g++ on the CPU, so nothing here skips."""

import dataclasses

import numpy as np
import pytest

from conan_fgw_tpu.data import native as jnative
from conan_fgw_tpu.data import packing as jpacking
from conan_fgw_tpu_torch.data import loader as tloader
from conan_fgw_tpu_torch.data import native as tnative
from conan_fgw_tpu_torch.data import packing as tpacking
from conan_fgw_tpu_torch.data.vocab import NUM_ATOM_FEATURES, NUM_BOND_FEATURES

K = 5
FIELDS = [f.name for f in dataclasses.fields(tpacking.PackedBatch)]


def molecule(rng, n, num_bonds=None, k=K):
    """A record of ``n`` atoms: a random spanning tree (``n - 1`` bonds, or
    the first ``num_bonds`` of it) with random features."""
    e = n - 1 if num_bonds is None else num_bonds
    bonds = np.asarray([(int(rng.integers(0, i)), i) for i in range(1, n)][:e],
                       np.int64).reshape(-1, 2)
    return tpacking.MoleculeRecord(
        z=rng.integers(1, 10, n).astype(np.int32),
        pos=rng.standard_normal((k, n, 3)).astype(np.float32),
        x2d=rng.integers(0, 5, (n, NUM_ATOM_FEATURES)).astype(np.int32),
        bonds=bonds,
        bond_attr=rng.integers(0, 4, (e, NUM_BOND_FEATURES)).astype(np.float32),
        y=float(rng.standard_normal()),
        mol_id=f"m{n}",
    )


def batch_records(seed, n_atoms):
    """Six molecules for an N=``n_atoms`` bucket: one of a single atom (no
    bonds), one of exactly N atoms, one with its bonds dropped, three
    random."""
    rng = np.random.default_rng(seed)
    return [molecule(rng, 1), molecule(rng, n_atoms), molecule(rng, 7, num_bonds=0),
            *(molecule(rng, int(rng.integers(2, n_atoms + 1))) for _ in range(3))]


def as_jax(records):
    return [jpacking.MoleculeRecord(**dataclasses.asdict(r)) for r in records]


def assert_same_bytes(a, b):
    for name in FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        assert (x.dtype, x.shape) == (y.dtype, y.shape), name
        assert x.tobytes() == y.tobytes(), name


@pytest.mark.parametrize("n_atoms", [32, 64])
@pytest.mark.parametrize("batch_size", [6, 8])  # B_real == B and B_real < B
def test_native_packer_matches_three_packers(n_atoms, batch_size):
    records = batch_records(n_atoms + batch_size, n_atoms)
    kw = dict(max_atoms=n_atoms, batch_size=batch_size)
    got = tnative.pack_batch_native(records, **kw)
    assert jnative.native_available()
    for other in (jnative.pack_batch_native(as_jax(records), **kw),
                  jpacking.pack_batch(as_jax(records), **kw),
                  tpacking.pack_batch(records, **kw)):
        assert_same_bytes(got, other)
    assert got.atom_mask[1].all() and got.mol_mask.sum() == 6
    assert not got.bond_adj[0].any() and not got.bond_adj[2].any()


def test_default_shapes_match_the_numpy_packer():
    """Without ``max_atoms``/``batch_size``: the covering bucket, the records' count."""
    records = batch_records(3, 40)
    assert_same_bytes(tnative.pack_batch_native(records), tpacking.pack_batch(records))
    assert tnative.pack_batch_native(records).z.shape == (6, K, 64)


@pytest.mark.parametrize("case", ["too_many_atoms", "mixed_k", "empty", "over_batch"])
def test_errors_match_the_jax_packer(case):
    rng = np.random.default_rng(5)
    records, kw = {
        "too_many_atoms": ([molecule(rng, 33)], dict(max_atoms=32)),
        "mixed_k": ([molecule(rng, 4), molecule(rng, 5, k=3)], dict(max_atoms=32)),
        "empty": ([], dict(max_atoms=32)),
        "over_batch": ([molecule(rng, 4), molecule(rng, 5)], dict(max_atoms=32, batch_size=1)),
    }[case]
    with pytest.raises(ValueError) as want:
        jnative.pack_batch_native(as_jax(records), **kw)
    with pytest.raises(ValueError) as got:
        tnative.pack_batch_native(records, **kw)
    assert str(got.value) == str(want.value)


def test_malformed_records_raise_before_the_native_call():
    rng = np.random.default_rng(6)
    bad_bond = molecule(rng, 5)
    bad_bond.bonds = bad_bond.bonds.copy()
    bad_bond.bonds[0, 1] = 5
    with pytest.raises(ValueError, match="bond index"):
        tnative.pack_batch_native([bad_bond], max_atoms=32)
    short_pos = molecule(rng, 5)
    short_pos.pos = short_pos.pos[:, :4]
    with pytest.raises(ValueError, match="disagree"):
        tnative.pack_batch_native([short_pos], max_atoms=32)


def test_out_reuses_a_dirty_buffer():
    """Every byte is written: a reused buffer full of garbage from another
    batch (and 0xAB bytes) gives the bytes of a fresh one."""
    out = tnative.empty_batch(8, K, 32)
    tnative.pack_batch_native(batch_records(1, 32), max_atoms=32, batch_size=8, out=out)
    for name in FIELDS:
        getattr(out, name)[..., :2].view(np.uint8)[...] = 0xAB
    records = batch_records(2, 32)[:5]
    got = tnative.pack_batch_native(records, max_atoms=32, batch_size=8, out=out)
    assert got is out
    assert_same_bytes(got, tpacking.pack_batch(records, max_atoms=32, batch_size=8))


def test_out_of_the_wrong_layout_raises():
    records = batch_records(1, 32)
    wrong = tnative.empty_batch(8, K, 64)
    with pytest.raises(ValueError, match="out.z"):
        tnative.pack_batch_native(records, max_atoms=32, batch_size=8, out=wrong)
    out = tnative.empty_batch(8, K, 32)
    out.bond_adj = np.empty((8, 32, 32), np.uint8)
    with pytest.raises(ValueError, match="out.bond_adj"):
        tnative.pack_batch_native(records, max_atoms=32, batch_size=8, out=out)
    out = tnative.empty_batch(8, K, 32)
    out.pos = np.empty((8, K, 3, 32), np.float32).transpose(0, 1, 3, 2)
    with pytest.raises(ValueError, match="C-contiguous"):
        tnative.pack_batch_native(records, max_atoms=32, batch_size=8, out=out)


def test_loader_pack_picks_the_packer():
    records = batch_records(4, 32)
    assert_same_bytes(tloader.pack(records, max_atoms=32, batch_size=8),
                      tloader.pack(records, native=False, max_atoms=32, batch_size=8))


def test_library_is_the_ports_own():
    """Built from the port's source into the port's build directory, named
    by a hash of source and flags; the JAX package's library is not it."""
    lib = tnative.load_library()
    path = tnative.build()
    assert lib._name == str(path)
    assert path.parent == tnative.PKG_DIR / "_build"
    assert path.name.startswith("libpacker_") and path.suffix == ".so"
    assert tnative.SOURCE == tnative.PKG_DIR / "native" / "packer.cpp"
    assert "_packer.so" not in lib._name


def test_build_without_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", "/nonexistent")
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        tnative.build()


def test_a_failed_compile_raises(monkeypatch, tmp_path):
    broken = tmp_path / "packer.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", broken)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        tnative.build()
    assert not list((tmp_path / "_build").glob("*.so"))
