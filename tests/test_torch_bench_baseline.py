"""``conan_fgw_tpu_torch/bench_baseline.py`` against the JAX package's copy.

Both are plain torch on the CPU, so from the same seed they must agree bit
for bit: the radius graph, the reference-style SchNet, GAT and DimeNet
forwards, the per-molecule FGW barycenter, and the weights after
``measure_reference_style_step``'s and ``measure_reference_dimenet_step``'s
Adam steps. The measured seconds a step must be positive and finite. Small
shapes: molecules of 4-7 heavy atoms and two conformers; the forwards at
hidden 32 (SchNet) and 16 (DimeNet), the measured steps at the functions'
own hidden 128 (their GAT's width is fixed at 64, half of it)."""

import numpy as np
import pytest
import torch

from conan_fgw_tpu import bench_baseline as jbase
from conan_fgw_tpu_torch import bench_baseline as tbase
from conan_fgw_tpu_torch.data.synthetic import random_dataset


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One torch thread: the timed loops are per molecule, and the file does
    not fight other test workers for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _molecules(n: int = 2, K: int = 2, heavy=(4, 7)):
    recs = random_dataset(5, n, num_conformers=K, heavy_range=heavy, device="cpu")
    return [(r.z, r.pos, r.x2d, r.bonds, r.bond_attr, r.y) for r in recs]


def _seeded(cls, *args, **kwargs):
    torch.manual_seed(0)
    return cls(*args, **kwargs)


def _same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b)) and len(a) == len(b)


def test_radius_edges_match():
    pos = np.random.default_rng(0).normal(scale=3.0, size=(40, 3)).astype(np.float32)
    for cutoff, cap in ((10.0, 32), (4.0, 5)):
        (je, jd), (te, td) = jbase._radius_edges(pos, cutoff, cap), tbase._radius_edges(pos, cutoff, cap)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(td, jd)


def test_schnet_and_gat_forwards_match():
    z, pos, x2d, bonds, battr, _ = _molecules(1)[0]
    ei, dmat = tbase._radius_edges(pos[0])
    ew = torch.tensor(dmat[ei[0], ei[1]], dtype=torch.float32)
    ei, zt = torch.tensor(ei), torch.tensor(z, dtype=torch.long)
    js, ts = _seeded(jbase._TorchSchNetRef, hidden=32), _seeded(tbase._TorchSchNetRef, hidden=32)
    assert _same(list(ts.state_dict().values()), list(js.state_dict().values()))
    assert _same(ts(zt, ei, ew), js(zt, ei, ew))
    be = torch.tensor(np.concatenate([bonds, bonds[:, ::-1]], 0).T.copy())
    ba = torch.tensor(np.concatenate([battr, battr], 0), dtype=torch.float32)
    x = torch.tensor(x2d, dtype=torch.float32)
    jg, tg = _seeded(jbase._TorchGATRef), _seeded(tbase._TorchGATRef)
    assert torch.equal(tg(x, be, ba), jg(x, be, ba))


@pytest.mark.parametrize("fixed_structure,alpha", [(False, 0.1), (True, 0.5)])
def test_barycenter_matches(fixed_structure, alpha):
    gen = torch.Generator().manual_seed(1)
    Ys = torch.rand(3, 9, 4, generator=gen) * 1.9 + 0.1
    Cs = (torch.rand(3, 9, 9, generator=gen) > 0.5).to(torch.float32)
    jY, jC = jbase._fgw_barycenter_t(Ys, Cs, alpha=alpha, fixed_structure=fixed_structure)
    tY, tC = tbase._fgw_barycenter_t(Ys, Cs, alpha=alpha, fixed_structure=fixed_structure)
    assert torch.equal(tY, jY) and torch.equal(tC, jC)
    assert bool(torch.isfinite(tY).all())


def test_dimenet_forward_matches():
    z, pos, *_ = _molecules(1)[0]
    pos_t = torch.tensor(pos[0], dtype=torch.float32)
    jn, tn = _seeded(jbase._TorchDimeNetRef, hidden=16), _seeded(tbase._TorchDimeNetRef, hidden=16)
    jgeom = jbase._TorchDimeNetRef.prepare_geometry(pos_t, jn.cutoff, jn.radial, jn.spherical)
    tgeom = tbase._TorchDimeNetRef.prepare_geometry(pos_t, tn.cutoff, tn.radial, tn.spherical)
    assert _same(tgeom, jgeom)
    zt = torch.tensor(z, dtype=torch.long)
    jo, jb, _ = jn(zt, jgeom)
    to, tb, _ = tn(zt, tgeom)
    assert torch.equal(to, jo) and torch.equal(tb, jb)


class _Recorder:
    """Stands in for ``torch.optim.Adam`` and keeps each optimiser made."""

    made = []

    def __new__(cls, *args, **kwargs):
        opt = _ADAM(*args, **kwargs)
        cls.made.append(opt)
        return opt


_ADAM = torch.optim.Adam


@pytest.mark.parametrize("which", ["schnet", "schnet_no_barycenter", "dimenet"])
def test_adam_steps_match(monkeypatch, which):
    """The weights after the measured steps (a warm-up step and one timed
    step), the JAX copy's against the port's, bit for bit."""
    monkeypatch.setattr(torch.optim, "Adam", _Recorder)
    mols = _molecules()
    after = []
    for module in (jbase, tbase):
        _Recorder.made.clear()
        if which == "dimenet":
            module.measure_reference_dimenet_step(mols[:1], steps=1)
        else:
            module.measure_reference_style_step(mols, steps=1,
                                                use_barycenter=which == "schnet")
        (opt,) = _Recorder.made
        after.append([p.detach().clone() for g in opt.param_groups for p in g["params"]])
        assert int(opt.state[opt.param_groups[0]["params"][0]]["step"]) == 2
    assert _same(after[1], after[0])


def test_measured_step_times_are_positive_and_finite():
    mols = _molecules()
    for use_barycenter in (True, False):
        s = tbase.measure_reference_style_step(mols, steps=1,
                                               use_barycenter=use_barycenter)
        assert np.isfinite(s) and s > 0
    s = tbase.measure_reference_dimenet_step(mols[:1], steps=1)
    assert np.isfinite(s) and s > 0
