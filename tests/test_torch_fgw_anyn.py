"""Port parity: K3's flat path at any atom count, and the FGW demo.

``ops/cuda/fgw.py::fgw_couplings_flat`` pads an ``N`` that is no multiple
of 32 to the next one (zero structure, mass and plan) and solves the
leading ``N x N`` block, as the kernel does on the card; on the CPU the
plain version solves the same padded input. Held against the JAX package's
``pallas_fgw_couplings_flat`` in interpret mode (which takes any ``n``)
within ``tests/test_torch_fgw_solver.py``'s Pallas gate, atol 2e-5 and
rtol 1e-4, with the divergence flags equal; the batched barycenter and the
demo's two calls against the JAX package's within the barycenter's 1e-3
(its f32 rounding is amplified about 10^3-fold over the outer iterations).
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.ops.fgw.barycenter import FGWConfig as JFGWConfig
from conan_fgw_tpu.ops.fgw.barycenter import fgw_barycenter as j_bary_one
from conan_fgw_tpu.ops.fgw.barycenter import fgw_barycenter_batch as j_bary
from conan_fgw_tpu.ops.pallas.fgw import pallas_fgw_couplings_flat
from conan_fgw_tpu_torch.ops.cuda import fgw as k3
from conan_fgw_tpu_torch.ops.fgw.barycenter import FGWConfig, fgw_barycenter_batch
from test_torch_fgw import KW, _solves, _t

PALLAS_ATOL, PALLAS_RTOL = 2e-5, 1e-4
BARY_ATOL = 1e-3
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def solves_seen(monkeypatch):
    """The ``(shape, n)`` of every solve list that reaches ``_solve``."""
    seen = []
    solve = k3._solve

    def spy(args, n, count, solver):
        seen.append((tuple(args[0].shape), n))
        return solve(args, n, count, solver)

    monkeypatch.setattr(k3, "_solve", spy)
    return seen


@pytest.mark.parametrize("s,n", [(8, 22), (4, 11), (3, 53)])
def test_flat_solve_pads_any_n_and_matches_pallas(s, n, solves_seen):
    """S solves at N=22 (the demo's size), n=11 and n=53 (padded to 32 and
    64), against the Pallas kernel in interpret mode; the padded solve also
    equals the plain solve of the unpadded input bit for bit."""
    args = _solves(s=s, n=n, seed=n)
    T_p, div_p = pallas_fgw_couplings_flat(*map(jnp.asarray, args), interpret=True, **KW)
    T_t, div_t = k3.fgw_couplings_flat(*_t(*args), **KW)
    padded = -(-n // 32) * 32
    assert solves_seen == [((s, padded, padded), n)]
    assert T_t.shape == (s, n, n) and div_t.dtype == torch.int32
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_p), atol=PALLAS_ATOL, rtol=PALLAS_RTOL)
    np.testing.assert_array_equal(div_t.numpy(), np.asarray(div_p))
    T_u, div_u = k3.fgw_couplings_plain(*_t(*args), **KW)
    assert torch.equal(T_t, T_u) and torch.equal(div_t, div_u)


def test_bucket_sizes_launch_unpadded(solves_seen):
    """A multiple of 32 goes to the solve as it is (no n): the runner's
    buckets take the launch they took before."""
    k3.fgw_couplings_flat(*_t(*_solves(s=2, n=32, seed=1)), **KW)
    assert solves_seen == [((2, 32, 32), None)]


def test_flat_solve_refuses_more_than_the_largest_bucket(solves_seen):
    """Kept under its old name: the refusal is gone. n=130, above the
    largest bucket, is padded to 160 and solved (on the card by K3's global
    route); on the CPU the padded solve equals the plain
    solve of the unpadded input bit for bit."""
    args = _t(*_solves(s=1, n=130, seed=2))
    T_t, div_t = k3.fgw_couplings_flat(*args, **KW)
    assert solves_seen == [((1, 160, 160), 130)]
    T_u, div_u = k3.fgw_couplings_plain(*args, **KW)
    assert T_t.shape == (1, 130, 130) and torch.equal(T_t, T_u) and torch.equal(div_t, div_u)


def _random_graphs(B=3, K=4, N=22, D=3, seed=0):
    rng = np.random.default_rng(seed)
    Ys = (rng.standard_normal((B, K, N, D)) * 0.5 + 1).astype(np.float32)
    a = (rng.random((B, K, N, N)) < 0.3).astype(np.float32)
    return Ys, np.maximum(a, a.transpose(0, 1, 3, 2))


def test_barycenter_batch_at_n22_matches_jax(solves_seen):
    """``fgw_barycenter_batch`` at N=22 (one padded flat solve an outer
    iteration) against the JAX package's."""
    Ys, Cs = _random_graphs()
    Y_j, C_j, n_j = j_bary(jnp.asarray(Ys), jnp.asarray(Cs), config=JFGWConfig(),
                           return_diverged=True)
    Y_t, C_t, n_t = fgw_barycenter_batch(*_t(Ys, Cs), config=FGWConfig())
    assert solves_seen == [((12, 32, 32), 22)] * FGWConfig().outer_iters
    np.testing.assert_allclose(Y_t.numpy(), np.asarray(Y_j), atol=BARY_ATOL)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), atol=BARY_ATOL)
    assert int(n_t) == int(n_j)


def _demo():
    spec = importlib.util.spec_from_file_location("fgw_parity_demo_torch",
                                                  ROOT / "examples" / "fgw_parity_demo_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_demo_main_on_the_cpu_matches_the_jax_demo_calls(tmp_path, capsys):
    """The demo's ``main`` on ``--device cpu`` at B=4 runs the random-graph
    branch (no fixture), and its two results equal the JAX demo's two calls
    (``fgw_barycenter`` of the K=10 graphs, ``fgw_barycenter_batch`` of B
    copies) on the same graphs."""
    demo = _demo()
    out = demo.main(["--device", "cpu", "--batch", "4", "--repeats", "1",
                     "--fixture", str(tmp_path / "missing.pt")])
    printed = capsys.readouterr().out
    assert "using random graphs" in printed and "4 simultaneous solves" in printed
    Ys, Cs, ps, lam, ref = demo.load_problem(str(tmp_path / "missing.pt"))
    assert ref is None and Ys.shape == (10, 22, 3)
    N = Ys.shape[1]
    p = np.full((N,), 1.0 / N, np.float32)
    cfg = JFGWConfig()
    Y_j, C_j = j_bary_one(*map(jnp.asarray, (Ys, Cs, ps, p, lam)), cfg)
    Yb_j = j_bary(jnp.broadcast_to(jnp.asarray(Ys), (4, *Ys.shape)),
                  jnp.broadcast_to(jnp.asarray(Cs), (4, *Cs.shape)), config=cfg)[0]
    np.testing.assert_allclose(out["Y"].numpy(), np.asarray(Y_j), atol=BARY_ATOL)
    np.testing.assert_allclose(out["C"].numpy(), np.asarray(C_j), atol=BARY_ATOL)
    assert out["Y_batch"].shape == (4, N, 3)
    np.testing.assert_allclose(out["Y_batch"].numpy(), np.asarray(Yb_j), atol=BARY_ATOL)
    assert out["batch"] == 4 and out["single_ms"] > 0 and out["batch_ms"] > 0


def test_demo_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        _demo().main(["--batch", "1"])
