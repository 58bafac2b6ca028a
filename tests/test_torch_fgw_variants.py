"""Port parity: the seven alternative OT/FGW solvers of ``ops/fgw/variants.py``
against the JAX package's, on the CPU, at ``tests/test_fgw_variants.py``'s
sizes (a 9 x 9 cost; N = 8 couplings; K = 3, N = 8, D = 4 barycenters).

Tolerances: plans, couplings and barycenters atol 1e-6 (values of about
1/81; the same f32 operations, a few in another order: the measured
distances are 7e-9 to 3e-8). ``greenkhorn`` rescales the argmax row or
column at each step, so where two gains tied within rounding the packages
could pick differently and walk different paths to the same fixed point;
on these problems no pick flips, and its plans are held at 1e-6 too, with
its marginals at ``tests/test_fgw_variants.py``'s 2e-3 after 3000 steps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.ops.fgw import variants as jv
from conan_fgw_tpu_torch.ops.fgw import variants as tv

PLAN_ATOL = 1e-6
FGW_ATOL = 1e-6
MARGINAL_ATOL = 2e-3


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ot(seed=0, uniform=False):
    """A 9 x 9 cost, uniform source mass and (unless ``uniform``, the JAX
    test's problem) uneven target mass."""
    rng = np.random.default_rng(seed)
    cost = (rng.random((9, 9)) * 2).astype(np.float32)
    p = np.full((9,), 1.0 / 9, np.float32)
    if uniform:
        return p, p.copy(), cost
    q = (rng.random(9) + 0.5).astype(np.float32)
    return p, q / q.sum(), cost


def _fgw(seed=1, N=8):
    rng = np.random.default_rng(seed)
    M = rng.random((N, N)).astype(np.float32)
    A = (rng.random((N, N)) < 0.4).astype(np.float32)
    B = (rng.random((N, N)) < 0.4).astype(np.float32)
    p = np.full((N,), 1.0 / N, np.float32)
    return M, A, B, p, p.copy()


def _both(j_fn, t_fn, args, **kw):
    """Arrays to each package's tensors; a Python float (epsilon) as it is."""
    arr = lambda a: isinstance(a, np.ndarray)  # noqa: E731
    out_j = j_fn(*[jnp.asarray(a) if arr(a) else a for a in args], **kw)
    out_t = t_fn(*[torch.from_numpy(a) if arr(a) else a for a in args], **kw)
    return out_j, out_t


@pytest.mark.parametrize("name,kw", [
    ("sinkhorn_knopp", {}),
    ("sinkhorn_knopp", {"stop_thr": 0.0}),
    ("sinkhorn_knopp", {"num_iters": 300, "stop_thr": 1e-5}),
    ("sinkhorn_stabilized", {}),
    ("sinkhorn_stabilized", {"tau": 5.0, "num_iters": 60}),  # absorbs on most steps
    ("sinkhorn_epsilon_scaling", {"num_iters": 400}),
    ("sinkhorn_epsilon_scaling", {"num_iters": 50, "num_outer": 4, "eps0": 3.0}),
])
def test_scaling_solvers_match_jax(name, kw):
    p, q, cost = _ot()
    T_j, T_t = _both(getattr(jv, name), getattr(tv, name), (p, q, cost, 0.1), **kw)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=PLAN_ATOL)


@pytest.mark.parametrize("num_iters", [50, 3000])
def test_greenkhorn_matches_jax(num_iters):
    p, q, cost = _ot()
    T_j, T_t = _both(jv.greenkhorn, tv.greenkhorn, (p, q, cost, 0.1), num_iters=num_iters)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=PLAN_ATOL)
    if num_iters == 3000:
        np.testing.assert_allclose(T_t.sum(1).numpy(), p, atol=MARGINAL_ATOL)
        np.testing.assert_allclose(T_t.sum(0).numpy(), q, atol=MARGINAL_ATOL)


@pytest.mark.parametrize("kw", [dict(alpha=0.3, rho=0.1, num_iters=40),
                                dict(alpha=0.5, rho=0.5, num_iters=100)])
def test_bapg_coupling_matches_jax(kw):
    args = _fgw()
    T_j, T_t = _both(jv.fgw_coupling_bapg, tv.fgw_coupling_bapg, args, **kw)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=FGW_ATOL)


@pytest.mark.parametrize("marginal_loss", [False, True])
def test_bregman_coupling_matches_jax(marginal_loss):
    args = _fgw(seed=2)
    T_j, T_t = _both(jv.fgw_coupling_bregman, tv.fgw_coupling_bregman, args, alpha=0.5,
                     epsilon=0.5, num_iters=50, marginal_loss=marginal_loss)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=FGW_ATOL)


def test_warm_started_couplings_match_jax():
    M, A, B, p, q = _fgw(seed=3)
    T0 = np.outer(p, q).astype(np.float32) * 0.5 + np.eye(8, dtype=np.float32) / 16
    for jf, tf, kw in ((jv.fgw_coupling_bapg, tv.fgw_coupling_bapg, dict(num_iters=30)),
                       (jv.fgw_coupling_bregman, tv.fgw_coupling_bregman,
                        dict(epsilon=0.5, num_iters=30))):
        T_j, T_t = _both(jf, tf, (M, A, B, p, q, T0), **kw)
        np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=FGW_ATOL)


def test_bapg_barycenter_matches_jax():
    rng = np.random.default_rng(2)
    K, N, D = 3, 8, 4
    Ys = rng.random((K, N, D)).astype(np.float32)
    Cs = (rng.random((K, N, N)) < 0.4).astype(np.float32)
    Cs = np.maximum(Cs, Cs.transpose(0, 2, 1))
    p = np.full((N,), 1.0 / N, np.float32)
    ps = np.full((K, N), 1.0 / N, np.float32)
    lam = np.full((K,), 1.0 / K, np.float32)
    kw = dict(alpha=0.5, rho=1.0, outer_iters=3, coupling_iters=30)
    (Y_j, C_j), (Y_t, C_t) = _both(jv.fgw_barycenter_bapg, tv.fgw_barycenter_bapg,
                                   (Ys, Cs, ps, p, lam), **kw)
    np.testing.assert_allclose(Y_t.numpy(), np.asarray(Y_j), atol=FGW_ATOL)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), atol=FGW_ATOL)


def test_bapg_barycenter_gradient_reaches_features():
    """Only the last feature update carries gradient: dY/dYs through it."""
    rng = np.random.default_rng(4)
    K, N, D = 3, 8, 4
    Ys = torch.from_numpy(rng.random((K, N, D)).astype(np.float32)).requires_grad_(True)
    Cs = torch.from_numpy((rng.random((K, N, N)) < 0.4).astype(np.float32))
    p, ps, lam = torch.full((N,), 1.0 / N), torch.full((K, N), 1.0 / N), torch.full((K,), 1.0 / K)
    Y, C = tv.fgw_barycenter_bapg(Ys, Cs, ps, p, lam, outer_iters=2, coupling_iters=10)
    Y.sum().backward()
    assert Ys.grad is not None and torch.isfinite(Ys.grad).all() and Ys.grad.abs().sum() > 0
    assert not C.requires_grad


def test_variants_match_jax_names():
    names = ("sinkhorn_knopp", "sinkhorn_stabilized", "sinkhorn_epsilon_scaling", "greenkhorn",
             "fgw_coupling_bapg", "fgw_coupling_bregman", "fgw_barycenter_bapg")
    for name in names:
        assert callable(getattr(jv, name)) and callable(getattr(tv, name))
