"""Port parity: the FGW solver against the JAX package, on the CPU.

Tolerances: ``sinkhorn_log`` and ``fgw_coupling`` plans atol 2.5e-6;
barycenter Y and C atol 1e-3; gradient w.r.t. ``Ys`` rtol 1e-4 in norm.
The JAX reference is its XLA solver; one tiny case also runs the Pallas
kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.ops.fgw.barycenter import FGWConfig as JFGWConfig
from conan_fgw_tpu.ops.fgw.barycenter import fgw_barycenter_batch as j_bary
from conan_fgw_tpu.ops.fgw.barycenter import normalize_minmax as j_minmax
from conan_fgw_tpu.ops.fgw.coupling import fgw_coupling as j_coupling
from conan_fgw_tpu.ops.fgw.sinkhorn import sinkhorn_log as j_sinkhorn
from conan_fgw_tpu.ops.pallas.fgw import pallas_fgw_couplings_flat
from conan_fgw_tpu_torch.ops.cuda.fgw import fgw_couplings_flat
from conan_fgw_tpu_torch.ops.fgw.barycenter import FGWConfig, fgw_barycenter_batch
from conan_fgw_tpu_torch.ops.fgw.coupling import fgw_coupling
from conan_fgw_tpu_torch.ops.fgw.sinkhorn import sinkhorn_log

T_ATOL = 2.5e-6
BARY_ATOL = 1e-3
GRAD_RTOL = 1e-4
KW = dict(alpha=0.1, epsilon=0.1, pgd_iters=5, pgd_tol=1e-4, sinkhorn_iters=5, sinkhorn_thr=1e-2)


def _solves(s=6, n=12, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    Y0 = rng.random((s, n, 4)).astype(np.float32)
    Ys = rng.random((s, n, 4)).astype(np.float32) + 0.1
    Ms = ((Y0[:, :, None, :] - Ys[:, None, :, :]) ** 2).sum(-1).astype(np.float32)
    C1 = (rng.random((s, n, n)) > 0.6).astype(np.float32)
    C2 = (rng.random((s, n, n)) > 0.6).astype(np.float32)
    ps = np.full((s, n), 1.0 / n, np.float32)
    if masked:
        ps[:, n - 3:] = 0.0
        ps /= ps.sum(-1, keepdims=True)
    qs = ps[::-1].copy()
    T0 = (ps[:, :, None] * qs[:, None, :]).astype(np.float32)
    return Ms, C1, C2, ps, qs, T0


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


@pytest.mark.parametrize("masked", [False, True])
def test_sinkhorn_matches(masked):
    Ms, _, _, ps, qs, _ = _solves(seed=1, masked=masked)
    cost = Ms * 3.0
    T_j, div_j = jax.vmap(
        lambda p, q, c: j_sinkhorn(p, q, c, 0.1, num_iters=5, return_diverged=True)
    )(jnp.asarray(ps), jnp.asarray(qs), jnp.asarray(cost))
    T_t, div_t, _ = sinkhorn_log(*_t(ps, qs, cost), 0.1, num_iters=5)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=T_ATOL)
    np.testing.assert_array_equal(div_t.numpy(), np.asarray(div_j))


def test_sinkhorn_rollback_flags_divergence():
    """A non-finite cost row rolls the solve back and flags it, as in JAX."""
    Ms, _, _, ps, qs, _ = _solves(seed=2)
    cost = Ms.copy()
    cost[0, 3, :] = np.inf
    T_j, div_j = jax.vmap(
        lambda p, q, c: j_sinkhorn(p, q, c, 0.1, num_iters=5, return_diverged=True)
    )(jnp.asarray(ps), jnp.asarray(qs), jnp.asarray(cost))
    T_t, div_t, _ = sinkhorn_log(*_t(ps, qs, cost), 0.1, num_iters=5)
    np.testing.assert_array_equal(div_t.numpy(), np.asarray(div_j))
    assert bool(div_t[0]) and not bool(div_t[1:].any())
    np.testing.assert_allclose(T_t.numpy()[1:], np.asarray(T_j)[1:], atol=T_ATOL)


@pytest.mark.parametrize("masked", [False, True])
def test_fgw_coupling_matches(masked):
    Ms, C1, C2, ps, qs, T0 = _solves(seed=3, masked=masked)
    T_j, div_j = jax.vmap(
        lambda M, a, b, p, q, t0: j_coupling(M, a, b, p, q, t0, return_diverged=True, **KW)
    )(*map(jnp.asarray, (Ms, C1, C2, ps, qs, T0)))
    T_t, div_t, _ = fgw_coupling(*_t(Ms, C1, C2, ps, qs, T0), **KW)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=T_ATOL)
    np.testing.assert_array_equal(div_t.numpy(), np.asarray(div_j))


def test_couplings_flat_plain_matches_pallas_interpret():
    """The kernel's plain version against the Pallas kernel (interpret mode)."""
    Ms, C1, C2, ps, qs, T0 = _solves(s=2, n=8, seed=4)
    T_p, div_p = pallas_fgw_couplings_flat(*map(jnp.asarray, (Ms, C1, C2, ps, qs, T0)),
                                           interpret=True, **KW)
    T_t, (div_t, _) = fgw_couplings_flat(*_t(Ms, C1, C2, ps, qs, T0), **KW)
    assert div_t.dtype == torch.int32
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_p), atol=T_ATOL)
    np.testing.assert_array_equal(div_t.numpy(), np.asarray(div_p))


def test_normalize_minmax_per_matrix():
    """The model's rescale (``models/heads.py``) takes each trailing matrix,
    as the JAX model's vmapped call does (rtol 1e-6: the same few f32
    operations)."""
    from conan_fgw_tpu_torch.models.heads import _minmax_per_matrix

    x = np.random.default_rng(6).standard_normal((2, 3, 5, 4)).astype(np.float32)
    y_j = jax.vmap(jax.vmap(lambda m: j_minmax(m, 0.1, 2.0, eps=1e-12)))(jnp.asarray(x))
    y_t = _minmax_per_matrix(torch.from_numpy(x), 0.1, 2.0, eps=1e-12)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6)


def _bary_problem(B=3, K=3, N=12, D=5, seed=5):
    # the JAX package's own barycenter test problem: features in [0.1, 1.1],
    # symmetric 0/1 structure. Steeper features (e.g. [0.1, 2] at D=5) make
    # the 5-step outer loop amplify f32 rounding ~1e3-fold in JAX itself.
    rng = np.random.default_rng(seed)
    Ys = (rng.random((B, K, N, D)) + 0.1).astype(np.float32)
    Cs = (rng.random((B, K, N, N)) > 0.6).astype(np.float32)
    Cs = np.maximum(Cs, Cs.transpose(0, 1, 3, 2))
    R = rng.standard_normal((B, N, D)).astype(np.float32)
    return Ys, Cs, R


@pytest.mark.parametrize("masked", [False, True])
def test_barycenter_values_and_grad(masked):
    Ys, Cs, R = _bary_problem()
    B, K, N, _ = Ys.shape
    if masked:
        am = np.ones((B, N), np.float32)
        am[0, N - 3:] = 0.0
        p = am / am.sum(-1, keepdims=True)
        ps = np.broadcast_to(p[:, None], (B, K, N)).copy()
    else:
        p = ps = None

    def jloss(ys):
        Y, C, n = j_bary(ys, jnp.asarray(Cs), ps=None if ps is None else jnp.asarray(ps),
                         p=None if p is None else jnp.asarray(p), config=JFGWConfig(),
                         return_diverged=True)
        return jnp.sum(Y * jnp.asarray(R)), (Y, C, n)

    (_, (Y_j, C_j, n_j)), g_j = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(Ys))
    Ys_t = torch.from_numpy(Ys).requires_grad_(True)
    Y_t, C_t, (n_t, _) = fgw_barycenter_batch(
        Ys_t, torch.from_numpy(Cs), ps=None if ps is None else torch.from_numpy(ps),
        p=None if p is None else torch.from_numpy(p), config=FGWConfig(),
    )
    (Y_t * torch.from_numpy(R)).sum().backward()
    np.testing.assert_allclose(Y_t.detach().numpy(), np.asarray(Y_j), atol=BARY_ATOL)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), atol=BARY_ATOL)
    # the gradient is lambda diag(1/p) T_eff^T R: elementwise it carries the
    # couplings' own ~1e-6 absolute drift, so it is held in norm
    g_t, g_j = Ys_t.grad.numpy(), np.asarray(g_j)
    assert np.linalg.norm(g_t - g_j) <= GRAD_RTOL * np.linalg.norm(g_j)
    assert int(n_t) == int(n_j)


@pytest.mark.parametrize("where", ["cpu", "meta", "mixed"])
def test_kernel_refuses_what_is_not_on_the_card(where):
    """No tensor off the card reaches the kernel's launch, and the wrapper
    sends nothing but CPU tensors to the plain solver: a bad input raises."""
    from conan_fgw_tpu_torch.ops.cuda.fgw import _couplings

    args = _t(*_solves(s=2, n=32, seed=7))
    args = [t.to("meta" if where == "meta" or (where == "mixed" and i == 2) else "cpu")
            for i, t in enumerate(args)]
    with pytest.raises(ValueError, match="fgw kernel"):
        _couplings(*args, **KW)
    if where != "cpu":
        with pytest.raises(ValueError, match="unsupported device"):
            fgw_couplings_flat(*args, **KW)
