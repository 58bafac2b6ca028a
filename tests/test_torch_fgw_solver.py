"""Port parity: the rest of the FGW solver against the JAX package, on the CPU.

The same numpy inputs, drawn from a seed, go through the JAX function (its
XLA route; the per-molecule K3 wrapper also against the Pallas kernel in
interpret mode) and through the port's counterpart. Tolerances:

- ``sinkhorn_log``'s ``check_every``, ``u0``/``v0`` and potentials, and
  ``fgw_coupling`` with ``kl_loss``, ``symmetric=False`` and ``PPA``: plans
  and potentials atol 2.5e-6 (K3's gate), diverged flags exactly;
- ``ops/cuda/fgw.py::fgw_couplings`` against ``pallas_fgw_couplings``
  (interpret mode): atol 2e-5, rtol 1e-4, as the JAX package holds its
  Pallas kernel against XLA (``tests/test_pallas_fgw.py``);
- the padded per-molecule solve against the unpadded plain solve: atol
  2.5e-6 over alpha in {0.1, 0.5, 0.9}, eps in {0.05, 0.1}, n in {11, 16,
  53}. On the card K3 leaves the padding out of the solve; padding with
  zero cost instead would be 4.25e-3 off at n = 11;
- ``fgw_barycenter`` and ``fgw_barycenter_batch`` per ``FGWConfig`` option:
  Y and C atol 1e-3 on the JAX package's well-conditioned problem (the
  barycenter amplifies f32 rounding), 5e-3 at the deep budget (see
  ``test_barycenter_deep_budget``), divergence counts exactly; gradients
  with respect to ``Ys`` rtol 1e-4 in norm;
- ``normalize_minmax``, ``masked_mean``: rtol 1e-6; ``radius_graph_mask``
  with ``cap_mode="nearest"`` or ``None``: exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.ops import fgw as jfgw
from conan_fgw_tpu.ops import graph as jgraph
from conan_fgw_tpu.ops.pallas.fgw import pallas_fgw_couplings
from conan_fgw_tpu_torch.ops import fgw as tfgw
from conan_fgw_tpu_torch.ops import graph as tgraph
from conan_fgw_tpu_torch.ops.cuda.fgw import fgw_couplings, fgw_couplings_plain

T_ATOL = 2.5e-6
PALLAS_ATOL, PALLAS_RTOL = 2e-5, 1e-4
BARY_ATOL = 1e-3
DEEP_ATOL = 5e-3
GRAD_RTOL = 1e-4
KW = dict(alpha=0.1, epsilon=0.1, pgd_iters=5, pgd_tol=1e-4, sinkhorn_iters=5, sinkhorn_thr=1e-2)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _pairs(s=4, n=10, seed=0, dense=False):
    """``s`` coupling problems: feature cost, two structures (0/1, or dense
    in (0, 1] for the KL loss), marginals and the product plan."""
    rng = np.random.default_rng(seed)
    Y0 = rng.random((s, n, 3)).astype(np.float32)
    Ys = rng.random((s, n, 3)).astype(np.float32) + 0.1
    Ms = ((Y0[:, :, None, :] - Ys[:, None, :, :]) ** 2).sum(-1).astype(np.float32)
    if dense:
        C1 = (rng.random((s, n, n)) * 0.9 + 0.1).astype(np.float32)
        C2 = (rng.random((s, n, n)) * 0.9 + 0.1).astype(np.float32)
    else:
        C1 = (rng.random((s, n, n)) > 0.6).astype(np.float32)
        C2 = (rng.random((s, n, n)) > 0.6).astype(np.float32)
    ps = np.full((s, n), 1.0 / n, np.float32)
    qs = (rng.random((s, n)) + 0.5).astype(np.float32)
    qs /= qs.sum(-1, keepdims=True)
    T0 = (ps[:, :, None] * qs[:, None, :]).astype(np.float32)
    return Ms, C1, C2, ps, qs, T0


# ------------------------------------------------------------- sinkhorn_log
@pytest.mark.parametrize("check_every,num_iters,stop_thr", [(1, 7, 5e-3), (3, 12, 1e-3),
                                                            (10, 25, 1e-4)])
def test_sinkhorn_check_every(check_every, num_iters, stop_thr):
    Ms, _, _, ps, qs, _ = _pairs(seed=1)
    cost = Ms * 3.0
    kw = dict(num_iters=num_iters, stop_thr=stop_thr, check_every=check_every)
    T_j, div_j = jax.vmap(lambda p, q, c: jfgw.sinkhorn_log(p, q, c, 0.1, return_diverged=True,
                                                            **kw))(*_j(ps, qs, cost))
    T_t, div_t = tfgw.sinkhorn_log(*_t(ps, qs, cost), 0.1, **kw)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=T_ATOL)
    np.testing.assert_array_equal(div_t.numpy(), np.asarray(div_j))


def test_sinkhorn_warm_start_and_potentials():
    """``u0``/``v0`` warm-start the potentials; ``return_potentials`` gives
    the final ones, as JAX's ``(T, (u, v), diverged)``."""
    Ms, _, _, ps, qs, _ = _pairs(seed=2)
    cost = Ms * 2.0
    rng = np.random.default_rng(3)
    u0 = (rng.standard_normal(ps.shape) * 0.3).astype(np.float32)
    v0 = (rng.standard_normal(qs.shape) * 0.3).astype(np.float32)
    T_j, (u_j, v_j), div_j = jax.vmap(
        lambda p, q, c, u, v: jfgw.sinkhorn_log(p, q, c, 0.05, num_iters=6, u0=u, v0=v,
                                                return_potentials=True, return_diverged=True)
    )(*_j(ps, qs, cost, u0, v0))
    T_t, (u_t, v_t), div_t = tfgw.sinkhorn_log(*_t(ps, qs, cost), 0.05, num_iters=6,
                                               u0=torch.from_numpy(u0), v0=torch.from_numpy(v0),
                                               return_potentials=True)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=T_ATOL)
    # potentials are logs of O(1/n) scalings: held relative to their size
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), atol=T_ATOL * 10, rtol=T_ATOL)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=T_ATOL * 10, rtol=T_ATOL)
    np.testing.assert_array_equal(div_t.numpy(), np.asarray(div_j))


# ------------------------------------------------------------- fgw_coupling
COUPLING_CASES = [
    dict(loss_fun="kl_loss"),
    dict(symmetric=False),
    dict(solver="PPA"),
    dict(loss_fun="kl_loss", symmetric=False, solver="PPA"),
    dict(symmetric=False, alpha=0.5, epsilon=0.05, pgd_iters=12, sinkhorn_iters=11),
]


@pytest.mark.parametrize("opts", COUPLING_CASES,
                         ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_fgw_coupling_options(opts):
    kw = dict(KW, **opts)
    args = _pairs(seed=4, dense=kw.get("loss_fun") == "kl_loss")
    T_j, div_j = jax.vmap(lambda *a: jfgw.fgw_coupling(*a, return_diverged=True, **kw))(*_j(*args))
    T_t, div_t = tfgw.fgw_coupling(*_t(*args), **kw)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=T_ATOL)
    np.testing.assert_array_equal(div_t.numpy(), np.asarray(div_j))


def test_fgw_coupling_gradient_matches_jax():
    """Autograd through the plain solver (the barycenter's route without
    stop-gradient) against ``jax.grad``: rtol 1e-4 in norm."""
    Ms, C1, C2, ps, qs, _ = _pairs(s=2, seed=5)
    R = np.random.default_rng(6).standard_normal(Ms.shape).astype(np.float32)
    kw = dict(KW, symmetric=False, solver="PPA")

    def jloss(M):
        T = jax.vmap(lambda m, a, b, p, q: jfgw.fgw_coupling(m, a, b, p, q, **kw))(
            M, *_j(C1, C2, ps, qs))
        return jnp.sum(T * jnp.asarray(R))

    g_j = np.asarray(jax.grad(jloss)(jnp.asarray(Ms)))
    M_t = torch.from_numpy(Ms).requires_grad_(True)
    T_t, _ = tfgw.fgw_coupling(M_t, *_t(C1, C2, ps, qs), **kw)
    (T_t * torch.from_numpy(R)).sum().backward()
    assert np.linalg.norm(M_t.grad.numpy() - g_j) <= GRAD_RTOL * np.linalg.norm(g_j)


@pytest.mark.parametrize("bad", [dict(solver="MM"), dict(loss_fun="l1_loss")])
def test_fgw_coupling_refuses_unknown_options(bad):
    args = _t(*_pairs(s=1, n=4, seed=7))
    for fn, a in ((jfgw.fgw_coupling, [jnp.asarray(x.numpy()[0]) for x in args]),
                  (tfgw.fgw_coupling, args)):
        with pytest.raises(ValueError, match="unknown"):
            fn(*a, **dict(KW, **bad))


# -------------------------------------------- the per-molecule K3 wrapper
def _molecule(k=4, n=16, d=3, seed=0):
    """``tests/test_pallas_fgw.py``'s problem: one molecule's K couplings
    against the first conformer's structure."""
    rng = np.random.default_rng(seed)
    Ys = rng.random((k, n, d)).astype(np.float32) + 0.1
    Cs = rng.random((k, n, n)).astype(np.float32)
    Cs = ((Cs + Cs.transpose(0, 2, 1)) > 1.2).astype(np.float32)
    Y0 = rng.random((n, d)).astype(np.float32)
    Ms = ((Y0[None, :, None, :] - Ys[:, None, :, :]) ** 2).sum(-1).astype(np.float32)
    p = np.full((n,), 1.0 / n, np.float32)
    qs = np.full((k, n), 1.0 / n, np.float32)
    T0 = np.einsum("i,kj->kij", p, qs).astype(np.float32)
    return Ms, Cs[0], Cs, p, qs, T0


@pytest.mark.parametrize("n", [16, 12])
def test_couplings_match_pallas_interpret(n):
    args = _molecule(n=n, seed=n)
    T_p, div_p = pallas_fgw_couplings(*_j(*args), interpret=True, **KW)
    T_t, div_t = fgw_couplings(*_t(*args), **KW)
    assert T_t.shape == (4, n, n) and div_t.dtype == torch.int32 and div_t.dim() == 0
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_p), atol=PALLAS_ATOL, rtol=PALLAS_RTOL)
    assert int(div_t) == int(div_p)


@pytest.mark.parametrize("n", [11, 16, 53])
@pytest.mark.parametrize("alpha", [0.1, 0.5, 0.9])
@pytest.mark.parametrize("epsilon", [0.05, 0.1])
def test_padded_solve_is_the_unpadded_solve(n, alpha, epsilon):
    """``fgw_couplings`` pads n to a multiple of 32 (zero structure, mass
    and plan) and solves with the padding left out; the plan equals the
    unpadded plain solve, and is zero on the padding of the padded call."""
    Ms, Cb, Cs, p, qs, T0 = _t(*_molecule(k=5, n=n, seed=100 + n))
    kw = dict(KW, alpha=alpha, epsilon=epsilon)
    T_ref, div_ref = tfgw.fgw_coupling(Ms, Cb.expand(5, n, n), Cs, p.expand(5, n), qs, T0, **kw)
    T, count = fgw_couplings(Ms, Cb, Cs, p, qs, T0, **kw)
    np.testing.assert_allclose(T.numpy(), T_ref.numpy(), atol=T_ATOL)
    assert int(count) == int(div_ref.sum())
    N = n + (-n % 32)
    pad = lambda x: torch.nn.functional.pad(x, (0, N - n) if x.dim() == 2 else (0, N - n, 0, N - n))  # noqa: E731
    T_pad, _ = fgw_couplings_plain(pad(Ms), pad(Cb.expand(5, n, n)), pad(Cs), pad(p.expand(5, n)),
                                   pad(qs), pad(T0), n=n, **kw)
    assert not T_pad[:, n:].any() and not T_pad[:, :, n:].any()


def test_couplings_refuse_more_than_the_largest_bucket():
    """Kept under its old name: the refusal is gone. n=130, above the
    largest bucket, is padded to 160 and solved; the
    plan equals the unpadded plain solve's, as at any n."""
    Ms, Cb, Cs, p, qs, T0 = _t(*_molecule(k=2, n=130, seed=9))
    T_ref, div_ref = tfgw.fgw_coupling(Ms, Cb.expand(2, 130, 130), Cs, p.expand(2, 130), qs, T0,
                                       **KW)
    T, count = fgw_couplings(Ms, Cb, Cs, p, qs, T0, **KW)
    assert T.shape == (2, 130, 130)
    np.testing.assert_allclose(T.numpy(), T_ref.numpy(), atol=T_ATOL)
    assert int(count) == int(div_ref.sum())


# ------------------------------------------------------------- barycenters
def _rand_problem(rng, K=4, N=10, D=3):
    """``tests/test_fgw_parity.py``'s well-conditioned problem."""
    Ys = rng.standard_normal((K, N, D)).astype(np.float32) * 0.5 + 1.0
    Cs = (rng.random((K, N, N)) < 0.3).astype(np.float32)
    Cs = np.maximum(Cs, Cs.transpose(0, 2, 1))
    for k in range(K):
        np.fill_diagonal(Cs[k], 0.0)
    ps = np.full((K, N), 1.0 / N, np.float32)
    p = np.full((N,), 1.0 / N, np.float32)
    lam = np.full((K,), 1.0 / K, np.float32)
    return Ys, Cs, ps, p, lam


def _kl_structures(Cs):
    """Strictly positive structures for the KL loss (its log structure update)."""
    return (0.1 + 0.8 * Cs).astype(np.float32)


BARY_CASES = {
    "default": (dict(), False),
    "warmstart_off_init_C": (dict(warmstart=False), True),
    "fixed_features": (dict(fixed_features=True), False),
    "fixed_structure": (dict(fixed_structure=True), False),
    "kl_loss": (dict(loss_fun="kl_loss"), False),
    "no_stop_grad": (dict(stop_grad_couplings=False), False),
}


@pytest.mark.parametrize("case", list(BARY_CASES))
def test_barycenter_matches_jax(case):
    opts, init = BARY_CASES[case]
    Ys, Cs, ps, p, lam = _rand_problem(np.random.default_rng(10))
    if opts.get("loss_fun") == "kl_loss":
        Cs = _kl_structures(Cs)
    init_C = Cs.mean(0) if init else None
    init_Y = None
    jcfg, tcfg = jfgw.FGWConfig(**opts), tfgw.FGWConfig(**opts)
    Y_j, C_j, n_j = jfgw.fgw_barycenter(*_j(Ys, Cs, ps, p, lam), jcfg,
                                        init_C=None if init_C is None else jnp.asarray(init_C),
                                        init_Y=init_Y, return_diverged=True)
    Y_t, C_t, n_t = tfgw.fgw_barycenter(*_t(Ys, Cs, ps, p, lam), tcfg,
                                        init_C=None if init_C is None else torch.from_numpy(init_C),
                                        return_diverged=True)
    np.testing.assert_allclose(Y_t.detach().numpy(), np.asarray(Y_j), atol=BARY_ATOL)
    np.testing.assert_allclose(C_t.detach().numpy(), np.asarray(C_j), atol=BARY_ATOL)
    assert int(n_t) == int(n_j)


def test_barycenter_deep_budget():
    """The deep budget of ``config/schnet/sol1k_5_bc_deep.yaml`` (15 outer x
    10 PGD x 10 Sinkhorn, eps 0.05) amplifies f32 rounding further: on this
    problem under 1e-6 input noise, JAX's own f32 solve lies up to 3.05e-3
    from a float64 solve in C and the port's up to 3.22e-3 (5 draws). Held
    at DEEP_ATOL = 5e-3 against JAX, and against the port's float64 solve."""
    opts = dict(outer_iters=15, pgd_iters=10, sinkhorn_iters=10, epsilon=0.05)
    args = _rand_problem(np.random.default_rng(10))
    Y_j, C_j = jfgw.fgw_barycenter(*_j(*args), jfgw.FGWConfig(**opts))
    Y_t, C_t = tfgw.fgw_barycenter(*_t(*args), tfgw.FGWConfig(**opts))
    Y_64, C_64 = tfgw.fgw_barycenter(*[t.double() for t in _t(*args)], tfgw.FGWConfig(**opts))
    for Y, C in ((np.asarray(Y_j), np.asarray(C_j)), (Y_64.numpy(), C_64.numpy())):
        np.testing.assert_allclose(Y_t.numpy(), Y, atol=DEEP_ATOL)
        np.testing.assert_allclose(C_t.numpy(), C, atol=DEEP_ATOL)


def test_barycenter_init_Y():
    Ys, Cs, ps, p, lam = _rand_problem(np.random.default_rng(11))
    init_Y = np.random.default_rng(12).random((10, 3)).astype(np.float32)
    cfg = dict(fixed_features=True)
    Y_j, C_j = jfgw.fgw_barycenter(*_j(Ys, Cs, ps, p, lam), jfgw.FGWConfig(**cfg),
                                   init_Y=jnp.asarray(init_Y))
    Y_t, C_t = tfgw.fgw_barycenter(*_t(Ys, Cs, ps, p, lam), tfgw.FGWConfig(**cfg),
                                   init_Y=torch.from_numpy(init_Y))
    np.testing.assert_array_equal(Y_t.numpy(), init_Y)
    np.testing.assert_allclose(Y_t.numpy(), np.asarray(Y_j), atol=BARY_ATOL)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), atol=BARY_ATOL)


def test_barycenter_zero_mass_rows():
    """Zero-mass rows (masked padding) stay finite and zero, as in JAX."""
    Ys, Cs, ps, p, lam = _rand_problem(np.random.default_rng(13))
    p[-3:] = 0.0
    p /= p.sum()
    ps = np.broadcast_to(p, ps.shape).copy()
    Y_j, C_j = jfgw.fgw_barycenter(*_j(Ys, Cs, ps, p, lam), jfgw.FGWConfig())
    Y_t, C_t = tfgw.fgw_barycenter(*_t(Ys, Cs, ps, p, lam), tfgw.FGWConfig())
    assert torch.isfinite(Y_t).all() and torch.isfinite(C_t).all()
    np.testing.assert_allclose(Y_t.numpy(), np.asarray(Y_j), atol=BARY_ATOL)
    np.testing.assert_allclose(C_t.numpy(), np.asarray(C_j), atol=BARY_ATOL)


@pytest.mark.parametrize("stop_grad", [True, False])
def test_barycenter_gradient_matches_jax(stop_grad):
    """On ``_rand_problem`` f32 rounding alone moves the gradient by 1e-4:
    JAX's own f32 gradient lies 0.8-1.2e-4 (stop-gradient) and 2.0-2.6e-4
    (through the solves) from a float64 one under 1e-6 input noise. So the
    gradient is held on the batched tests' problem (features in [0.1,
    1.1], one molecule), where both packages lie 1.2-3.3e-5 from float64."""
    Ys, Cs = (x[0] for x in _batch_problem(B=1, K=3, N=12, D=5, seed=5))
    K, N, D = Ys.shape
    ps, p = np.full((K, N), 1.0 / N, np.float32), np.full((N,), 1.0 / N, np.float32)
    lam = np.full((K,), 1.0 / K, np.float32)
    R = np.random.default_rng(15).standard_normal((N, D)).astype(np.float32)
    opts = dict(stop_grad_couplings=stop_grad)

    def jloss(ys):
        Y, _ = jfgw.fgw_barycenter(ys, *_j(Cs, ps, p, lam), jfgw.FGWConfig(**opts))
        return jnp.sum(Y * jnp.asarray(R))

    g_j = np.asarray(jax.grad(jloss)(jnp.asarray(Ys)))
    Ys_t = torch.from_numpy(Ys).requires_grad_(True)
    Y_t, _ = tfgw.fgw_barycenter(Ys_t, *_t(Cs, ps, p, lam), tfgw.FGWConfig(**opts))
    (Y_t * torch.from_numpy(R)).sum().backward()
    g_t = Ys_t.grad.numpy()
    assert np.linalg.norm(g_t - g_j) <= GRAD_RTOL * np.linalg.norm(g_j)


def _batch_problem(B=3, K=3, N=12, D=4, seed=16):
    rng = np.random.default_rng(seed)
    Ys = (rng.random((B, K, N, D)) + 0.1).astype(np.float32)
    Cs = (rng.random((B, K, N, N)) > 0.6).astype(np.float32)
    return Ys, np.maximum(Cs, Cs.transpose(0, 1, 3, 2))


@pytest.mark.parametrize("case", ["warmstart_off", "fixed_features", "kl_loss", "no_stop_grad"])
def test_barycenter_batch_matches_jax(case):
    opts = {"warmstart_off": dict(warmstart=False), "fixed_features": dict(fixed_features=True),
            "kl_loss": dict(loss_fun="kl_loss"), "no_stop_grad": dict(stop_grad_couplings=False)}[case]
    Ys, Cs = _batch_problem()
    if case == "kl_loss":
        Cs = _kl_structures(Cs)
    R = np.random.default_rng(17).standard_normal((3, 12, 4)).astype(np.float32)

    def jloss(ys):
        Y, C, n = jfgw.fgw_barycenter_batch(ys, jnp.asarray(Cs), config=jfgw.FGWConfig(**opts),
                                            return_diverged=True)
        return jnp.sum(Y * jnp.asarray(R)), (Y, C, n)

    (_, (Y_j, C_j, n_j)), g_j = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(Ys))
    Ys_t = torch.from_numpy(Ys).requires_grad_(True)
    Y_t, C_t, n_t = tfgw.fgw_barycenter_batch(Ys_t, torch.from_numpy(Cs),
                                              config=tfgw.FGWConfig(**opts))
    np.testing.assert_allclose(Y_t.detach().numpy(), np.asarray(Y_j), atol=BARY_ATOL)
    np.testing.assert_allclose(C_t.detach().numpy(), np.asarray(C_j), atol=BARY_ATOL)
    assert int(n_t) == int(n_j)
    if case != "fixed_features":  # with fixed features Y does not depend on Ys
        (Y_t * torch.from_numpy(R)).sum().backward()
        g_j = np.asarray(g_j)
        assert np.linalg.norm(Ys_t.grad.numpy() - g_j) <= GRAD_RTOL * np.linalg.norm(g_j)


@pytest.mark.parametrize("opts", [dict(), dict(loss_fun="kl_loss")], ids=["kernel", "plain"])
def test_barycenter_batch_is_per_molecule(opts):
    """The batched solver equals per-molecule calls on either route."""
    Ys, Cs = _batch_problem(seed=18)
    if opts:
        Cs = _kl_structures(Cs)
    cfg = tfgw.FGWConfig(**opts)
    Y_b, C_b, n_b = tfgw.fgw_barycenter_batch(*_t(Ys, Cs), config=cfg)
    B, K, N, _ = Ys.shape
    ps, p, lam = torch.full((K, N), 1.0 / N), torch.full((N,), 1.0 / N), torch.full((K,), 1.0 / K)
    for b in range(B):
        Y, C = tfgw.fgw_barycenter(*_t(Ys[b], Cs[b]), ps, p, lam, cfg)
        np.testing.assert_allclose(Y_b[b].detach().numpy(), Y.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(C_b[b].numpy(), C.detach().numpy(), atol=1e-6)


def test_config_matches_jax_fields():
    """The same fields and defaults as JAX's, less its TPU switch."""
    jf = {f.name: f.default for f in dataclasses.fields(jfgw.FGWConfig)}
    jf.pop("use_pallas_coupling")
    tf = {f.name: f.default for f in dataclasses.fields(tfgw.FGWConfig)}
    assert tf == jf
    assert tfgw.FGWConfig().uses_kernel()
    assert not tfgw.FGWConfig(loss_fun="kl_loss").uses_kernel()
    assert not tfgw.FGWConfig(stop_grad_couplings=False).uses_kernel()


def test_exports_match_jax():
    assert sorted(tfgw.__all__) == sorted(jfgw.__all__)
    for name in tfgw.__all__:
        assert callable(getattr(tfgw, name))


# ------------------------------------------------------ the graph helpers
def test_normalize_minmax_whole_tensor():
    x = np.random.default_rng(19).standard_normal((4, 6, 5)).astype(np.float32)
    y_j = jfgw.normalize_minmax(jnp.asarray(x), 0.1, 2.0, eps=1e-12)
    y_t = tfgw.normalize_minmax(torch.from_numpy(x), 0.1, 2.0, eps=1e-12)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=1e-6)
    assert float(y_t.min()) == pytest.approx(0.1) and float(y_t.max()) == pytest.approx(2.0)


def test_masked_mean():
    rng = np.random.default_rng(20)
    h = rng.standard_normal((3, 7, 5)).astype(np.float32)
    mask = rng.random((3, 7)) > 0.4
    mask[2] = False  # an empty molecule: divided by 1, not 0
    m_j = jgraph.masked_mean(jnp.asarray(h), jnp.asarray(mask))
    m_t = tgraph.masked_mean(*_t(h, mask))
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("cap_mode,cap", [("nearest", 4), ("nearest", None), (None, None),
                                          ("index", 4)])
def test_radius_graph_cap_modes(cap_mode, cap):
    rng = np.random.default_rng(21)
    pos = (rng.standard_normal((2, 12, 3)) * 1.5).astype(np.float32)
    mask = np.ones((2, 12), bool)
    mask[1, 9:] = False
    dist = np.array(jgraph.pairwise_distances(jnp.asarray(pos)))  # writable
    nb_j = jgraph.radius_graph_mask(jnp.asarray(dist), jnp.asarray(mask), 3.0, cap, cap_mode)
    nb_t = tgraph.radius_graph_mask(*_t(dist, mask), 3.0, cap, cap_mode)
    np.testing.assert_array_equal(nb_t.numpy(), np.asarray(nb_j))
    if cap is not None:
        assert int(nb_t.sum(-1).max()) <= cap + (cap_mode == "index")  # index: self may rank last
        assert (nb_t.sum(-1) < tgraph.radius_graph_mask(*_t(dist, mask), 3.0, None).sum(-1)).any()


def test_radius_graph_unknown_cap_mode_raises():
    """As in JAX, a cap mode other than "index" or "nearest" (None too)
    raises where the cap binds."""
    dist, mask = torch.rand(1, 6, 6), torch.ones(1, 6, dtype=torch.bool)
    for mode in (None, "farthest"):
        with pytest.raises(ValueError, match="cap_mode"):
            tgraph.radius_graph_mask(dist, mask, 10.0, 2, mode)
        with pytest.raises(ValueError, match="cap_mode"):
            jgraph.radius_graph_mask(jnp.asarray(dist.numpy()), jnp.asarray(mask.numpy()), 10.0, 2,
                                     mode)
