"""The arithmetic of the FGW coupling kernel K3's products, emulated on the CPU.

K3 (``csrc/fgw.cu``) runs the two products of each PGD step, ``C1 T`` and
``(C1 T) (2 C2)^T``, on the tensor cores with each f32 operand split into
two TF32 parts, ``x_big = tf32(x)`` and ``x_small = tf32(x - x_big)``
(rounded to nearest, ties away), and the terms ``a_small b_big``,
``a_big b_small`` and ``a_big b_big`` summed in f32.
``ops/cuda/cfconv.py::split_mm(a, b, passes=3, drop=13)`` rounds the
operands the same way and sums the three products in another order; the
plain solver takes it as its ``mm``. At N = 32, S = 8, alpha = eps = 0.1
and 5 PGD x 5 Sinkhorn iterations, for a 0/1 and a dense C1 (the
barycenter's structure after its first update is dense):
- the split solve agrees with the plain f32 solve within 2.5e-7 and with
  the JAX package's XLA solver within ``T_ATOL`` = 2.5e-6, the kernel
  check's tolerance, with equal diverged flags;
- a single TF32 pass is at least 10x further from the f32 solve than the
  split, which is why K3 splits.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.ops.fgw.coupling import fgw_coupling as j_coupling
from conan_fgw_tpu_torch.ops.cuda.cfconv import split_mm
from conan_fgw_tpu_torch.ops.fgw.coupling import fgw_coupling

S, N, D = 8, 32, 16
T_ATOL = 2.5e-6
SPLIT_ATOL = 2.5e-7  # split against plain f32: a tenth of the kernel check's tolerance
ONE_PASS_FACTOR = 10.0
KW = dict(alpha=0.1, epsilon=0.1, pgd_iters=5, pgd_tol=1e-4, sinkhorn_iters=5, sinkhorn_thr=1e-2)
TF32_DROP = 13  # f32 keeps 23 mantissa bits, TF32 10


@functools.cache
def _problem(kind, seed=0):
    rng = np.random.default_rng(seed)
    Y0 = rng.random((S, N, D)).astype(np.float32)
    Ys = (rng.random((S, N, D)) + 0.1).astype(np.float32)
    Ms = ((Y0[:, :, None, :] - Ys[:, None, :, :]) ** 2).sum(-1).astype(np.float32)
    if kind == "binary":
        C1 = (rng.random((S, N, N)) > 0.6).astype(np.float32)
    else:
        C1 = rng.random((S, N, N)).astype(np.float32)
    C2 = (rng.random((S, N, N)) > 0.6).astype(np.float32)  # not symmetric
    ps = np.full((S, N), 1.0 / N, np.float32)
    qs = ps.copy()
    T0 = (ps[:, :, None] * qs[:, None, :]).astype(np.float32)
    return Ms, C1, C2, ps, qs, T0


@functools.cache
def _solve(kind, passes):
    """``(T, diverged)`` of the port's plain solver with its products in
    f32 (``passes=0``) or through ``split_mm`` with ``passes`` TF32 passes."""
    args = [torch.from_numpy(x) for x in _problem(kind)]
    mm = torch.matmul if passes == 0 else functools.partial(split_mm, passes=passes, drop=TF32_DROP)
    T, div, _ = fgw_coupling(*args, **KW, mm=mm)
    return T.numpy(), div.numpy()


@pytest.mark.parametrize("reference", ["plain_f32", "jax_xla"])
@pytest.mark.parametrize("kind", ["binary", "dense"])
def test_split_solve_matches(kind, reference):
    T_s, div_s = _solve(kind, 3)
    if reference == "plain_f32":
        T_r, div_r = _solve(kind, 0)
        atol = SPLIT_ATOL
    else:
        T_r, div_r = jax.vmap(
            lambda M, a, b, p, q, t0: j_coupling(M, a, b, p, q, t0, return_diverged=True, **KW)
        )(*map(jnp.asarray, _problem(kind)))
        T_r, div_r = np.asarray(T_r), np.asarray(div_r)
        atol = T_ATOL
    np.testing.assert_allclose(T_s, T_r, atol=atol, rtol=0)
    np.testing.assert_array_equal(div_s, div_r)


@pytest.mark.parametrize("kind", ["binary", "dense"])
def test_one_tf32_pass_is_ten_times_worse(kind):
    T_f32, _ = _solve(kind, 0)
    err_split = np.abs(_solve(kind, 3)[0] - T_f32).max()
    err_one = np.abs(_solve(kind, 1)[0] - T_f32).max()
    assert err_one >= ONE_PASS_FACTOR * err_split, (err_one, err_split)
    assert err_one > 0.0
