"""K3's cluster route (129-256 atoms) on the CPU: its decomposition and its
choice by N.

On the card a solve of N = 160 .. 256 runs on a thread-block cluster of
N / R CTAs (``csrc/fgw.cu::fgw_couplings_cluster_kernel``), each owning a
band of R rows; the column reductions and the freeze checks combine band
partials in rank order. ``ops/cuda/fgw.py::fgw_couplings_banded`` is that
decomposition in plain PyTorch. Here it is held

- against the JAX flat solver (``pallas_fgw_couplings_flat`` in interpret
  mode) at n = 160, atol 2.5e-6 (K3's gate on the card), flags equal;
- against the port's plain solver (``fgw_couplings_plain``) at N = 192 with
  clusters of 3 and 6 CTAs, at n = 181 padded to 192, with a NaN planted in
  one T0 (that solve diverges and keeps its T0) and with solves that
  freeze early (in Sinkhorn, or at the first PGD check);

and ``route(N)`` is held to the four routes: the templates up to 128, the
cluster route at every multiple of 32 up to ``LARGEST_CLUSTER`` (R a
multiple of 32, at most 16 CTAs, C R = N), the stream route up to
``LARGEST_STREAM`` (at the next size of its table), the global route above
it (a team of C = ceil(N / R) CTAs with bands of R, a multiple of 64 rows,
the last one short; ``tests/test_torch_fgw_team.py`` holds its plan).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.ops.pallas.fgw import pallas_fgw_couplings_flat
from conan_fgw_tpu_torch.ops.cuda import fgw as k3
from test_torch_fgw import KW, _solves, _t

FGW_ATOL = 2.5e-6


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(args, rows, n=None, **kw):
    """The banded and the plain solve of the same input."""
    solver = dict(KW, **kw)
    T_b, div_b = k3.fgw_couplings_banded(*args, rows=rows, n=n, **solver)
    T_p, (div_p, _) = k3.fgw_couplings_plain(*args, n=n, **solver)
    return T_b, div_b, T_p, div_p


def test_banded_matches_jax_at_n160():
    args = _solves(s=2, n=160, seed=160)
    T_j, div_j = pallas_fgw_couplings_flat(*map(jnp.asarray, args), interpret=True, **KW)
    T_b, div_b = k3.fgw_couplings_banded(*_t(*args), rows=k3.route(160).rows, **KW)
    np.testing.assert_allclose(T_b.numpy(), np.asarray(T_j), atol=FGW_ATOL, rtol=0)
    np.testing.assert_array_equal(div_b.numpy(), np.asarray(div_j))


@pytest.mark.parametrize("ctas", [3, 6])
def test_banded_matches_plain_at_n192(ctas):
    T_b, div_b, T_p, div_p = _both(_t(*_solves(s=2, n=192, seed=192)), rows=192 // ctas)
    np.testing.assert_allclose(T_b.numpy(), T_p.numpy(), atol=FGW_ATOL, rtol=0)
    np.testing.assert_array_equal(div_b.numpy(), div_p.numpy())


def test_banded_matches_plain_at_n181_padded():
    """n = 181 real atoms in a bucket of 192: the last band holds 21 real
    rows and 11 of padding, and the padding takes no mass."""
    x = _solves(s=2, n=181, seed=181)
    padded = [np.pad(a, [(0, 0)] + [(0, 11)] * (a.ndim - 1)) for a in x]
    T_b, div_b, T_p, div_p = _both(_t(*padded), rows=32, n=181)
    assert T_b.shape == (2, 192, 192)
    assert float(T_b[:, 181:].abs().max()) == 0.0 and float(T_b[:, :, 181:].abs().max()) == 0.0
    np.testing.assert_allclose(T_b.numpy(), T_p.numpy(), atol=FGW_ATOL, rtol=0)
    np.testing.assert_array_equal(div_b.numpy(), div_p.numpy())


def test_banded_nan_in_t0_diverges_and_rolls_back():
    """A NaN in solve 0's T0 makes all of its mr NaN: the solve is flagged
    as diverged and keeps T0; solve 1 is untouched."""
    args = _t(*_solves(s=2, n=192, seed=7))
    T0 = args[5].clone()
    T0[0, 100, 7] = float("nan")
    args[5] = T0
    T_b, div_b, T_p, div_p = _both(args, rows=32)
    assert div_b.tolist() == [1, 0] and div_p.tolist() == [1, 0]
    assert torch.equal(T_b.isnan(), T_p.isnan())
    assert torch.equal(T_b[0].nan_to_num(-1.0), T0[0].nan_to_num(-1.0))
    np.testing.assert_allclose(T_b[1].numpy(), T_p[1].numpy(), atol=FGW_ATOL, rtol=0)


@pytest.mark.parametrize("kw", [dict(sinkhorn_thr=10.0), dict(pgd_tol=10.0)],
                         ids=["sinkhorn", "pgd"])
def test_banded_early_freeze_matches_plain(kw):
    """Solves that freeze at their first check: in every Sinkhorn loop
    (marginal error under the threshold) or at the first PGD step."""
    T_b, div_b, T_p, div_p = _both(_t(*_solves(s=2, n=192, seed=8)), rows=32, **kw)
    np.testing.assert_allclose(T_b.numpy(), T_p.numpy(), atol=FGW_ATOL, rtol=0)
    np.testing.assert_array_equal(div_b.numpy(), div_p.numpy())


@pytest.mark.parametrize("N", range(64, k3.LARGEST_STREAM + 64, 32))
def test_route_by_bucket_size(N):
    way = k3.route(N)
    if N <= k3.LARGEST_TEMPLATE:
        assert way == k3.Route("template", 1, N, N)
    elif N <= k3.LARGEST_CLUSTER:
        assert way.kind == "cluster" and way.size == N
        assert way.rows % 32 == 0 and way.ctas <= 16 and way.ctas * way.rows == N
    elif N <= k3.LARGEST_STREAM:
        assert way.kind == "stream" and way.size in k3.STREAM_ROWS and 0 <= way.size - N < 64
        assert way.rows % 16 == 0 and way.ctas <= 8 and way.ctas * way.rows == way.size
    else:
        assert way.kind == "global" and way.size == N and way.rows % 64 == 0
        assert way.ctas == -(-N // way.rows) and way.ctas <= k3.SMS


@pytest.mark.parametrize("N", [0, 16, 100, 181])
def test_route_refuses_other_sizes(N):
    with pytest.raises(ValueError, match="multiple of 32"):
        k3.route(N)


def test_launch_names_follow_the_route():
    assert k3.launch_name("fgw_couplings", 128) == "fgw_couplings"
    assert k3.launch_name("fgw_couplings", 160) == "fgw_couplings_cluster"
    assert k3.launch_name("fgw_couplings_mol", k3.LARGEST_CLUSTER) == "fgw_couplings_mol_cluster"
    assert k3.launch_name("fgw_couplings", k3.LARGEST_CLUSTER + 32) == "fgw_couplings_stream"
    assert k3.launch_name("fgw_couplings", k3.LARGEST_STREAM + 32) == "fgw_couplings_large"
