"""K3's stream route (257-512 atoms) on the CPU: its decomposition and its
choice by N.

On the card a solve of N = 288 .. 512 runs on a thread-block cluster of
N / R CTAs (``csrc/fgw.cu::fgw_couplings_stream_kernel``), each owning a
band of R rows of mr while T and C2 stream through a ring of k-slices:
product 1 sums T's k-slices from the first, and the column reductions and
the freeze checks combine band partials in rank order.
``ops/cuda/fgw.py::fgw_couplings_banded(..., streamed=True)`` is that
decomposition in plain PyTorch. Here it is held

- against the port's plain solver (``fgw_couplings_plain``) at N = 288 with
  the route's bands of 48 rows, with a NaN planted in one T0 (that solve
  diverges and keeps its T0) and with solves that freeze early;
- against the JAX flat solver (``pallas_fgw_couplings_flat`` in interpret
  mode, its path on the CPU) at n = 270 padded to 288, atol 2.5e-6 (K3's
  gate on the card), flags equal;

and the route's table: every size it runs at takes a band that divides it
(at most 8 CTAs, a portable cluster) and fits the card's shared memory by
the kernel's layout, the sizes between are padded up to the next, and the
launches count under ``_stream``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.ops.pallas.fgw import pallas_fgw_couplings_flat
from conan_fgw_tpu_torch.ops.cuda import fgw as k3
from test_torch_fgw import KW, _solves, _t

FGW_ATOL = 2.5e-6
MAX_SMEM_BYTES = 232_448  # a block's dynamic shared memory on Hopper


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(args, n=None, **kw):
    """The streamed banded and the plain solve of the same input, with the
    stream route's bands at N."""
    solver = dict(KW, **kw)
    rows = k3.route(args[0].shape[-1]).rows
    T_b, div_b = k3.fgw_couplings_banded(*args, rows=rows, n=n, streamed=True, **solver)
    T_p, (div_p, _) = k3.fgw_couplings_plain(*args, n=n, **solver)
    return T_b, div_b, T_p, div_p


def _padded(x, pad):
    return [np.pad(a, [(0, 0)] + [(0, pad)] * (a.ndim - 1)) for a in x]


def test_streamed_matches_plain_at_n288():
    T_b, div_b, T_p, div_p = _both(_t(*_solves(s=2, n=288, seed=288)))
    assert k3.route(288).rows == 48
    np.testing.assert_allclose(T_b.numpy(), T_p.numpy(), atol=FGW_ATOL, rtol=0)
    np.testing.assert_array_equal(div_b.numpy(), div_p.numpy())


def test_streamed_matches_jax_at_n270_padded():
    """n = 270 real atoms in a bucket of 288: the last band of 48 rows holds
    30 real rows and 18 of padding, which take no mass."""
    args = _solves(s=2, n=270, seed=270)
    T_j, div_j = pallas_fgw_couplings_flat(*map(jnp.asarray, args), interpret=True, **KW)
    T_b, div_b = k3.fgw_couplings_banded(*_t(*_padded(args, 18)), rows=k3.route(288).rows, n=270,
                                         streamed=True, **KW)
    assert T_b.shape == (2, 288, 288)
    assert float(T_b[:, 270:].abs().max()) == 0.0 and float(T_b[:, :, 270:].abs().max()) == 0.0
    np.testing.assert_allclose(T_b[:, :270, :270].numpy(), np.asarray(T_j), atol=FGW_ATOL, rtol=0)
    np.testing.assert_array_equal(div_b.numpy(), np.asarray(div_j))


def test_streamed_nan_in_t0_diverges_and_rolls_back():
    """A NaN in solve 0's T0 makes all of its mr NaN: the solve is flagged
    as diverged and keeps T0; solve 1 is untouched."""
    args = _t(*_solves(s=2, n=288, seed=9))
    T0 = args[5].clone()
    T0[0, 200, 7] = float("nan")
    args[5] = T0
    T_b, div_b, T_p, div_p = _both(args)
    assert div_b.tolist() == [1, 0] and div_p.tolist() == [1, 0]
    assert torch.equal(T_b.isnan(), T_p.isnan())
    assert torch.equal(T_b[0].nan_to_num(-1.0), T0[0].nan_to_num(-1.0))
    np.testing.assert_allclose(T_b[1].numpy(), T_p[1].numpy(), atol=FGW_ATOL, rtol=0)


@pytest.mark.parametrize("kw", [dict(sinkhorn_thr=10.0), dict(pgd_tol=10.0)],
                         ids=["sinkhorn", "pgd"])
def test_streamed_early_freeze_matches_plain(kw):
    """Solves that freeze at their first check: in every Sinkhorn loop
    (marginal error under the threshold) or at the first PGD step."""
    T_b, div_b, T_p, div_p = _both(_t(*_solves(s=2, n=288, seed=10)), **kw)
    np.testing.assert_allclose(T_b.numpy(), T_p.numpy(), atol=FGW_ATOL, rtol=0)
    np.testing.assert_array_equal(div_b.numpy(), div_p.numpy())


# csrc/fgw.cu::stream_plan's (sub-band rows, k-slice, ring stages) in order
# of preference, and the largest N each sub-band's registers take
PLANS = ((64, 32, 2), (64, 16, 3), (64, 16, 2), (48, 32, 2), (48, 16, 3), (48, 16, 2),
         (32, 32, 2), (32, 16, 3), (32, 16, 2))
SUB_NMAX = {64: 320, 48: 384, 32: 512}


def _plan_bytes(N, R):
    """Shared bytes a CTA of the stream route at (N, R) by the first plan
    that fits, as ``stream_plan`` picks it: mr's band at stride N + 4 (a
    sub-band of C1 T lives in its rows), the ring's stages (T's k-slice at
    stride N + 8 with C1's at KS + 4, or C2's at KS + 4), 8 N + 4 R + 40
    floats of vectors; 0 where none fits."""
    for sub, ks, stages in PLANS:
        if R % sub or N > SUB_NMAX[sub]:
            continue
        stage = max(ks * (N + 8) + sub * (ks + 4), N * (ks + 4))
        floats = R * (N + 4) + stages * stage + 8 * N + 4 * R + 40
        if 4 * floats <= MAX_SMEM_BYTES:
            return 4 * floats
    return 0


@pytest.mark.parametrize("N", sorted(k3.STREAM_ROWS))
def test_stream_rows_fit_a_portable_cluster(N):
    R = k3.STREAM_ROWS[N]
    assert k3.LARGEST_CLUSTER < N <= k3.LARGEST_STREAM and N % 32 == 0
    assert N % R == 0 and R % 16 == 0 and N // R <= 8
    assert 0 < _plan_bytes(N, R) <= MAX_SMEM_BYTES
    assert k3.route(N) == k3.Route("stream", N // R, R, N)


@pytest.mark.parametrize("N,size", [(352, 384), (416, 448), (480, 512)])
def test_stream_pads_sizes_without_a_band(N, size):
    """352, 416 and 480 take no band of at most 8 CTAs that fits; the
    wrapper runs them at the next size the route takes."""
    assert not any(N % R == 0 and N // R <= 8 and _plan_bytes(N, R) for R in range(16, N, 16))
    way = k3.route(N)
    assert way.kind == "stream" and way.size == size and way.rows == k3.STREAM_ROWS[size]


def test_stream_launch_names():
    assert k3.launch_name("fgw_couplings", k3.LARGEST_CLUSTER + 32) == "fgw_couplings_stream"
    assert k3.launch_name("fgw_couplings_mol", 352) == "fgw_couplings_mol_stream"
    assert k3.launch_name("fgw_couplings", k3.LARGEST_STREAM) == "fgw_couplings_stream"
    assert k3.launch_name("fgw_couplings_mol", k3.LARGEST_STREAM + 32) == "fgw_couplings_mol_large"
