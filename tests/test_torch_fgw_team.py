"""K3's global route (above 512 atoms) on the CPU: its decomposition and its
plan.

On the card a solve of N > 512 runs on a team of C CTAs
(``csrc/fgw_team.cu::fgw_couplings_team_kernel``), CTA r owning a band of R
rows (the last one short where R does not divide N); T and C2 stream through
a ring of k-slices, product 1 sums T's k-slices from the first, and the
column reductions and freeze checks combine band partials in rank order
through device memory. ``ops/cuda/fgw.py::fgw_couplings_banded(...,
streamed=True)`` with the plan's bands is that decomposition in plain
PyTorch. Here it is held

- against the port's plain solver (``fgw_couplings_plain``) at N = 544 with
  the plan's bands of 64 rows (S = 2; the ninth band holds 32 rows), with a
  NaN planted in one T0 (that solve diverges and keeps its T0) and with
  solves that freeze early;
- against the JAX flat solver (``pallas_fgw_couplings_flat`` in interpret
  mode, its path on the CPU) at n = 520 padded to 544 (S = 1), atol 2.5e-6
  (K3's gate on the card), flags equal;

and ``team_plan`` (``csrc/fgw_team.cu::team_plan`` restated) at N = 544,
800 and 1056 for S = 5, 15 and 90 on 132 SMs: every team of the plan
resident at once, no last round with one team alone where a plan with fewer
rounds exists, its shared memory within a block's and its scratch counted
for the teams at once. One test, marked ``card``, holds the kernel against the
plain version on the card.
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
SMS = 132


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _both(args, S=2, n=None, **kw):
    """The banded solve with the global route's bands at (N, S) and the plain
    solve of the same input."""
    solver = dict(KW, **kw)
    rows = k3.route(args[0].shape[-1], S).rows
    T_b, div_b = k3.fgw_couplings_banded(*args, rows=rows, n=n, streamed=True, **solver)
    T_p, (div_p, _) = k3.fgw_couplings_plain(*args, n=n, **solver)
    return T_b, div_b, T_p, div_p


def _padded(x, pad):
    return [np.pad(a, [(0, 0)] + [(0, pad)] * (a.ndim - 1)) for a in x]


def test_team_bands_match_plain_at_n544():
    way = k3.route(544, 2)
    assert way == k3.Route("global", 9, 64, 544)  # bands of 64 rows, the ninth of 32
    T_b, div_b, T_p, div_p = _both(_t(*_solves(s=2, n=544, seed=544)))
    np.testing.assert_allclose(T_b.numpy(), T_p.numpy(), atol=FGW_ATOL, rtol=0)
    np.testing.assert_array_equal(div_b.numpy(), div_p.numpy())


def test_team_bands_match_jax_at_n520_padded():
    """n = 520 real atoms in a bucket of 544: the ninth band, of 32 rows,
    holds 8 real rows and 24 of padding, which take no mass."""
    args = _solves(s=1, n=520, seed=520)
    T_j, div_j = pallas_fgw_couplings_flat(*map(jnp.asarray, args), interpret=True, **KW)
    T_b, div_b = k3.fgw_couplings_banded(*_t(*_padded(args, 24)), rows=k3.route(544, 1).rows,
                                         n=520, streamed=True, **KW)
    assert T_b.shape == (1, 544, 544)
    assert float(T_b[:, 520:].abs().max()) == 0.0 and float(T_b[:, :, 520:].abs().max()) == 0.0
    np.testing.assert_allclose(T_b[:, :520, :520].numpy(), np.asarray(T_j), atol=FGW_ATOL, rtol=0)
    np.testing.assert_array_equal(div_b.numpy(), np.asarray(div_j))


def test_team_nan_in_t0_diverges_and_rolls_back():
    """A NaN in solve 0's T0 makes all of its mr NaN: the solve is flagged
    as diverged and keeps T0; solve 1 is untouched."""
    args = _t(*_solves(s=2, n=544, seed=11))
    T0 = args[5].clone()
    T0[0, 530, 7] = float("nan")  # in the short last band
    args[5] = T0
    T_b, div_b, T_p, div_p = _both(args)
    assert div_b.tolist() == [1, 0] and div_p.tolist() == [1, 0]
    assert torch.equal(T_b.isnan(), T_p.isnan())
    assert torch.equal(T_b[0].nan_to_num(-1.0), T0[0].nan_to_num(-1.0))
    np.testing.assert_allclose(T_b[1].numpy(), T_p[1].numpy(), atol=FGW_ATOL, rtol=0)


@pytest.mark.parametrize("kw", [dict(sinkhorn_thr=10.0), dict(pgd_tol=10.0)],
                         ids=["sinkhorn", "pgd"])
def test_team_early_freeze_matches_plain(kw):
    """Solves that freeze at their first check: in every Sinkhorn loop
    (marginal error under the threshold) or at the first PGD step."""
    T_b, div_b, T_p, div_p = _both(_t(*_solves(s=2, n=544, seed=12)), **kw)
    np.testing.assert_allclose(T_b.numpy(), T_p.numpy(), atol=FGW_ATOL, rtol=0)
    np.testing.assert_array_equal(div_b.numpy(), div_p.numpy())


@pytest.mark.parametrize("S", [5, 15, 90])
@pytest.mark.parametrize("N", [544, 800, 1056])
def test_team_plan(N, S):
    plan = k3.team_plan(N, S, SMS)
    cands = [c for c, _ in k3.team_candidates(N, S, SMS)]
    # a team of C CTAs with bands of R rows covers N; every team of the
    # plan is resident at once (one CTA an SM)
    assert plan.rows % 64 == 0 and plan.ctas == -(-N // plan.rows)
    assert (plan.ctas - 1) * plan.rows < N
    assert 1 <= plan.teams <= S and plan.teams * plan.ctas <= SMS
    assert plan.rounds == -(-S // plan.teams)
    # no last round with one team alone where fewer rounds exist
    last = S - (plan.rounds - 1) * plan.teams
    if plan.rounds > 1 and last == 1:
        assert plan.rounds == min(c.rounds for c in cands)
    # a pass holds at most 4 tiles, a ring stage the band's row tiles and
    # the pass's column tiles (at most 4), and the passes cover N
    rt = plan.rows // 64
    assert rt * plan.per_pass <= 4 and rt + plan.per_pass <= 4
    assert plan.passes * plan.per_pass * 64 >= N > (plan.passes - 1) * plan.per_pass * 64
    # a block's shared memory; the scratch counted for the teams at once
    # (not for S): an equal area of whole blocks of 32 floats a team, each
    # holding at least mr and the second plan (the card test holds the
    # count to the library's)
    assert plan.smem <= MAX_SMEM_BYTES
    assert plan.scratch_floats % (32 * plan.teams) == 0
    assert plan.teams * 2 * N * N <= plan.scratch_floats
    assert k3.route(N, S, SMS) == k3.Route("global", plan.ctas, plan.rows, N)


def test_team_plan_weighs_s():
    """S = 15 at N = 544: bands of 64 rows would need 135 CTAs, three more
    than the SMs, and a second round for one team; the plan takes bands of
    128 rows, all 15 teams at once. K3' (S = 5) keeps bands of 64."""
    by_rows = {c.rows: c for c, _ in k3.team_candidates(544, 15, SMS)}
    assert by_rows[64].ctas * 15 == 135 and by_rows[64].rounds == 2
    assert k3.team_plan(544, 15, SMS)[:4] == (128, 5, 15, 1)
    assert k3.team_plan(544, 5, SMS)[:4] == (64, 9, 5, 1)


@pytest.mark.card
def test_team_kernel_matches_plain_on_the_card():
    """The kernel against the plain version on the card at N = 544 (S = 2)
    and at n = 520 padded to 544 (S = 5), and the library's plan, its
    scratch count included, against ``team_plan`` for the card's SM count
    (``_team_ready`` raises where they differ)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for S, n, seed in ((2, 544, 21), (5, 520, 22)):
        x = _solves(s=S, n=n, seed=seed)
        args = [t.cuda() for t in _t(*_padded(x, 544 - n))]
        k3._team_ready(544, S, 0)
        T_k, (div_k, _) = k3._couplings(*args, n=n, count="test", **KW)
        T_p, (div_p, _) = k3.fgw_couplings_plain(*args, n=n, **KW)
        torch.cuda.synchronize()
        np.testing.assert_allclose(T_k.cpu().numpy(), T_p.cpu().numpy(), atol=FGW_ATOL, rtol=0)
        np.testing.assert_array_equal(div_k.cpu().numpy(), div_p.cpu().numpy())
