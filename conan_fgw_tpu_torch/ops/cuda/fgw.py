"""Batched FGW coupling solver: CUDA kernel K3.

``fgw_couplings_flat`` replaces
``conan_fgw_tpu/ops/pallas/fgw.py::pallas_fgw_couplings_flat`` (the Pallas
``_super_kernel`` with ``_sinkhorn_super``), and ``fgw_couplings`` its
per-molecule wrapper ``pallas_fgw_couplings``. The kernel lives in
``csrc/fgw.cu``; its comments say what bounds each route on this card and
how its design answers it. It takes a bucket size N (a multiple of 32) and
each solve's true atom count n <= N, and leaves the padding out of the
solve; both wrappers pad any other size up to the next multiple of 32.
``route(N, S)`` picks one of four routes by N, with no fallback among them:

- N <= ``LARGEST_TEMPLATE`` (128): the ``<N, PAD>`` templates, one CTA a
  solve, its matrices in shared memory (C1 and C2 through L2 at N = 128);
- N = 160 .. ``LARGEST_CLUSTER`` (256): the cluster route
  (``fgw_couplings_cluster_kernel``), one thread-block cluster of N / R
  CTAs a solve, each CTA holding a band of R rows of T, C1 T and mr in its
  shared memory, the column reductions combined across the cluster in rank
  order; its launches count under the wrapper's name with ``_cluster``;
- N = 288 .. ``LARGEST_STREAM`` (512): the stream route
  (``fgw_couplings_stream_kernel``), one cluster of N / R CTAs a solve,
  each CTA holding a band of R rows of mr in its shared memory while T and
  C2 stream through a ring of k-slices; a size it takes no band of (352,
  416, 480) is padded to the next one it does (``Route.size``); its
  launches count with ``_stream``;
- N above it: the global route (``csrc/fgw_team.cu``'s
  ``fgw_couplings_team_kernel``), each solve on a team of C CTAs across the
  card, each owning a band of R rows, cooperating through device memory
  (``team_plan`` picks R and C from N and the S solves of the launch), with
  no upper limit on N; its launches count with ``_large``.

The plain version is ``ops/fgw/coupling.py::fgw_coupling`` on the leading
n x n block, reached here through ``fgw_couplings_plain``;
``fgw_couplings_banded`` is the cluster, stream and global routes'
decomposition in plain PyTorch, for the CPU tests only. Forward only: the
barycenter solves its couplings without gradient.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from conan_fgw_tpu_torch.ops.cuda import _build, launches
from conan_fgw_tpu_torch.ops.fgw.coupling import fgw_coupling

# the largest N of csrc/fgw.cu's <N, PAD> templates; above it, the cluster route
LARGEST_TEMPLATE = 128
# the largest N of the cluster route (N / 32 <= 8 CTAs, a portable cluster);
# above it, the global route
LARGEST_CLUSTER = 256
# the cluster route's band rows R by N (a cluster of N / R CTAs), as
# csrc/fgw.cu::fgw_cluster_rows gives them: 64 where it divides N (it took
# 0.89x and 0.49x the time of 32 rows at N = 192 and 256 on the card,
# scripts/torch_fgw_probe.py), else 32
CLUSTER_ROWS = {160: 32, 192: 64, 224: 32, 256: 64}
# the largest N of the stream route (N / R <= 8 CTAs); above it, the global
# route
LARGEST_STREAM = 512
# the global route's shape (csrc/fgw_team.cu): row bands of RT wgmma tiles
# of 64 rows (RT = 1 .. 4), passes of at most 4 output tiles of 64 x 64 with
# RT + P <= 4 (a pass's P column tiles and the band's row tiles in each of
# the ring's 3 stages, split k-slices of 32), 256 threads and one CTA an
# SM, a team's barrier counter 32 words from the next
TEAM_TILE, TEAM_KS, TEAM_MAX_RT, TEAM_PASS_TILES, TEAM_RING_TILES = 64, 32, 4, 4, 4
TEAM_STAGES = 3
TEAM_COUNTER_WORDS = 32
SMS = 132  # an H100 SXM's SMs: the plan's card unless another is named
# the stream route's band rows R by the N it runs at, as
# csrc/fgw.cu::fgw_stream_rows gives them: the fastest measured on the card
# (PERF.md §6, PR 19); the sizes between them are padded up to the next
STREAM_ROWS = {288: 48, 320: 64, 384: 48, 448: 64, 512: 64}
_NAMES = ("Ms", "C1s", "C2s", "ps", "qs", "T0s")
_SUFFIX = {"template": "", "cluster": "_cluster", "stream": "_stream", "global": "_large"}


class Route(NamedTuple):
    """K3's route at a bucket size: ``kind`` (``"template"``, ``"cluster"``,
    ``"stream"`` or ``"global"``), the CTAs a solve, the rows each CTA owns
    (the last band of the global route may be short) and the size the
    kernel runs at (N, or on the stream route the next size it takes a band
    of)."""

    kind: str
    ctas: int
    rows: int
    size: int


class TeamPlan(NamedTuple):
    """The global route's plan of S solves at N (``csrc/fgw_team.cu``'s
    ``team_plan``): band rows R, CTAs a team C, teams at once, rounds,
    passes over the column tiles a product and tiles a pass, whether the
    vectors sit in shared memory, shared bytes a CTA and scratch floats."""

    rows: int
    ctas: int
    teams: int
    rounds: int
    passes: int
    per_pass: int
    vec_smem: bool
    smem: int
    scratch_floats: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def team_candidates(N: int, S: int, sms: int = SMS) -> list[tuple[TeamPlan, int]]:
    """Every band height the global route weighs at ``(N, S)`` on ``sms``
    SMs, as ``(plan, cost)``: RT = 1 .. 4 row tiles of 64 (a team of C =
    ceil(N / 64 RT) CTAs, no more than the SMs), as many whole teams at once
    as the card holds at one CTA an SM, passes of P >= 1 column tiles (RT P
    <= 4, RT + P <= 4); the cost is the rounds times a warpgroup's tile
    passes (ceil(RT P / 2) a pass)."""
    out = []
    NT = _cdiv(N, TEAM_TILE)
    for rt in range(1, TEAM_MAX_RT + 1):
        R = TEAM_TILE * rt
        C = _cdiv(N, R)
        if C > sms:
            continue
        teams = min(S, sms // C)
        rounds = _cdiv(S, teams)
        pmax = min(TEAM_PASS_TILES // rt, TEAM_RING_TILES - rt)
        if pmax < 1:
            continue
        passes = _cdiv(NT, pmax)
        P = _cdiv(NT, passes)
        ring = TEAM_STAGES * (rt + P) * 2 * TEAM_TILE * TEAM_KS * 4 + 64  # and the stages' barriers
        vec = 4 * (5 * N + 4 * R + 64)
        vec_smem = ring + vec <= _build.MAX_SMEM_BYTES
        split = C * rt * (N // TEAM_KS) * 2 * TEAM_TILE * TEAM_KS  # a split matrix's words
        team = 5 * split + 2 * N * N + N + 2 * C * 2 * N + 2 * C * N + 2 * C * 4
        if not vec_smem:
            team += C * (5 * N + 4 * R + 64)
        team = _cdiv(team, 32) * 32
        plan = TeamPlan(R, C, teams, rounds, passes, P, vec_smem, ring + (vec if vec_smem else 0),
                        teams * TEAM_COUNTER_WORDS + teams * team)
        out.append((plan, rounds * passes * _cdiv(rt * P, 2)))
    return out


def team_plan(N: int, S: int, sms: int = SMS) -> TeamPlan:
    """The global route's plan, as ``csrc/fgw_team.cu::team_plan`` picks
    it from ``team_candidates``: the least cost, ties to fewer rounds, then
    to the smaller R; a plan whose last round holds one team is dropped
    where another has fewer rounds."""
    if N % 32 or N < 32 or S < 1:
        raise ValueError(f"fgw kernel: no team plan for S={S} solves of N={N}")
    cands = team_candidates(N, S, sms)
    fewest = min(plan.rounds for plan, _ in cands)
    best = None
    for plan, cost in cands:
        lonely = plan.rounds > 1 and S - (plan.rounds - 1) * plan.teams == 1
        if lonely and fewest < plan.rounds:
            continue
        if best is None or (cost, plan.rounds) < (best[1], best[0].rounds):
            best = (plan, cost)
    return best[0]


def route(N: int, S: int = 1, sms: int = SMS) -> Route:
    """The route K3 takes at bucket size ``N`` (a multiple of 32); on the
    global route its team's CTAs and band rows for ``S`` solves on ``sms``
    SMs."""
    if N % 32 or N < 32:
        raise ValueError(f"fgw kernel: N={N} is not a multiple of 32")
    if N <= LARGEST_TEMPLATE:
        return Route("template", 1, N, N)
    if N <= LARGEST_CLUSTER:
        R = CLUSTER_ROWS[N]
        return Route("cluster", N // R, R, N)
    if N <= LARGEST_STREAM:
        size = min(k for k in STREAM_ROWS if k >= N)
        R = STREAM_ROWS[size]
        return Route("stream", size // R, R, size)
    plan = team_plan(N, S, sms)
    return Route("global", plan.ctas, plan.rows, N)


def launch_name(count: str, N: int) -> str:
    """The name a launch of K3 at bucket size ``N`` counts under: ``count``,
    with ``_cluster`` on the cluster route, ``_stream`` on the stream route
    and ``_large`` on the global."""
    return count + _SUFFIX[route(N).kind]


def fgw_couplings_plain(Ms, C1s, C2s, ps, qs, T0s, n=None, **solver):
    """Plain PyTorch version: ``(T (S, N, N), flags (2, S) int32)``, the
    diverged flags and each solve's Sinkhorn iterations, as the kernel
    returns them. With ``n`` < N, the solve of the leading ``n x n`` block,
    its plan zero on the padding, as the kernel computes it."""
    N = Ms.shape[-1]
    n = N if n is None else n
    if n < N:
        Ms, C1s, C2s, T0s = (x[:, :n, :n] for x in (Ms, C1s, C2s, T0s))
        ps, qs = ps[:, :n], qs[:, :n]
    T, div, iters = fgw_coupling(Ms, C1s, C2s, ps, qs, T0s, **solver)
    return F.pad(T, (0, N - n, 0, N - n)), torch.stack([div.to(torch.int32), iters])


def fgw_couplings_banded(Ms, C1s, C2s, ps, qs, T0s, *, rows, n=None, streamed=False, alpha,
                         epsilon, pgd_iters, pgd_tol, sinkhorn_iters, sinkhorn_thr):
    """The cluster route's decomposition in plain PyTorch (for the CPU
    tests; nothing on the main path calls it): ``(T (S, N, N), diverged
    (S,) int32)``, the plan and the first row of ``fgw_couplings_plain``'s
    flags. The N rows fall into bands of
    ``rows`` rows (the last one short where ``rows`` does not divide N, as
    on the global route), one a CTA of the cluster or team, in rank order.
    Product 1 sums the bands' k-slices from the own band on, as the cluster
    kernel does, or with ``streamed`` (the stream and global routes) in
    rank order, as their rings stream T's k-slices from the first; a row's
    log-sum-exp is its band's; a column's combines the bands' (max, sum of
    exp) in rank order, a non-finite max replaced by 0 and a band whose sum
    is 0 adding nothing; the marginal check and the candidate's distance
    to T are band partials summed in rank order. Rows and columns ``>= n``
    (default N) are padding."""
    S, N, _ = Ms.shape
    n = N if n is None else int(n)
    bands = [slice(min(b, n), min(b + rows, n)) for b in range(0, N, rows)]
    C = len(bands)
    Mb, C1, C2, p, q, T = (x[:, :n, :n] if x.dim() == 3 else x[:, :n]
                           for x in (Ms, C1s, C2s, ps, qs, T0s))
    logp = torch.log(torch.clamp(p, min=1e-30))
    logq = torch.log(torch.clamp(q, min=1e-30))
    constC = ((C1 * C1) @ p[:, :, None]) + ((C2 * C2) @ q[:, :, None]).transpose(-1, -2)
    frozen = torch.zeros(S, dtype=torch.bool, device=Ms.device)
    diverged = torch.zeros_like(frozen)

    def ranked(parts):  # a sum over the bands in rank order
        out = parts[0]
        for x in parts[1:]:
            out = out + x
        return out

    def lse_shift(m):  # logsumexp's shift: a non-finite max becomes 0
        return torch.where(torch.isfinite(m), m, torch.zeros_like(m))

    for it in range(pgd_iters):
        A = torch.zeros_like(T)
        for r, band in enumerate(bands):
            for j in range(C):
                k = bands[j if streamed else (r + j) % C]
                A[:, band] = A[:, band] + C1[:, band, k] @ T[:, k, :]
        mr = -(alpha * (2.0 * (constC - A @ (2.0 * C2).transpose(-1, -2))) + (1.0 - alpha) * Mb) / epsilon
        u = torch.zeros_like(p)
        v = torch.zeros_like(q)
        sfrozen = torch.zeros_like(frozen)
        sdiv = torch.zeros_like(frozen)
        for si in range(sinkhorn_iters):
            xs = [mr[:, band] + u[:, band, None] for band in bands]
            m = [x.amax(-2) if x.shape[-2] else torch.full_like(q, -torch.inf) for x in xs]
            sums = [torch.exp(x - lse_shift(mb)[:, None]).sum(-2) for x, mb in zip(xs, m)]
            M = torch.stack(m).amax(0)
            shift = lse_shift(M)
            tot = ranked([torch.where(sb == 0, torch.zeros_like(sb),
                                      sb * torch.exp(lse_shift(mb) - shift))
                          for sb, mb in zip(sums, m)])
            v_new = logq - (torch.log(tot) + shift)
            x = mr + v_new[:, None, :]
            mrow = x.amax(-1)
            u_new = logp - (torch.log(torch.exp(x - lse_shift(mrow)[..., None]).sum(-1))
                            + lse_shift(mrow))
            newly_div = ~(torch.isfinite(u_new).all(-1) & torch.isfinite(v_new).all(-1)) & ~sfrozen
            newly_frozen = newly_div
            if si % 10 == 0:
                col = ranked([torch.exp(mr[:, band] + u_new[:, band, None] + v_new[:, None, :]).sum(-2)
                              for band in bands])
                err = torch.sqrt(((col - q) ** 2).sum(-1))
                newly_frozen = (err < sinkhorn_thr) | newly_div
            keep = (sfrozen | newly_div)[:, None]
            u = torch.where(keep, u, u_new)
            v = torch.where(keep, v, v_new)
            sfrozen = sfrozen | newly_frozen
            sdiv = sdiv | newly_div
        T_new = torch.exp(mr + u[:, :, None] + v[:, None, :])
        bad = sdiv | ~torch.isfinite(T_new).flatten(1).all(-1)
        newly_frozen = bad
        if it % 10 == 0:
            err = torch.sqrt(ranked([((T_new[:, band] - T[:, band]) ** 2).flatten(1).sum(-1)
                                     for band in bands]))
            newly_frozen = (err <= pgd_tol) | bad
        T = torch.where((frozen | bad)[:, None, None], T, T_new)
        frozen = frozen | newly_frozen
        diverged = diverged | bad
    return F.pad(T, (0, N - n, 0, N - n)), diverged.to(torch.int32)


@functools.cache
def _resident(N: int) -> int:
    """1 where C1 and C2 fit in shared memory beside the solve's own
    matrices (N <= 96), else 0: the kernel then reads them through L2."""
    lib = _build.load_library()
    resident = int(lib.fgw_smem(N, 1) <= _build.MAX_SMEM_BYTES)
    if lib.fgw_smem(N, resident) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"fgw kernel: N={N} does not fit in shared memory")
    return resident


@functools.cache
def _cluster_ready(N: int, R: int) -> int:
    """Raise unless the library's cluster route takes ``R`` rows at ``N``,
    as ``route`` does, and the card can place one of its clusters; returns
    the clusters the card holds at once."""
    lib = _build.load_library()
    if lib.fgw_cluster_limit() != LARGEST_CLUSTER or lib.fgw_cluster_rows(N) != R:
        raise RuntimeError(f"fgw kernel: the library's cluster route takes R="
                           f"{lib.fgw_cluster_rows(N)} up to N={lib.fgw_cluster_limit()}, the"
                           f" wrapper R={R} up to N={LARGEST_CLUSTER}")
    active = lib.fgw_cluster_active(N, R)
    if active <= 0:
        raise RuntimeError(f"fgw kernel: the card can place no cluster of {N // R} CTAs of"
                           f" {lib.fgw_cluster_smem(N, R)} bytes at N={N}"
                           f" ({'no room' if active == 0 else f'CUDA error {-active}'})")
    return active


@functools.cache
def _stream_ready(N: int, R: int) -> int:
    """Raise unless the library's stream route takes ``R`` rows at ``N``, as
    ``route`` does, and the card can place one of its clusters; returns the
    clusters the card holds at once."""
    lib = _build.load_library()
    if lib.fgw_stream_limit() != LARGEST_STREAM or lib.fgw_stream_rows(N) != R:
        raise RuntimeError(f"fgw kernel: the library's stream route takes R="
                           f"{lib.fgw_stream_rows(N)} up to N={lib.fgw_stream_limit()}, the"
                           f" wrapper R={R} up to N={LARGEST_STREAM}")
    active = lib.fgw_stream_active(N, R)
    if active <= 0:
        raise RuntimeError(f"fgw kernel: the card can place no cluster of {N // R} CTAs of"
                           f" {lib.fgw_stream_smem(N, R)} bytes at N={N}"
                           f" ({'no room' if active == 0 else f'CUDA error {-active}'})")
    return active


@functools.cache
def _sms(idx: int) -> int:
    """Card ``idx``'s SM count."""
    return torch.cuda.get_device_properties(idx).multi_processor_count


@functools.cache
def _team_ready(N: int, S: int, idx: int) -> TeamPlan:
    """The global route's plan of ``S`` solves at ``N`` on card ``idx``:
    raise unless the library's plan (``fgw_team_plan``, its scratch count
    included) is ``team_plan``'s for the card's SM count."""
    lib = _build.load_library()
    sms = _sms(idx)
    plan = team_plan(N, S, sms)
    out = (ctypes.c_int * 9)()
    code = lib.fgw_team_plan(S, N, sms, out)
    want = (plan.rows, plan.ctas, plan.teams, plan.rounds, plan.passes, plan.per_pass,
            int(plan.vec_smem), plan.smem, plan.scratch_floats // 32)
    if code != 0 or tuple(out) != want:
        raise RuntimeError(f"fgw kernel: the library's global-route plan at S={S}, N={N} on"
                           f" {sms} SMs is {tuple(out)} (code {code}), the wrapper's {want}")
    return plan


def _complaint(name, t, dev, want):
    if not t.is_cuda or t.device != dev:
        return f"{name} must lie on {dev}"
    if t.dtype != torch.float32:
        return f"{name} must be float32, got {t.dtype}"
    if not t.is_contiguous():
        return f"{name} must be contiguous"
    if tuple(t.shape) != want:
        return f"{name} has shape {tuple(t.shape)}, want {want}"
    return f"{name} must start on a 16-byte boundary"


def _couplings(Ms, C1s, C2s, ps, qs, T0s, *, alpha, epsilon, pgd_iters, pgd_tol,
               sinkhorn_iters, sinkhorn_thr, n=None, count="fgw_couplings"):
    """Launch K3: ``(T, flags)``, ``flags`` the ``(2, S)`` int32 buffer the
    kernel writes: each solve's diverged flag, and its Sinkhorn iterations
    over all its PGD steps. ``N`` must be a multiple of 32; rows and
    columns ``>= n`` (default N) are padding. The route is ``route(N, S)``'s on the card's SMs, and ``launches[launch_name(count, N)]`` grows
    by one: up to ``LARGEST_TEMPLATE`` the templates, up to
    ``LARGEST_CLUSTER`` the cluster route (``count + "_cluster"``), up to
    ``LARGEST_STREAM`` the stream route (``count + "_stream"``; a size it
    takes no band of is padded to ``route(N).size`` and cut back), above it
    the global route with the scratch of ``team_plan(N, S)`` for each team
    resident at once: its split operands, C1 T, mr, a second plan and the
    partials (``count + "_large"``; the library zeroes the teams' barrier
    counters on the stream). A launch that is refused raises; none reruns
    on another route."""
    S, N, _ = Ms.shape
    n = N if n is None else int(n)
    dev = Ms.device
    idx = Ms.get_device()  # -1 off the card
    for name, t in zip(_NAMES, (Ms, C1s, C2s, ps, qs, T0s)):
        want = (S, N) if name in ("ps", "qs") else (S, N, N)
        if (idx < 0 or t.get_device() != idx or t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != want or t.data_ptr() % 16):
            raise ValueError(f"fgw kernel: {_complaint(name, t, dev, want)}")
    way = route(N, S, _sms(idx))
    if not 1 <= n <= N:
        raise ValueError(f"fgw kernel: n={n} atoms outside [1, N={N}]")
    if way.size != N:  # the padding is left out of the solve, as n's
        args = tuple(_padded(x, way.size - N) for x in (Ms, C1s, C2s, ps, qs, T0s))
        T, flags = _couplings(*args, alpha=alpha, epsilon=epsilon, pgd_iters=pgd_iters,
                              pgd_tol=pgd_tol, sinkhorn_iters=sinkhorn_iters,
                              sinkhorn_thr=sinkhorn_thr, n=n, count=count)
        return T[:, :N, :N], flags
    lib = _build.load_library()
    T = torch.empty_like(Ms)
    flags = torch.empty((2, S), dtype=torch.int32, device=dev)
    div, iters = flags[0], flags[1]
    solver = (float(alpha), float(epsilon), int(pgd_iters), float(pgd_tol), int(sinkhorn_iters),
              float(sinkhorn_thr))
    pointers = tuple(t.data_ptr() for t in (Ms, C1s, C2s, ps, qs, T0s, T, div, iters))
    switch = contextlib.nullcontext() if idx == torch.cuda.current_device() else torch.cuda.device(idx)
    with switch:
        # the current stream's raw handle, without building a Stream object
        stream = torch._C._cuda_getCurrentRawStream(idx)
        if way.kind == "template":
            code = lib.fgw_couplings(*pointers, S, N, n, _resident(N), *solver, stream)
        elif way.kind == "cluster":
            _cluster_ready(N, way.rows)
            code = lib.fgw_couplings_cluster(*pointers, S, N, n, way.rows, *solver, stream)
        elif way.kind == "stream":
            _stream_ready(N, way.rows)
            code = lib.fgw_couplings_stream(*pointers, S, N, n, way.rows, *solver, stream)
        else:
            plan = _team_ready(N, S, idx)
            scratch = torch.empty(plan.scratch_floats, device=dev)
            code = lib.fgw_couplings_large(*pointers, scratch.data_ptr(), S, N, n, *solver, stream)
    count = launch_name(count, N)
    _build.check(code, count)
    launches[count] += 1
    return T, flags


def _solve(args, n, count, solver):
    """CUDA tensors to the kernel, CPU tensors to ``fgw_couplings_plain``;
    a mix of the two raises. Returns ``(T, flags)`` (``_couplings``)."""
    if all(t.device.type == "cpu" for t in args):
        return fgw_couplings_plain(*args, n=n, **solver)
    if args[0].is_cuda:
        return _couplings(*args, n=n, count=count, **solver)
    devices = sorted({str(t.device) for t in args})
    raise ValueError(f"fgw couplings: unsupported device {', '.join(devices)}")


def _padded(x, pad):
    """``(S, n)`` or ``(S, n, n)`` zero-padded by ``pad`` rows (and columns)."""
    return F.pad(x, (0, pad) if x.dim() == 2 else (0, pad, 0, pad)).contiguous()


def fgw_couplings_flat(Ms, C1s, C2s, ps, qs, T0s, *, alpha, epsilon, pgd_iters, pgd_tol,
                       sinkhorn_iters, sinkhorn_thr):
    """Solve ``S`` independent FGW couplings.

    Args: ``Ms``/``C1s``/``C2s``/``T0s`` ``(S, N, N)``, ``ps``/``qs`` ``(S, N)``
    for any ``N``, as JAX's flat solver takes any ``n``.
    Returns ``(T (S, N, N) f32, flags (2, S) int32)``: each solve's
    diverged flag and Sinkhorn iterations (``_couplings``).
    CUDA tensors go to the kernel (counted as ``fgw_couplings`` up to 128
    atoms, ``fgw_couplings_cluster`` from 129 to 256, ``fgw_couplings_stream``
    from 257 to 512, ``fgw_couplings_large`` above: ``launch_name``), CPU
    tensors to ``fgw_couplings_plain``; a mix of the two raises. A bucket
    size (a multiple of 32) is launched as it is. Any other ``N`` is padded
    to the next multiple of 32 with zero structure, mass and plan, the
    kernel (or the plain version, on the CPU) solves the leading ``N x N``
    block of every solve, and the result is cut back to ``N``.
    """
    solver = dict(alpha=alpha, epsilon=epsilon, pgd_iters=pgd_iters, pgd_tol=pgd_tol,
                  sinkhorn_iters=sinkhorn_iters, sinkhorn_thr=sinkhorn_thr)
    args = (Ms, C1s, C2s, ps, qs, T0s)
    N = Ms.shape[-1]
    pad = -N % 32
    if pad:
        T, flags = _solve(tuple(_padded(x, pad) for x in args), N, "fgw_couplings", solver)
        T = T[:, :N, :N]
    else:
        T, flags = _solve(args, None, "fgw_couplings", solver)
    return T, flags


def fgw_couplings(Ms, Cb, Cks, p, qs, T0s, *, alpha, epsilon, pgd_iters, pgd_tol,
                  sinkhorn_iters, sinkhorn_thr):
    """Solve the ``K`` couplings of one barycenter step of one molecule.

    Args: ``Ms``/``Cks``/``T0s`` ``(K, n, n)``, ``Cb`` ``(n, n)`` (the
    shared barycenter structure), ``p`` ``(n,)``, ``qs`` ``(K, n)``, for any
    ``n``. Returns ``(T (K, n, n), totals)``, ``totals`` ``(2,)`` int32:
    how many of the K solves hit a Sinkhorn numerical failure and rolled
    back, and the K solves' Sinkhorn iterations. The solves are padded to
    the next multiple of 32 with zero structure, mass and plan, and K3
    (counted as
    ``fgw_couplings_mol``, ``fgw_couplings_mol_cluster`` from 129 to 256
    atoms, ``fgw_couplings_mol_stream`` from 257 to 512,
    ``fgw_couplings_mol_large`` above) leaves the padding out; on the
    CPU the plain version solves the leading
    n x n block of the same padded input.
    """
    K, n, _ = Ms.shape
    pad = -n % 32
    args = tuple(_padded(x, pad) for x in (Ms, Cb.expand(K, n, n), Cks, p.expand(K, n), qs, T0s))
    solver = dict(alpha=alpha, epsilon=epsilon, pgd_iters=pgd_iters, pgd_tol=pgd_tol,
                  sinkhorn_iters=sinkhorn_iters, sinkhorn_thr=sinkhorn_thr)
    T, flags = _solve(args, n, "fgw_couplings_mol", solver)
    return T[:, :n, :n], flags.sum(1, dtype=torch.int32)
