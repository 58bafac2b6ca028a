"""Batched FGW coupling solver: CUDA kernel K3.

``fgw_couplings_flat`` replaces
``conan_fgw_tpu/ops/pallas/fgw.py::pallas_fgw_couplings_flat`` (the Pallas
``_super_kernel`` with ``_sinkhorn_super``), and ``fgw_couplings`` its
per-molecule wrapper ``pallas_fgw_couplings``. The kernel lives in
``csrc/fgw.cu``, one CTA per solve; its header says what bounds it on this
card and how the design answers it. It takes a bucket size N (a multiple of
32) and each solve's true atom count n <= N, and leaves the padding out of
the solve; both wrappers pad any other size up to the next multiple of 32.
Up to ``LARGEST_TEMPLATE`` (128) atoms a solve runs in the kernel's ``<N,
PAD>`` templates, its matrices in shared memory; above it in the global
route (``fgw_couplings_large_kernel``), its matrices in device memory
through L2, with no upper limit on N. A launch of the global route counts
under its own name, the wrapper's with ``_large``.
The plain version is ``ops/fgw/coupling.py::fgw_coupling`` on
the leading n x n block, reached here through ``fgw_couplings_plain``.
Forward only: the barycenter solves its couplings without gradient.
"""

from __future__ import annotations

import contextlib
import functools

import torch
import torch.nn.functional as F

from conan_fgw_tpu_torch.ops.cuda import _build, launches
from conan_fgw_tpu_torch.ops.fgw.coupling import fgw_coupling

# the largest N of csrc/fgw.cu's <N, PAD> templates; above it, the global route
LARGEST_TEMPLATE = 128
_NAMES = ("Ms", "C1s", "C2s", "ps", "qs", "T0s")


def fgw_couplings_plain(Ms, C1s, C2s, ps, qs, T0s, n=None, **solver):
    """Plain PyTorch version: ``(T (S, N, N), diverged (S,) int32)``. With
    ``n`` < N, the solve of the leading ``n x n`` block, its plan zero on
    the padding, as the kernel computes it."""
    N = Ms.shape[-1]
    if n is None or n == N:
        T, div = fgw_coupling(Ms, C1s, C2s, ps, qs, T0s, **solver)
        return T, div.to(torch.int32)
    T, div = fgw_coupling(Ms[:, :n, :n], C1s[:, :n, :n], C2s[:, :n, :n], ps[:, :n], qs[:, :n],
                          T0s[:, :n, :n], **solver)
    return F.pad(T, (0, N - n, 0, N - n)), div.to(torch.int32)


@functools.cache
def _resident(N: int) -> int:
    """1 where C1 and C2 fit in shared memory beside the solve's own
    matrices (N <= 96), else 0: the kernel then reads them through L2."""
    lib = _build.load_library()
    resident = int(lib.fgw_smem(N, 1) <= _build.MAX_SMEM_BYTES)
    if lib.fgw_smem(N, resident) > _build.MAX_SMEM_BYTES:
        raise ValueError(f"fgw kernel: N={N} does not fit in shared memory")
    return resident


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


def _launch(Ms, C1s, C2s, ps, qs, T0s, *, alpha, epsilon, pgd_iters, pgd_tol,
            sinkhorn_iters, sinkhorn_thr, n=None, count="fgw_couplings"):
    """Launch K3: ``(T, diverged, sinkhorn_iters_run)``, the last an ``(S,)``
    int32 count of the Sinkhorn iterations each solve ran over all its PGD
    steps (a frozen solve leaves its Sinkhorn loop early). ``N`` must be a
    multiple of 32; rows and columns ``>= n`` (default N) are padding. Up to
    ``LARGEST_TEMPLATE`` the templates run and ``launches[count]`` grows by
    one; above it the global route, with a scratch of 2 N^2 floats a solve,
    and ``launches[count + "_large"]``."""
    S, N, _ = Ms.shape
    n = N if n is None else int(n)
    dev = Ms.device
    idx = Ms.get_device()  # -1 off the card
    for name, t in zip(_NAMES, (Ms, C1s, C2s, ps, qs, T0s)):
        want = (S, N) if name in ("ps", "qs") else (S, N, N)
        if (idx < 0 or t.get_device() != idx or t.dtype != torch.float32 or not t.is_contiguous()
                or t.shape != want or t.data_ptr() % 16):
            raise ValueError(f"fgw kernel: {_complaint(name, t, dev, want)}")
    if N % 32 or N < 32:
        raise ValueError(f"fgw kernel: N={N} is not a multiple of 32")
    if not 1 <= n <= N:
        raise ValueError(f"fgw kernel: n={n} atoms outside [1, N={N}]")
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
        if N <= LARGEST_TEMPLATE:
            code = lib.fgw_couplings(*pointers, S, N, n, _resident(N), *solver, stream)
        else:
            count += "_large"
            scratch = torch.empty(lib.fgw_large_scratch_floats(S, N), device=dev)
            code = lib.fgw_couplings_large(*pointers, scratch.data_ptr(), S, N, n, *solver, stream)
    _build.check(code, count)
    launches[count] += 1
    return T, div, iters


def _solve(args, n, count, solver):
    """CUDA tensors to the kernel, CPU tensors to ``fgw_couplings_plain``;
    a mix of the two raises."""
    if all(t.device.type == "cpu" for t in args):
        return fgw_couplings_plain(*args, n=n, **solver)
    if args[0].is_cuda:
        T, div, _ = _launch(*args, n=n, count=count, **solver)
        return T, div
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
    Returns ``(T (S, N, N) f32, diverged (S,) int32 per-solve flags)``.
    CUDA tensors go to the kernel (counted as ``fgw_couplings``, or
    ``fgw_couplings_large`` above 128 atoms), CPU
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
    if not pad:
        return _solve(args, None, "fgw_couplings", solver)
    T, div = _solve(tuple(_padded(x, pad) for x in args), N, "fgw_couplings", solver)
    return T[:, :N, :N], div


def fgw_couplings(Ms, Cb, Cks, p, qs, T0s, *, alpha, epsilon, pgd_iters, pgd_tol,
                  sinkhorn_iters, sinkhorn_thr):
    """Solve the ``K`` couplings of one barycenter step of one molecule.

    Args: ``Ms``/``Cks``/``T0s`` ``(K, n, n)``, ``Cb`` ``(n, n)`` (the
    shared barycenter structure), ``p`` ``(n,)``, ``qs`` ``(K, n)``, for any
    ``n``. Returns ``(T (K, n, n), count)``, ``count``
    an int32 0-d tensor: how many of the K solves hit a Sinkhorn numerical
    failure and rolled back. The solves are padded to the next multiple of
    32 with zero structure, mass and plan, and K3 (counted as
    ``fgw_couplings_mol``, or ``fgw_couplings_mol_large`` above 128 atoms)
    leaves the padding out; on the CPU the plain version solves the leading
    n x n block of the same padded input.
    """
    K, n, _ = Ms.shape
    pad = -n % 32
    args = tuple(_padded(x, pad) for x in (Ms, Cb.expand(K, n, n), Cks, p.expand(K, n), qs, T0s))
    solver = dict(alpha=alpha, epsilon=epsilon, pgd_iters=pgd_iters, pgd_tol=pgd_tol,
                  sinkhorn_iters=sinkhorn_iters, sinkhorn_thr=sinkhorn_thr)
    T, div = _solve(args, n, "fgw_couplings_mol", solver)
    return T[:, :n, :n], div.sum(dtype=torch.int32)
