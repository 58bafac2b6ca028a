"""Fused SchNet cfconv: CUDA kernels K1 (forward) and K2 (backward).

Replaces ``conan_fgw_tpu/ops/pallas/cfconv.py::fused_cfconv`` (the Pallas
``_kernel`` of ``_fused_fwd_impl`` and ``_bwd_kernel`` of
``_fused_bwd_impl``). The kernels live in ``csrc/cfconv.cu``; its header
says what bounds them on this card and how the design answers it.

``cfconv(pos, mask, x, w1, b1, w2, b2, ...)`` computes per conformer graph
``m_i = sum_j W(d_ij) gate_ij x_j`` with the filter MLP ``W = ssp(rbf @ w1 +
b1) @ w2 + b2``. For CUDA tensors it runs K1 forward and K2 backward through
one ``torch.autograd.Function`` (no gradient w.r.t. ``pos`` or ``mask``); for
CPU tensors it runs ``_cfconv_plain``, the plain PyTorch version.

Both kernels are operation-bound: the filter MLP is over 99% of their work.
Its five products run on the tensor cores in bf16 with a three-term split
(``a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi``, f32 sums), which keeps about
16 bits of each operand; one TF32 pass keeps 11 and does not hold the 5e-4
contract with any margin. Work items are (graph, 8 target rows) for K1 and
(graph, 8 source atoms) for K2, over a compacted edge list in tiles of 32
edges; each item sums its own output rows on the tensor cores and writes
them once. Both run a persistent grid of about one block per SM. K2's blocks
keep their weight-gradient partials in registers over a partition of the
items fixed by the mask, and a second kernel sums the partials in a fixed
order, so K2 is deterministic. Two widths are compiled (``BUILT``): F = 128
filters with up to 64 Gaussians (the regression model) and F = 256 with up to
16 (the classification model, 10 Gaussians), where the blocks split W2 in
slabs: K1 by output filter, K2 by the filters of ``h``, whose four parts of
``dx`` a third kernel sums in a fixed order. The wrapper refuses other
shapes. Each width counts its launches under its own name (``kernel_name``).
``split_mm``, ``edge_list`` and ``cfconv_edges`` restate the kernels'
arithmetic and edge order in plain PyTorch so the CPU tests can check them.
"""

from __future__ import annotations

import contextlib
import functools
import math

import torch

from conan_fgw_tpu_torch.data.packing import DEFAULT_BUCKETS
from conan_fgw_tpu_torch.ops.cuda import _build, launches
from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask
from conan_fgw_tpu_torch.ops.rbf import gaussian_smearing, shifted_softplus

MAX_ATOMS = DEFAULT_BUCKETS[-1]
# what csrc/cfconv.cu is compiled for: filters F -> the Gaussians it takes
# (their padded count KG), and the rows of one K1 work item (R1) and
# sources of one K2 work item (R2)
BUILT = {128: 64, 256: 16}
K1_ROWS, K2_ROWS = 4, 8


def kernel_name(kernel: str, filters: int) -> str:
    """The launch-count name of K1 (``"cfconv_fwd"``) or K2
    (``"cfconv_bwd"``) at a width: F = 128 keeps the plain name, F = 256 is
    ``"cfconv_fwd_f256"``."""
    return kernel if filters == 128 else f"{kernel}_f{filters}"


def _cfconv_plain(pos, mask, x, w1, b1, w2, b2, cutoff=10.0, num_gaussians=50, max_neighbors=32):
    """Plain PyTorch formulation; materialises the (G, N, N, F) filter."""
    dist = pairwise_distances(pos)
    nbr = radius_graph_mask(dist, mask > 0.5, cutoff, max_neighbors)
    rbf = gaussian_smearing(dist, num_gaussians, 0.0, cutoff)
    w = shifted_softplus(rbf @ w1 + b1) @ w2 + b2
    env = 0.5 * (torch.cos(dist * math.pi / cutoff) + 1.0)
    gate = torch.where(nbr, env, torch.zeros_like(env)).to(x.dtype)
    return torch.einsum("...ijf,...ij,...jf->...if", w, gate, x)


def round_bits(t: torch.Tensor, drop: int) -> torch.Tensor:
    """Round float32 to nearest on its bits, ties away from zero, clearing
    the low ``drop`` mantissa bits: 16 gives bf16, as the kernels split
    their operands, and 13 gives TF32 (``cvt.rna.tf32.f32``)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


def split_mm(a: torch.Tensor, b: torch.Tensor, passes: int = 3, drop: int = 16) -> torch.Tensor:
    """``a @ b`` as the kernels' tensor-core products compute it, with f32
    sums. ``passes=3`` is their split ``a_lo b_hi + a_hi b_lo + a_hi b_hi``
    with ``a_hi = bf16(a)`` and ``a_lo = bf16(a - a_hi)``; ``passes=1`` is a
    single pass on operands rounded to ``drop`` bits fewer."""
    ah, bh = round_bits(a, drop), round_bits(b, drop)
    if passes == 1:
        return ah @ bh
    al, bl = round_bits(a - ah, drop), round_bits(b - bh, drop)
    return al @ bh + ah @ bl + ah @ bh


def edge_list(pos, mask, cutoff, max_neighbors, source_major=False):
    """The kernels' compacted edge list: index tensors ``(g, i, j)`` of every
    edge with a non-zero gate (j a message source for target i), in the
    order the kernels walk them. K1 (``source_major=False``) goes by graph,
    then target i, then source j; K2 by graph, then source j, then target
    i. A work item is a run of ``K1_ROWS`` consecutive rows (``K2_ROWS``
    sources), and the kernels cut this sequence into runs of tiles, so it is
    also the order within and across items and runs."""
    nbr = radius_graph_mask(pairwise_distances(pos), mask > 0.5, cutoff, max_neighbors)
    if not source_major:
        return torch.nonzero(nbr, as_tuple=True)
    g, j, i = torch.nonzero(nbr.transpose(-1, -2), as_tuple=True)
    return g, i, j


def cfconv_edges(pos, mask, x, w1, b1, w2, b2, gout, cutoff=10.0, max_neighbors=32,
                 mm=torch.matmul, slab=None):
    """K1's forward and K2's backward as the kernels compute them, over
    their edge lists, with the filter MLP's five products done by ``mm``
    (``split_mm`` for the tensor cores' arithmetic). ``slab`` splits K2's
    filters of ``h`` as the F = 256 kernel does: each slab's part of the
    filter W (``b2`` in the first) gives its own part of ``dx``, and the
    parts are summed in slab order. Returns ``out`` and ``(dx, dw1, db1,
    dw2, db2)`` for the cotangent ``gout``."""
    G, N, F = x.shape
    dist = pairwise_distances(pos)

    def mlp(g, i, j):
        d = dist[g, i, j]
        rbf = gaussian_smearing(d, w1.shape[0], 0.0, cutoff)
        pre = mm(rbf, w1) + b1
        h = shifted_softplus(pre)
        gate = 0.5 * (torch.cos(d * math.pi / cutoff) + 1.0)
        return rbf, pre, h, mm(h, w2) + b2, gate[:, None]

    g, i, j = edge_list(pos, mask, cutoff, max_neighbors)
    *_, w, gate = mlp(g, i, j)
    out = torch.zeros(G * N, F).index_add_(0, g * N + i, w * gate * x[g, j]).view(G, N, F)
    g, i, j = edge_list(pos, mask, cutoff, max_neighbors, source_major=True)
    rbf, pre, h, w, gate = mlp(g, i, j)
    gg = gout[g, i] * gate
    dw = gg * x[g, j]
    if slab is None:
        dx = torch.zeros(G * N, F).index_add_(0, g * N + j, w * gg).view(G, N, F)
    else:
        dx = torch.zeros(G * N, F)
        for c in range(0, F, slab):
            w_part = mm(h[:, c:c + slab], w2[c:c + slab]) + (b2 if c == 0 else 0.0)
            dx = dx + torch.zeros(G * N, F).index_add_(0, g * N + j, w_part * gg)
        dx = dx.view(G, N, F)
    dpre = mm(dw, w2.t()) * torch.sigmoid(pre)
    return out, (dx, mm(rbf.t(), dpre), dpre.sum(0), mm(h.t(), dw), dw.sum(0))


def _check(pos, mask, x, w1, b1, w2, b2):
    tensors = dict(pos=pos, mask=mask, x=x, w1=w1, b1=b1, w2=w2, b2=b2)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"cfconv kernel: {name} must lie on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"cfconv kernel: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cfconv kernel: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"cfconv kernel: {name} must be 16-byte aligned")
    G, N, F = x.shape
    Gs = w1.shape[0]
    want = dict(pos=(G, N, 3), mask=(G, N), w1=(Gs, F), b1=(F,), w2=(F, F), b2=(F,))
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"cfconv kernel: {name} has shape {tuple(tensors[name].shape)}, want {shape}")
    if N > MAX_ATOMS:
        raise ValueError(f"cfconv kernel: N={N} exceeds the largest bucket {MAX_ATOMS}")
    if F not in BUILT or not 2 <= Gs <= BUILT[F]:
        built = ", ".join(f"F={f} with 2..{gs} Gaussians" for f, gs in BUILT.items())
        raise ValueError(f"cfconv kernel: built for {built}; got F={F} with {Gs}")
    return G, N, F, Gs


def _blocks(lib, x, G, N, F, bwd):
    """The persistent grid: about one block per SM, a multiple of the
    width's slabs, and no more blocks per slab than K2 has work items."""
    slabs = lib.cfconv_slabs(F, int(bwd))
    return slabs * max(1, min(_sm_count(x.device) // slabs, G * -(-N // K2_ROWS)))


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _on(device: torch.device):
    """Context that makes ``device`` current for a launch (a no-op when it is)."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def cfconv_forward(pos, mask, x, w1, b1, w2, b2, cutoff, max_neighbors):
    """Launch K1: messages ``(G, N, F)``."""
    G, N, F, Gs = _check(pos, mask, x, w1, b1, w2, b2)
    lib = _build.load_library()
    blocks = _blocks(lib, x, G, N, F, bwd=False)
    out = torch.empty_like(x)
    item_tiles = torch.empty(G * -(-N // K1_ROWS), dtype=torch.int32, device=x.device)
    with _on(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.cfconv_fwd(
            *(t.data_ptr() for t in (pos, mask, x, w1, b1, w2, b2, out, item_tiles)),
            G, N, F, Gs, float(cutoff), int(max_neighbors), blocks, stream,
        )
    _build.check(code, "cfconv_fwd")
    launches[kernel_name("cfconv_fwd", F)] += 1
    return out


def cfconv_backward(pos, mask, x, w1, b1, w2, b2, g, cutoff, max_neighbors):
    """Launch K2: ``(dx, dw1, db1, dw2, db2)`` for the cotangent ``g``, the
    weight gradients summed over all graphs."""
    G, N, F, Gs = _check(pos, mask, x, w1, b1, w2, b2)
    if g.shape != x.shape or g.dtype != torch.float32 or not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError("cfconv backward: the cotangent must be a contiguous, 16-byte aligned"
                         " f32 (G, N, F) tensor")
    lib = _build.load_library()
    blocks = _blocks(lib, x, G, N, F, bwd=True)
    slabs = lib.cfconv_slabs(F, 1)
    dx = torch.empty_like(x)
    dx_parts = torch.empty((slabs, *x.shape), device=x.device) if slabs > 1 else dx
    dw1, db1 = torch.empty_like(w1), torch.empty_like(b1)
    dw2, db2 = torch.empty_like(w2), torch.empty_like(b2)
    partial = torch.empty((blocks, lib.cfconv_partial_floats(F, Gs)), device=x.device)
    item_tiles = torch.empty(G * -(-N // K2_ROWS), dtype=torch.int32, device=x.device)
    with _on(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.cfconv_bwd(
            *(t.data_ptr() for t in (pos, mask, x, w1, b1, w2, b2, g, dx, dx_parts, dw1, db1, dw2,
                                     db2, partial, item_tiles)),
            G, N, F, Gs, float(cutoff), int(max_neighbors), blocks, stream,
        )
    _build.check(code, "cfconv_bwd")
    launches[kernel_name("cfconv_bwd", F)] += 1
    return dx, dw1, db1, dw2, db2


def _aligned(t):
    """``t`` contiguous and 16-byte aligned, copied only if it is not."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class _CFConvFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pos, mask, x, w1, b1, w2, b2, cutoff, max_neighbors):
        args = [_aligned(t) for t in (pos, mask, x, w1, b1, w2, b2)]
        ctx.save_for_backward(*args)
        ctx.params = (cutoff, max_neighbors)
        return cfconv_forward(*args, cutoff, max_neighbors)

    @staticmethod
    def backward(ctx, g):
        grads = cfconv_backward(*ctx.saved_tensors, _aligned(g), *ctx.params)
        return (None, None, *grads, None, None)


def cfconv(pos, mask, x, w1, b1, w2, b2, cutoff=10.0, num_gaussians=50, max_neighbors=32):
    """Batched cfconv: ``pos (G, N, 3)``, ``mask (G, N)`` (0/1 floats),
    ``x (G, N, F)`` -> messages ``(G, N, F)``.

    CUDA tensors go to the kernels, CPU tensors to ``_cfconv_plain``.
    ``max_neighbors=None`` keeps every neighbour in range.
    """
    cap = x.shape[-2] if max_neighbors is None else int(max_neighbors)
    if x.device.type == "cpu":
        return _cfconv_plain(pos, mask, x, w1, b1, w2, b2, cutoff, num_gaussians, cap)
    if x.is_cuda:
        if w1.shape[0] != num_gaussians:
            raise ValueError(f"w1 has {w1.shape[0]} rows, want num_gaussians={num_gaussians}")
        return _CFConvFunction.apply(pos, mask, x, w1, b1, w2, b2, cutoff, cap)
    raise ValueError(f"cfconv: unsupported device {x.device}")
