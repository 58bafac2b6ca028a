"""Fused SchNet cfconv: CUDA kernels K1 (forward) and K2 (backward).

Replaces ``conan_fgw_tpu/ops/pallas/cfconv.py::fused_cfconv`` (the Pallas
``_kernel`` of ``_fused_fwd_impl`` and ``_bwd_kernel`` of
``_fused_bwd_impl``). The kernels live in ``csrc/cfconv.cu``; its header
says what bounds them on this card and how the design answers it. Graphs
above ``LARGEST_TEMPLATE`` (128) atoms take ``csrc/cfconv_wgmma.cu``'s
route, for any N (``route``): edge lists built once a call in whole tiles,
the filter MLP's products on warpgroup ``wgmma`` in 3xTF32; K1 and K2 at
F = 256 with the weights split once as they are staged (K2 as a dx kernel,
K1's body over the source-major list, and a weight-gradient kernel), K2 at
F = 128 as one kernel that takes dx and the weight gradients from one pass
of layer 1, the weights the products' A operand split as they are loaded
and the tile's activations the B operand; its header has the design;
``wgmma_plan`` asks the library for a call's grids and buffers. Their
launches count under their own names (``kernel_name(..., large=True)``).

``cfconv(pos, mask, x, w1, b1, w2, b2, ...)`` computes per conformer graph
``m_i = sum_j W(d_ij) gate_ij x_j`` with the filter MLP ``W = ssp(rbf @ w1 +
b1) @ w2 + b2``. For CUDA tensors it runs K1 forward and K2 backward through
one ``torch.autograd.Function`` (no gradient w.r.t. ``pos`` or ``mask``); for
CPU tensors it runs ``_cfconv_plain``, the plain PyTorch version.

Both kernels are operation-bound: the filter MLP is over 99% of their work.
Its five products run on the tensor cores in TF32 with a three-term split
(``a b ~ a_big b_big + a_big b_small + a_small b_big``, f32 sums: 3xTF32),
which keeps about 22 bits of each operand. One TF32 pass keeps 11 and does
not hold the 5e-4 contract with any margin; a three-term bf16 split keeps 16
and holds it, but its rounding showed in the attention head's gradient at
N=64, where a softmax over 160 nearly equal conformers leaves the small
residue of large terms. Work items are (graph, 8 target rows) for K1 and
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

Node features in bf16 or f16 (a ``compute_dtype: bfloat16`` or
``float16`` trunk): ``x`` and the cotangent may be bf16, as the Pallas
kernels take them, or f16; the weights stay f32. Each kernel has a bf16 and
an f16 variant (their own launch names, ``kernel_name``) that widen x and
the cotangent to f32 as they load them, compute as the f32 variant does and
round ``out`` and ``dx`` once to the node type, to nearest even; the weight
gradients stay f32. So a variant gives the f32 variant's result on the
widened inputs, rounded: for bf16 what the JAX model's cast to f32, f32
kernel and cast back give (``conan_fgw_tpu/models/schnet.py:92-98``). The
JAX model sends an f16 trunk to its XLA cfconv (the Pallas kernels take
f32 and bf16 only), which runs the filter MLP in f16; ``_cfconv_plain``
does the same on the CPU, and the card's f16 variant is the more precise.

The neighbour cap: ``cap_mode="index"`` keeps torch-cluster's first
neighbours by index (the Pallas kernels' rule), ``"nearest"`` the nearest
(``ops/graph.py::radius_graph_mask``), a runtime argument of both kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import math

import torch

from conan_fgw_tpu_torch.ops.cuda import _build, launches
from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask
from conan_fgw_tpu_torch.ops.rbf import gaussian_smearing, shifted_softplus

# the largest N of csrc/cfconv.cu's kernels; above it, route()'s
LARGEST_TEMPLATE = 128
# csrc/cfconv_wgmma.cu's edge tiles: edges a tile (one wgmma M) and keys
# (K1's target rows, K2's sources) a work item
WG_EDGES, WG_KEYS = 64, 4
# what csrc/cfconv.cu is compiled for: filters F -> the Gaussians it takes
# (their padded count KG), and the rows of one K1 work item (R1) and
# sources of one K2 work item (R2)
BUILT = {128: 64, 256: 16}
K1_ROWS, K2_ROWS = 4, 8
# the node-feature types and neighbour-cap rules the kernels take, by the
# codes of their C entry points
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
CAP_MODES = {"index": 0, "nearest": 1}
_SUFFIX = {torch.bfloat16: "_bf16", torch.float16: "_f16"}


def kernel_name(kernel: str, filters: int, dtype: torch.dtype = torch.float32,
                large: bool = False) -> str:
    """The launch-count name of K1 (``"cfconv_fwd"``) or K2
    (``"cfconv_bwd"``) at a width and node-feature type: F = 128 in f32
    keeps the plain name, F = 256 adds ``"_f256"``, the kernels of graphs
    above 128 atoms ``"_large"``, bf16 ``"_bf16"`` and f16 ``"_f16"``
    (``"cfconv_fwd_f256_large_bf16"``)."""
    name = kernel if filters == 128 else f"{kernel}_f{filters}"
    return name + ("_large" if large else "") + _SUFFIX.get(dtype, "")


def _cfconv_plain(pos, mask, x, w1, b1, w2, b2, cutoff=10.0, num_gaussians=50, max_neighbors=32,
                  cap_mode="index"):
    """Plain PyTorch formulation; materialises the (G, N, N, F) filter. A
    bf16 ``x`` is widened and the f32 result rounded to bf16, as the kernels'
    bf16 variants do; autograd then gives a bf16 ``dx``. An f16 ``x`` runs
    JAX's XLA cfconv in f16 (``conan_fgw_tpu/models/schnet.py:100-109``):
    the filter MLP and the gated filter in f16, the sum over neighbours of
    the f16 products in f32, the messages rounded to f16."""
    dist = pairwise_distances(pos)
    nbr = radius_graph_mask(dist, mask > 0.5, cutoff, max_neighbors, cap_mode)
    rbf = gaussian_smearing(dist, num_gaussians, 0.0, cutoff)
    env = 0.5 * (torch.cos(dist * math.pi / cutoff) + 1.0)
    if x.dtype == torch.float16:
        dt = x.dtype
        w = shifted_softplus(rbf.to(dt) @ w1.to(dt) + b1.to(dt)) @ w2.to(dt) + b2.to(dt)
        w = w * (env * nbr.to(env.dtype))[..., None].to(dt)
        return torch.einsum("...ijf,...jf->...if", w.float(), x.float()).to(dt)
    w = shifted_softplus(rbf @ w1 + b1) @ w2 + b2
    gate = torch.where(nbr, env, torch.zeros_like(env)).to(w.dtype)
    return torch.einsum("...ijf,...ij,...jf->...if", w, gate, x.to(w.dtype)).to(x.dtype)


def round_bits(t: torch.Tensor, drop: int) -> torch.Tensor:
    """Round float32 to nearest on its bits, ties away from zero, clearing
    the low ``drop`` mantissa bits: 16 gives bf16, as the kernels split
    their operands, and 13 gives TF32 (``cvt.rna.tf32.f32``)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + (1 << (drop - 1))) & -(1 << drop)).view(torch.float32)


def split_mm(a: torch.Tensor, b: torch.Tensor, passes: int = 3, drop: int = 13) -> torch.Tensor:
    """``a @ b`` as the kernels' tensor-core products compute it, with f32
    sums. ``passes=3`` is the split ``a_lo b_hi + a_hi b_lo + a_hi b_hi``
    with ``a_hi`` = ``a`` rounded to ``drop`` bits fewer and ``a_lo`` =
    ``a - a_hi`` rounded so: the default 13 is the cfconv and FGW kernels'
    3xTF32, 16 a three-term bf16 split. ``passes=1`` is a single pass on
    operands rounded to ``drop`` bits fewer."""
    ah, bh = round_bits(a, drop), round_bits(b, drop)
    if passes == 1:
        return ah @ bh
    al, bl = round_bits(a - ah, drop), round_bits(b - bh, drop)
    return al @ bh + ah @ bl + ah @ bh


def edge_list(pos, mask, cutoff, max_neighbors, source_major=False, cap_mode="index"):
    """The kernels' compacted edge list: index tensors ``(g, i, j)`` of every
    edge with a non-zero gate (j a message source for target i), in the
    order the kernels walk them. K1 (``source_major=False``) goes by graph,
    then target i, then source j; K2 by graph, then source j, then target
    i. A work item is a run of ``K1_ROWS`` consecutive rows (``K2_ROWS``
    sources), and the kernels cut this sequence into runs of tiles, so it is
    also the order within and across items and runs."""
    nbr = radius_graph_mask(pairwise_distances(pos), mask > 0.5, cutoff, max_neighbors, cap_mode)
    if not source_major:
        return torch.nonzero(nbr, as_tuple=True)
    g, j, i = torch.nonzero(nbr.transpose(-1, -2), as_tuple=True)
    return g, i, j


def cfconv_edges(pos, mask, x, w1, b1, w2, b2, gout, cutoff=10.0, max_neighbors=32,
                 mm=torch.matmul, slab=None, cap_mode="index"):
    """K1's forward and K2's backward as the kernels compute them, over
    their edge lists, with the filter MLP's five products done by ``mm``
    (``split_mm`` for the tensor cores' arithmetic). ``slab`` splits K2's
    filters of ``h`` as the F = 256 kernel does: each slab's part of the
    filter W (``b2`` in the first) gives its own part of ``dx``, and the
    parts are summed in slab order. Returns ``out`` and ``(dx, dw1, db1,
    dw2, db2)`` for the cotangent ``gout``. A bf16 or f16 ``x`` and
    ``gout`` are those variants' mode: widened to f32, with ``out`` and
    ``dx`` rounded to the node type at the end."""
    if x.dtype in (torch.bfloat16, torch.float16):
        out, (dx, *dw) = cfconv_edges(pos, mask, x.float(), w1, b1, w2, b2, gout.float(), cutoff,
                                      max_neighbors, mm, slab, cap_mode)
        return out.to(x.dtype), (dx.to(x.dtype), *dw)
    G, N, F = x.shape
    dist = pairwise_distances(pos)

    def mlp(g, i, j):
        d = dist[g, i, j]
        rbf = gaussian_smearing(d, w1.shape[0], 0.0, cutoff)
        pre = mm(rbf, w1) + b1
        h = shifted_softplus(pre)
        gate = 0.5 * (torch.cos(d * math.pi / cutoff) + 1.0)
        return rbf, pre, h, mm(h, w2) + b2, gate[:, None]

    g, i, j = edge_list(pos, mask, cutoff, max_neighbors, cap_mode=cap_mode)
    *_, w, gate = mlp(g, i, j)
    out = x.new_zeros(G * N, F).index_add_(0, g * N + i, w * gate * x[g, j]).view(G, N, F)
    g, i, j = edge_list(pos, mask, cutoff, max_neighbors, source_major=True, cap_mode=cap_mode)
    rbf, pre, h, w, gate = mlp(g, i, j)
    gg = gout[g, i] * gate
    dw = gg * x[g, j]
    if slab is None:
        dx = x.new_zeros(G * N, F).index_add_(0, g * N + j, w * gg).view(G, N, F)
    else:
        dx = x.new_zeros(G * N, F)
        for c in range(0, F, slab):
            w_part = mm(h[:, c:c + slab], w2[c:c + slab]) + (b2 if c == 0 else 0.0)
            dx = dx + x.new_zeros(G * N, F).index_add_(0, g * N + j, w_part * gg)
        dx = dx.view(G, N, F)
    dpre = mm(dw, w2.t()) * torch.sigmoid(pre)
    return out, (dx, mm(rbf.t(), dpre), dpre.sum(0), mm(h.t(), dw), dw.sum(0))


WG_PAD_KEY = 2**31 - 1  # the key of a padding record


def wgmma_edge_tiles(pos, mask, cutoff, max_neighbors, source_major=False, cap_mode="index",
                     tile=WG_EDGES):
    """csrc/cfconv_wgmma.cu's edge tiles, as its edge kernels write them:
    ``(key, other, dist, gate, tile_item, item_start, item_tiles)``, the
    first four ``(T, tile)`` (``WG_EDGES``, or K2 at F = 128's
    ``WG_BWD128_EDGES``). The work items are runs of ``WG_KEYS`` keys of a
    graph in graph-major order (keys are K1's targets i, or for
    ``source_major`` K2's sources j), each item's edges in ``edge_list``'s
    order in whole tiles, its last tile padded with records of key
    ``WG_PAD_KEY``, other 0 and gate 0."""
    G, N, _ = pos.shape
    g, i, j = edge_list(pos, mask, cutoff, max_neighbors, source_major, cap_mode)
    key, other = (j, i) if source_major else (i, j)
    d = pairwise_distances(pos)[g, i, j]
    gate = 0.5 * (torch.cos(d * math.pi / cutoff) + 1.0)
    per_graph = -(-N // WG_KEYS)
    item = g * per_graph + torch.div(key, WG_KEYS, rounding_mode="floor")
    counts = torch.bincount(item, minlength=G * per_graph)
    item_tiles = -(-counts // tile)
    item_start = torch.cumsum(item_tiles, 0) - item_tiles
    T = int(item_tiles.sum())
    first = torch.cumsum(counts, 0) - counts  # each item's first edge in the list
    slot = item_start[item] * tile + torch.arange(len(item)) - first[item]
    keys = torch.full((T * tile,), WG_PAD_KEY, dtype=torch.int64)
    others = torch.zeros(T * tile, dtype=torch.int64)
    dist, gates = torch.zeros(T * tile), torch.zeros(T * tile)
    keys[slot], others[slot], dist[slot], gates[slot] = key, other, d, gate
    tile_item = torch.repeat_interleave(torch.arange(G * per_graph), item_tiles)
    return (*(t.view(T, tile) for t in (keys, others, dist, gates)), tile_item, item_start,
            item_tiles)


def _tile_teams(T, teams):
    """The tiles of each of ``teams`` blocks that split ``T`` evenly."""
    return [range(p * T // teams, (p + 1) * T // teams) for p in range(teams)]


# the f32 constants of csrc/cfconv.cu / cfconv_wgmma.cu's softplus
LOG2E_F = torch.tensor(1.44269504088896340736, dtype=torch.float32)
LOG2_F = torch.tensor(0.69314718055994530942, dtype=torch.float32)


def rbf_approx(d: torch.Tensor, num_gaussians: int, cutoff: float) -> torch.Tensor:
    """K2 at F = 128's Gaussian RBF in f32: ``2^((coeff log2 e) (d - mu_k)^2)``
    with the kernels' centres (``mu_k = k step`` below the middle, ``cutoff -
    (Gs - 1 - k) step`` above it, as ``torch.linspace`` places them) and
    ``coeff = -0.5 / step^2`` (the kernel's ex2.approx errs by at most 2^-22
    of its result)."""
    step = torch.tensor(cutoff / (num_gaussians - 1), dtype=torch.float32)
    coeff = -0.5 / (step * step)
    k = torch.arange(num_gaussians)
    mu = torch.where(k < num_gaussians // 2, step * k,
                     cutoff - step * (num_gaussians - 1 - k)).to(torch.float32)
    diff = d[..., None] - mu
    return torch.exp2((coeff * LOG2E_F) * (diff * diff))


def ssp_approx(pre: torch.Tensor) -> torch.Tensor:
    """csrc/cfconv_wgmma.cu's softplus(x) - log 2 in f32: ``max(x, 0) +
    (log2(1 + t) - 1) ln 2`` with ``t = 2^(-|x| log2 e)``, each step rounded
    to f32 (the kernel's ex2.approx and lg2.approx add at most 2^-22 of
    their result and 2^-22 absolute to these)."""
    t = torch.exp2(-pre.abs() * LOG2E_F)
    return pre.clamp(min=0) + (torch.log2(1 + t) - 1) * LOG2_F


def sigmoid_from_ssp(h: torch.Tensor) -> torch.Tensor:
    """K2 at F = 128's sigmoid (ssp'), from ``h = ssp(pre)`` as its split
    parts hold it: ``sigmoid(pre) = 1 - 2^(-h log2 e) / 2`` in f32 (the
    kernel's ex2.approx errs by at most 2^-22 of its result); where it
    cancels, at ``pre << 0``, its error is absolute, near 4e-7."""
    big = round_bits(h, 13)
    return 1 - 0.5 * torch.exp2(-(big + round_bits(h - big, 13)) * LOG2E_F)


# csrc/cfconv_wgmma.cu's split of the work: K1's output slabs by width,
# the weight-gradient kernel's (K2 at F = 256) block types and blocks an
# SM, and K2 at F = 128's edges a tile (one block an SM)
WG_SLABS = {128: 1, 256: 4}
WG_TYPES, WG_DW_PER_SM = 16, 2
WG_BWD128_EDGES = 32


def _split2(t: torch.Tensor) -> torch.Tensor:
    """``t`` as its two TF32 parts add up (big + small, each rounded)."""
    big = round_bits(t, 13)
    return big + round_bits(t - big, 13)


def _bwd128_emulated(pos, mask, x, w1, b1, w2, b2, gout, cutoff, max_neighbors, cap_mode, sms,
                     mm):
    """K2 at F = 128 above 128 atoms as ``cfconv_bwd_wgmma_kernel`` computes
    it: tiles of ``WG_BWD128_EDGES`` source-major edges, ``sms`` blocks on
    even runs of tiles; per tile ``rbf_approx``, layer 1 once (``pre``,
    ``ssp_approx``, ``sigmoid_from_ssp``), the filter W and its message
    (W + b2) gate g_i in its two TF32 parts summed by key (the kernel's exact
    key selector) over an item's tiles in a run; an item wholly in a run
    written as it is, an item runs share summed from its parts in block
    order (the kernel's slots and split kernel); dW = (gate g_i) x_j, dh,
    dpre; the tile's P4 (dW^T h) and P5 (rbf^T dpre) added to the block's
    partials in tile order, the blocks' partials summed in block order."""
    G, N, F = x.shape
    Gs = w1.shape[0]
    key, other, d, gate, tile_item, item_start, item_tiles = wgmma_edge_tiles(
        pos, mask, cutoff, max_neighbors, True, cap_mode, WG_BWD128_EDGES)
    graph = torch.div(tile_item, -(-N // WG_KEYS), rounding_mode="floor")[:, None]
    real = (key != WG_PAD_KEY).view(-1)
    rows = (graph * N + key.clamp(max=N - 1)).view(-1)
    g_i = gout.reshape(G * N, F)[(graph * N + other).view(-1)].view(*key.shape, F)
    dwf = (gate[..., None] * g_i) * x.reshape(G * N, F)[rows].view(*key.shape, F)
    rbf = rbf_approx(d, Gs, cutoff)
    h = ssp_approx(mm(rbf, w1) + b1)
    msg = ((mm(h, w2) + b2) * gate[..., None]) * g_i
    # per tile, the message's two parts summed by the item's key (KEYS of them)
    per_graph = -(-N // WG_KEYS)
    key0 = (tile_item % per_graph)[:, None] * WG_KEYS
    select = torch.nn.functional.one_hot((key - key0).clamp(0, WG_KEYS), WG_KEYS + 1)[..., :WG_KEYS]
    tile_rows = torch.einsum("tek,tef->tkf", select.float(), _split2(msg))
    T = key.shape[0]
    runs = [range(p * T // sms, (p + 1) * T // sms) for p in range(sms)]
    dx = torch.zeros(G * N, F)
    slots = torch.zeros(sms, 2, WG_KEYS, F)

    def put(item, part):
        k = (item % per_graph) * WG_KEYS + torch.arange(WG_KEYS)
        keep = k < N
        dx[(item // per_graph) * N + k[keep]] = part[keep]

    for p, run in enumerate(runs):
        t = run.start
        while t < run.stop:  # the run's items, each its tiles in this run
            item = int(tile_item[t])
            start, end = int(item_start[item]), int(item_start[item] + item_tiles[item])
            part = torch.zeros(WG_KEYS, F)
            for u in range(t, min(end, run.stop)):
                part += tile_rows[u]
            if start >= run.start and end <= run.stop:
                put(item, part)
            else:
                slots[p, 0 if start < run.start else 1] = part
            t = min(end, run.stop)
    for p, run in enumerate(runs):  # an item runs share, from the run it begins in
        if not len(run):
            continue
        item = int(tile_item[run.stop - 1])
        start, end = int(item_start[item]), int(item_start[item] + item_tiles[item])
        if end <= run.stop or start < run.start:
            continue
        part = slots[p, 1].clone()
        for q in range(p + 1, sms):
            if runs[q].start >= end:
                break
            if len(runs[q]):
                part += slots[q, 0]
        put(item, part)
    dpre = mm(dwf, w2.t()) * sigmoid_from_ssp(h)
    p4 = mm(dwf.transpose(1, 2), h)    # per tile: dW2^T
    p5 = mm(dpre.transpose(1, 2), rbf)  # per tile: dW1^T
    dw1, db1 = torch.zeros(Gs, F), torch.zeros(F)
    dw2, db2 = torch.zeros(F, F), torch.zeros(F)
    for run in runs:
        part2, part1 = torch.zeros(F, F), torch.zeros(F, Gs)
        for t in run:
            part2 += p4[t]
            part1 += p5[t]
        dw2 += part2.t()
        dw1 += part1.t()
        db1 += dpre[list(run)].sum((0, 1))
        db2 += dwf[list(run)].sum((0, 1))
    return dx.view(G, N, F), dw1, db1, dw2, db2


def cfconv_wgmma_emulated(pos, mask, x, w1, b1, w2, b2, gout, cutoff=10.0, max_neighbors=32,
                          cap_mode="index", sms=132, mm=split_mm):
    """K1's forward and K2's backward as the route above 128 atoms computes
    them, on the CPU. K1 at both widths and K2 at F = 256 as
    csrc/cfconv_wgmma.cu does: its edge tiles (``wgmma_edge_tiles``), the
    filter MLP's products by ``mm`` (``split_mm`` for the tensor cores'
    3xTF32), its softplus (``ssp_approx``), layer 1 in passes of 64
    channels and layer 2 of each output slab summed over them, the row sums
    in edge order, and K2's weight gradients at F = 256 by blocks of 64
    channels of h by 64 filters, each block's share of the tiles summed tile
    by tile, the partials in the reduce kernel's order (the sigmoid
    PyTorch's); K2 at F = 128 as ``_bwd128_emulated``. Returns ``out`` and
    ``(dx, dw1, db1, dw2, db2)``."""
    G, N, F = x.shape
    Gs = w1.shape[0]
    x, gout = x.float(), gout.float()

    def layer1(d, c0, c1):
        return mm(gaussian_smearing(d, Gs, 0.0, cutoff), w1[:, c0:c1]) + b1[c0:c1]

    def messages(source_major, src):
        key, other, d, gate, tile_item, _, _ = wgmma_edge_tiles(
            pos, mask, cutoff, max_neighbors, source_major, cap_mode)
        graph = torch.div(tile_item, -(-N // WG_KEYS), rounding_mode="floor")[:, None]
        h = [ssp_approx(layer1(d, c, c + 64)) for c in range(0, F, 64)]
        fo = F // WG_SLABS[F]
        slabs = []
        for o in range(0, F, fo):
            w = sum(mm(hq, w2[64 * q:64 * (q + 1), o:o + fo]) for q, hq in enumerate(h))
            slabs.append(w + b2[o:o + fo])
        msg = torch.cat(slabs, -1) * gate[..., None] * src[graph.expand_as(other), other]
        real = key != WG_PAD_KEY
        rows = (graph.expand_as(key) * N + key)[real]
        return src.new_zeros(G * N, F).index_add_(0, rows, msg[real]).view(G, N, F)

    out = messages(False, x)
    if F == 128:
        return out, _bwd128_emulated(pos, mask, x, w1, b1, w2, b2, gout, cutoff, max_neighbors,
                                     cap_mode, sms, mm)
    dx = messages(True, gout)
    # the weight-gradient kernel over the source-major tiles
    key, other, d, gate, tile_item, _, _ = wgmma_edge_tiles(
        pos, mask, cutoff, max_neighbors, True, cap_mode)
    graph = torch.div(tile_item, -(-N // WG_KEYS), rounding_mode="floor")[:, None].expand_as(key)
    jrow = torch.clamp(key, max=N - 1)
    T, nb = key.shape[0], F // 64
    teams = _tile_teams(T, max(1, sms * WG_DW_PER_SM // WG_TYPES))  # the blocks of a type
    rbf = gaussian_smearing(d, Gs, 0.0, cutoff)
    dw1, db1 = torch.zeros(Gs, F), torch.zeros(F)
    dw2, db2 = torch.zeros(F, F), torch.zeros(F)
    for cb in range(nb):
        c0 = 64 * cb
        pre = layer1(d, c0, c0 + 64)
        h, sig = ssp_approx(pre), torch.sigmoid(pre)
        for cq in range(nb):
            q0 = 64 * cq
            dwf = (gate[..., None] * gout[graph, other, q0:q0 + 64]) * x[graph, jrow, q0:q0 + 64]
            dpre = mm(dwf, w2[c0:c0 + 64, q0:q0 + 64].t()) * sig
            p4 = mm(h.transpose(1, 2), dwf)      # per tile: (64 channels, 64 filters)
            p5 = mm(rbf.transpose(1, 2), dpre)   # per tile: (Gs, 64 channels)
            for run in teams:
                part2, part1 = torch.zeros(64, 64), torch.zeros(Gs, 64)
                partb1, partb2 = torch.zeros(64), torch.zeros(64)
                for t in run:
                    part2 += p4[t]
                    part1 += p5[t]
                    partb1 += dpre[t].sum(0)
                    partb2 += dwf[t].sum(0)
                dw2[c0:c0 + 64, q0:q0 + 64] += part2
                dw1[:, c0:c0 + 64] += part1
                db1[c0:c0 + 64] += partb1
                if cb == 0:
                    db2[q0:q0 + 64] += partb2
    return out, (dx, dw1, db1, dw2, db2)


def _check(pos, mask, x, w1, b1, w2, b2):
    tensors = dict(pos=pos, mask=mask, x=x, w1=w1, b1=b1, w2=w2, b2=b2)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"cfconv kernel: {name} must lie on {x.device}")
        allowed = tuple(DTYPES) if name == "x" else (torch.float32,)
        if t.dtype not in allowed:
            raise ValueError(f"cfconv kernel: {name} must be "
                             f"{' or '.join(str(a) for a in allowed)}, got {t.dtype}")
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


def route(N: int, F: int = 128, bwd: bool = False) -> str:
    """The kernels of graphs of ``N`` atoms at width ``F``, K2's if ``bwd``:
    ``"small"`` (csrc/cfconv.cu) up to ``LARGEST_TEMPLATE``, ``"wgmma"``
    (csrc/cfconv_wgmma.cu) above it, at both widths."""
    return "small" if N <= LARGEST_TEMPLATE else "wgmma"


@dataclasses.dataclass(frozen=True)
class WgmmaPlan:
    """Grids and buffers of one call of csrc/cfconv_wgmma.cu's route, as
    its ``cfconv_wgmma_plan`` gives them (its ``Plan``)."""

    items: int           # work items: G ceil(N / WG_KEYS)
    tiles: int           # a bound on the edge tiles (items are padded to whole tiles)
    scratch_ints: int    # neighbour bits, counts by key, tiles and first tile by item, item by tile
    edge_ints: int       # 4 ints an edge record, WG_EDGES a tile
    state_floats: int    # a graph's state where it leaves shared memory, else 0
    msg_blocks: int      # K1's and K2's dx kernel's grid (0 for K2 at F = 128)
    dw_blocks: int       # K2's weight-gradient kernel's grid (at F = 128 its one kernel's), else 0
    partial_floats: int  # the weight-gradient partials (K2), else 0


def wgmma_plan(lib, G: int, N: int, F: int, Gs: int, cap: int, cap_mode: str, sms: int,
               bwd: bool) -> WgmmaPlan:
    """``WgmmaPlan`` of K1 (or K2, ``bwd``) on ``G`` graphs of ``N`` atoms at
    width ``F`` with ``Gs`` Gaussians and a neighbour cap ``cap`` on a card
    of ``sms`` SMs, from the library ``lib`` (``cfconv_wgmma_plan``)."""
    out = (ctypes.c_longlong * 8)()
    code = lib.cfconv_wgmma_plan(G, N, F, Gs, cap, CAP_MODES[cap_mode], sms, int(bwd),
                                 ctypes.addressof(out))
    _build.check(code, "cfconv_wgmma_plan")
    return WgmmaPlan(*out)


def _wgmma_scratch(plan: WgmmaPlan, device):
    """The index scratch, the edge records and the graph state (or None)."""
    scratch = torch.empty(plan.scratch_ints, dtype=torch.int32, device=device)
    edges = torch.empty(plan.edge_ints, dtype=torch.int32, device=device)
    state = torch.empty(plan.state_floats, device=device) if plan.state_floats else None
    return scratch, edges, state


def _ptr(t):
    return None if t is None else t.data_ptr()


def cfconv_forward(pos, mask, x, w1, b1, w2, b2, cutoff, max_neighbors, cap_mode="index"):
    """Launch K1: messages ``(G, N, F)`` of ``x``'s type; above
    ``LARGEST_TEMPLATE`` atoms, csrc/cfconv_wgmma.cu's K1."""
    G, N, F, Gs = _check(pos, mask, x, w1, b1, w2, b2)
    lib = _build.load_library()
    narrow = x.dtype != torch.float32
    large = route(N, F) == "wgmma"
    out = torch.empty_like(x)
    out32 = torch.empty(x.shape, device=x.device) if narrow else None  # the f32 sums
    with _on(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        head = (*(t.data_ptr() for t in (pos, mask, x, w1, b1, w2, b2, out)), _ptr(out32))
        if large:
            sms = _sm_count(x.device)
            plan = wgmma_plan(lib, G, N, F, Gs, int(max_neighbors), cap_mode, sms, bwd=False)
            scratch, edges, state = _wgmma_scratch(plan, x.device)
            code = lib.cfconv_fwd_wgmma(
                *head, scratch.data_ptr(), edges.data_ptr(), _ptr(state), G, N, F, Gs,
                float(cutoff), int(max_neighbors), CAP_MODES[cap_mode], sms, DTYPES[x.dtype],
                stream)
        else:
            blocks = _blocks(lib, x, G, N, F, bwd=False)
            item_tiles = torch.empty(G * -(-N // K1_ROWS), dtype=torch.int32, device=x.device)
            code = lib.cfconv_fwd(*head, item_tiles.data_ptr(), G, N, F, Gs, float(cutoff),
                                  int(max_neighbors), CAP_MODES[cap_mode], blocks,
                                  DTYPES[x.dtype], stream)
    name = kernel_name("cfconv_fwd", F, x.dtype, large)
    _build.check(code, name)
    launches[name] += 1
    return out


def cfconv_backward(pos, mask, x, w1, b1, w2, b2, g, cutoff, max_neighbors, cap_mode="index"):
    """Launch K2: ``(dx, dw1, db1, dw2, db2)`` for the cotangent ``g`` of
    ``x``'s type, ``dx`` of that type, the weight gradients f32 and summed
    over all graphs; above ``LARGEST_TEMPLATE`` atoms, csrc/cfconv_wgmma.cu's
    K2 (``route``)."""
    G, N, F, Gs = _check(pos, mask, x, w1, b1, w2, b2)
    if (g.shape != x.shape or g.dtype != x.dtype or g.device != x.device
            or not g.is_contiguous() or g.data_ptr() % 16):
        raise ValueError(f"cfconv backward: the cotangent must be a contiguous, 16-byte aligned"
                         f" {x.dtype} (G, N, F) tensor on {x.device}")
    lib = _build.load_library()
    narrow = x.dtype != torch.float32
    way = route(N, F, bwd=True)
    dx = torch.empty_like(x)
    dw1, db1 = torch.empty_like(w1), torch.empty_like(b1)
    dw2, db2 = torch.empty_like(w2), torch.empty_like(b2)
    grads = (dx, dw1, db1, dw2, db2)
    with _on(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        head = tuple(t.data_ptr() for t in (pos, mask, x, w1, b1, w2, b2, g, dx))
        tail = (float(cutoff), int(max_neighbors), CAP_MODES[cap_mode])
        if way == "wgmma":
            sms = _sm_count(x.device)
            plan = wgmma_plan(lib, G, N, F, Gs, int(max_neighbors), cap_mode, sms, bwd=True)
            scratch, edges, state = _wgmma_scratch(plan, x.device)
            dx32 = torch.empty(x.shape, device=x.device) if narrow else None  # the f32 sums
            partial = torch.empty(plan.partial_floats, device=x.device)
            code = lib.cfconv_bwd_wgmma(
                *head, _ptr(dx32), *(t.data_ptr() for t in grads[1:]), partial.data_ptr(),
                scratch.data_ptr(), edges.data_ptr(), _ptr(state), G, N, F, Gs, *tail, sms,
                DTYPES[x.dtype], stream)
        else:
            blocks = _blocks(lib, x, G, N, F, bwd=True)
            slabs = lib.cfconv_slabs(F, 1)
            # the f32 parts of dx the slabs sum into (one, rounded to bf16 or f16, at F=128)
            dx_parts = torch.empty((slabs, *x.shape), device=x.device) if slabs > 1 or narrow else dx
            partial = torch.empty((blocks, lib.cfconv_partial_floats(F, Gs)), device=x.device)
            item_tiles = torch.empty(G * -(-N // K2_ROWS), dtype=torch.int32, device=x.device)
            code = lib.cfconv_bwd(*head, dx_parts.data_ptr(), *(t.data_ptr() for t in grads[1:]),
                                  partial.data_ptr(), item_tiles.data_ptr(), G, N, F, Gs, *tail,
                                  blocks, DTYPES[x.dtype], stream)
    name = kernel_name("cfconv_bwd", F, x.dtype, way != "small")
    _build.check(code, name)
    launches[name] += 1
    return dx, dw1, db1, dw2, db2


def _aligned(t):
    """``t`` contiguous and 16-byte aligned, copied only if it is not."""
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


class _CFConvFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pos, mask, x, w1, b1, w2, b2, cutoff, max_neighbors, cap_mode):
        args = [_aligned(t) for t in (pos, mask, x, w1, b1, w2, b2)]
        ctx.save_for_backward(*args)
        ctx.params = (cutoff, max_neighbors, cap_mode)
        return cfconv_forward(*args, cutoff, max_neighbors, cap_mode)

    @staticmethod
    def backward(ctx, g):
        grads = cfconv_backward(*ctx.saved_tensors, _aligned(g), *ctx.params)
        return (None, None, *grads, None, None, None)


def cfconv(pos, mask, x, w1, b1, w2, b2, cutoff=10.0, num_gaussians=50, max_neighbors=32,
           cap_mode="index"):
    """Batched cfconv: ``pos (G, N, 3)``, ``mask (G, N)`` (0/1 floats),
    ``x (G, N, F)`` f32, bf16 or f16 -> messages ``(G, N, F)`` of x's type.

    CUDA tensors go to the kernels, CPU tensors to ``_cfconv_plain``.
    ``max_neighbors=None`` keeps every neighbour in range; ``cap_mode``
    ("index" or "nearest") picks which neighbours a binding cap keeps.
    """
    cap = x.shape[-2] if max_neighbors is None else int(max_neighbors)
    if cap_mode not in CAP_MODES:
        raise ValueError(f"unknown cap_mode {cap_mode!r}")
    if x.device.type == "cpu":
        return _cfconv_plain(pos, mask, x, w1, b1, w2, b2, cutoff, num_gaussians, cap, cap_mode)
    if x.is_cuda:
        if w1.shape[0] != num_gaussians:
            raise ValueError(f"w1 has {w1.shape[0]} rows, want num_gaussians={num_gaussians}")
        return _CFConvFunction.apply(pos, mask, x, w1, b1, w2, b2, cutoff, cap, cap_mode)
    raise ValueError(f"cfconv: unsupported device {x.device}")
