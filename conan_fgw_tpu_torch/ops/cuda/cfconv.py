"""Fused SchNet cfconv: CUDA kernels K1 (forward) and K2 (backward).

Replaces ``conan_fgw_tpu/ops/pallas/cfconv.py::fused_cfconv`` (the Pallas
``_kernel`` and ``_bwd_kernel``). The kernels live in ``csrc/cfconv.cu``; its
header says what bounds them on this card and how the design answers it.

``cfconv(pos, mask, x, w1, b1, w2, b2, ...)`` computes per conformer graph
``m_i = sum_j W(d_ij) gate_ij x_j`` with the filter MLP ``W = ssp(rbf @ w1 +
b1) @ w2 + b2``. For CUDA tensors it runs K1 forward and K2 backward through
one ``torch.autograd.Function`` (no gradient w.r.t. ``pos`` or ``mask``); for
CPU tensors it runs ``_cfconv_plain``, the plain PyTorch version.
"""

from __future__ import annotations

import math

import torch

from conan_fgw_tpu_torch.data.packing import DEFAULT_BUCKETS
from conan_fgw_tpu_torch.ops.cuda import _build, launches
from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask
from conan_fgw_tpu_torch.ops.rbf import gaussian_smearing, shifted_softplus

MAX_ATOMS = DEFAULT_BUCKETS[-1]


def _cfconv_plain(pos, mask, x, w1, b1, w2, b2, cutoff=10.0, num_gaussians=50, max_neighbors=32):
    """Plain PyTorch formulation; materialises the (G, N, N, F) filter."""
    dist = pairwise_distances(pos)
    nbr = radius_graph_mask(dist, mask > 0.5, cutoff, max_neighbors)
    rbf = gaussian_smearing(dist, num_gaussians, 0.0, cutoff)
    w = shifted_softplus(rbf @ w1 + b1) @ w2 + b2
    env = 0.5 * (torch.cos(dist * math.pi / cutoff) + 1.0)
    gate = torch.where(nbr, env, torch.zeros_like(env)).to(x.dtype)
    return torch.einsum("...ijf,...ij,...jf->...if", w, gate, x)


def _check(pos, mask, x, w1, b1, w2, b2):
    tensors = dict(pos=pos, mask=mask, x=x, w1=w1, b1=b1, w2=w2, b2=b2)
    for name, t in tensors.items():
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"cfconv kernel: {name} must lie on {x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"cfconv kernel: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"cfconv kernel: {name} must be contiguous")
    G, N, F = x.shape
    Gs = w1.shape[0]
    want = dict(pos=(G, N, 3), mask=(G, N), w1=(Gs, F), b1=(F,), w2=(F, F), b2=(F,))
    for name, shape in want.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"cfconv kernel: {name} has shape {tuple(tensors[name].shape)}, want {shape}")
    if N > MAX_ATOMS:
        raise ValueError(f"cfconv kernel: N={N} exceeds the largest bucket {MAX_ATOMS}")
    if Gs < 2 or F > 1024:
        raise ValueError(f"cfconv kernel: needs num_gaussians >= 2 and F <= 1024, got {Gs}, {F}")
    return G, N, F, Gs


def cfconv_forward(pos, mask, x, w1, b1, w2, b2, cutoff, max_neighbors):
    """Launch K1: messages ``(G, N, F)``."""
    G, N, F, Gs = _check(pos, mask, x, w1, b1, w2, b2)
    lib = _build.load_library()
    smem = lib.cfconv_fwd_smem(N, F, Gs)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"cfconv forward needs {smem} B of shared memory")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.cfconv_fwd(
            *(t.data_ptr() for t in (pos, mask, x, w1, b1, w2, b2, out)),
            G, N, F, Gs, float(cutoff), int(max_neighbors), stream,
        )
    _build.check(code, "cfconv_fwd")
    launches["cfconv_fwd"] += 1
    return out


def cfconv_backward(pos, mask, x, w1, b1, w2, b2, g, cutoff, max_neighbors):
    """Launch K2: ``(dx, dw1, db1, dw2, db2)`` for the cotangent ``g``, the
    weight gradients summed over all graphs."""
    G, N, F, Gs = _check(pos, mask, x, w1, b1, w2, b2)
    if g.shape != x.shape or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("cfconv backward: the cotangent must be a contiguous f32 (G, N, F) tensor")
    w2t = w2.t().contiguous()
    lib = _build.load_library()
    smem = lib.cfconv_bwd_smem(N, F, Gs)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"cfconv backward needs {smem} B of shared memory (N={N}, F={F})")
    dx = torch.empty_like(x)
    dw1, db1 = torch.empty_like(w1), torch.empty_like(b1)
    dw2, db2 = torch.empty_like(w2), torch.empty_like(b2)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    row_groups = max(1, min(N, -(-2 * sms // G)))  # about two blocks per SM
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.cfconv_bwd(
            *(t.data_ptr() for t in (pos, mask, x, w1, b1, w2, w2t, b2, g, dx, dw1, db1, dw2, db2)),
            G, N, F, Gs, float(cutoff), int(max_neighbors), row_groups, stream,
        )
    _build.check(code, "cfconv_bwd")
    launches["cfconv_bwd"] += 1
    return dx, dw1, db1, dw2, db2


class _CFConvFunction(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pos, mask, x, w1, b1, w2, b2, cutoff, max_neighbors):
        ctx.save_for_backward(pos, mask, x, w1, b1, w2, b2)
        ctx.params = (cutoff, max_neighbors)
        return cfconv_forward(pos, mask, x, w1, b1, w2, b2, cutoff, max_neighbors)

    @staticmethod
    def backward(ctx, g):
        grads = cfconv_backward(*ctx.saved_tensors, g.contiguous(), *ctx.params)
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
