"""Masked-dense DimeNet backbone (port of ``conan_fgw_tpu/models/dimenet.py``).

Spherical and radial Bessel bases, per-edge hidden states, bilinear triplet
interactions and per-node output blocks summed over all interaction stages.
Both branches of the model (3D and barycenter) take the same node outputs;
the barycenter is solved with ``alpha=0.5`` and a fixed structure
(``train/runner.py::build_model``).

Neighbour slots: the radius graph is capped as torch-cluster caps it, and
every per-edge tensor lives on compact ``(G, N, M, ...)`` slot arrays,
``M = min(cap + 1, N)``, gathered from the dense mask by a stable argsort;
the triplet reduction runs over ``(G, N, M, M)`` neighbours of neighbours.
Gathers of differentiable rows (the atom embeddings, each block's
``x_kj``) go through ``ops/graph.py::gather_rows``, whose backward sums in a
fixed order. Each interaction block is recomputed in the backward
(``torch.utils.checkpoint``), as the JAX module remats it.

``compute_dtype`` bf16 (a config's ``compute_dtype: bfloat16``; f16 alike)
makes only what the JAX module makes bf16, the N·M² triplet tensors: the spherical
basis, ``lin_sbf``'s output (flax ``Dense(dtype=bf16)``,
``models/schnet.py::dense``) and the gathered ``x_kj``. The triplet
contraction ``s1`` sums the bf16 products in f32 and comes out in f32
(``f32_product``), as the JAX einsum's ``preferred_element_type`` has it;
the edge-state chain and the output blocks stay f32 (the JAX module builds
its ``OutputBlock``s without the compute type, ``dimenet.py:262-265``).

Reference registry hyper-parameters: hidden = feat_dim, out = feat_dim / 2,
6 blocks, 8 bilinear, 2 spherical, 3 radial, cutoff 5, envelope exponent 5,
1 residual layer before the skip and 2 after, 3 output layers.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from conan_fgw_tpu_torch.device import compute_dtype as resolve_compute_dtype
from conan_fgw_tpu_torch.models.schnet import dense
from conan_fgw_tpu_torch.ops.graph import (
    embed_onehot,
    gather_rows,
    pairwise_distances,
    radius_graph_mask,
)


def _spherical_jn_roots(num_spherical: int, num_roots: int) -> np.ndarray:
    """First ``num_roots`` positive roots of ``j_l`` for ``l < num_spherical``."""
    from scipy import optimize, special

    roots = np.zeros((num_spherical, num_roots))
    for l in range(num_spherical):
        def f(x, l=l):
            return special.spherical_jn(l, x)
        found, x, step = [], 1e-3, 0.1
        prev = f(x)
        while len(found) < num_roots:
            x2 = x + step
            cur = f(x2)
            if prev * cur < 0:
                found.append(optimize.brentq(f, x, x2))
            x, prev = x2, cur
        roots[l] = found
    return roots


def _nonzero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, torch.full_like(x, 1e-12), x)


def _spherical_jn(l: int, x: torch.Tensor) -> torch.Tensor:
    """Closed-form spherical Bessel ``j_l`` for ``l <= 3``."""
    xs = _nonzero(x)
    if l == 0:
        return torch.sin(xs) / xs
    if l == 1:
        return torch.sin(xs) / xs**2 - torch.cos(xs) / xs
    if l == 2:
        return (3.0 / xs**2 - 1.0) * torch.sin(xs) / xs - 3.0 * torch.cos(xs) / xs**2
    if l == 3:
        return (15.0 / xs**3 - 6.0 / xs) * torch.sin(xs) / xs - (
            15.0 / xs**2 - 1.0) * torch.cos(xs) / xs
    raise NotImplementedError(f"l={l}")


def _legendre_cos(l: int, cos_t: torch.Tensor) -> torch.Tensor:
    """Real m=0 spherical harmonic of the angle for ``l <= 3`` (normalised)."""
    if l == 0:
        return torch.full_like(cos_t, 0.5 / math.sqrt(math.pi))
    if l == 1:
        return math.sqrt(3.0 / (4 * math.pi)) * cos_t
    if l == 2:
        return math.sqrt(5.0 / (16 * math.pi)) * (3 * cos_t**2 - 1)
    if l == 3:
        return math.sqrt(7.0 / (16 * math.pi)) * (5 * cos_t**3 - 3 * cos_t)
    raise NotImplementedError(f"l={l}")


def envelope(x: torch.Tensor, p: int) -> torch.Tensor:
    """DimeNet's smooth polynomial envelope of ``x = d / cutoff``, zero from 1 on."""
    a = -(p + 1) * (p + 2) / 2.0
    b = float(p * (p + 2))
    c = -p * (p + 1) / 2.0
    val = 1.0 / _nonzero(x) + a * x ** (p - 1) + b * x**p + c * x ** (p + 1)
    return torch.where(x < 1.0, val, torch.zeros_like(val))


def glorot_orthogonal_(w: torch.Tensor, generator: torch.Generator, scale: float = 2.0) -> None:
    """PyG's ``glorot_orthogonal``: an orthogonal matrix rescaled so that
    ``var(w) = scale / (fan_in + fan_out)``."""
    nn.init.orthogonal_(w, generator=generator)
    fan_out, fan_in = w.shape
    w.mul_(torch.sqrt(scale / ((fan_in + fan_out) * w.var(unbiased=False))))


class _F32Product(torch.autograd.Function):
    """``a @ b`` of two bf16 (or f16) tensors with f32 sums and an f32 result; the
    gradients are the f32 products with the other operand, rounded to the
    operand's type (what JAX's ``preferred_element_type=float32`` VJP gives).
    On the card one ``torch.bmm(..., out_dtype=float32)``; on the CPU, where
    that has no kernel, the product of the widened operands (bf16 and f16
    products are exact in f32)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.is_cuda:
            out = torch.bmm(a.reshape(-1, *a.shape[-2:]), b.reshape(-1, *b.shape[-2:]),
                            out_dtype=torch.float32)
            return out.reshape(*a.shape[:-1], b.shape[-1])
        return a.float() @ b.float()

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = (g @ b.float().transpose(-1, -2)).to(a.dtype)
        gb = (a.float().transpose(-1, -2) @ g).to(b.dtype)
        return ga, gb


def f32_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched ``a @ b``, in f32 for bf16 or f16 operands (``_F32Product``),
    in their own type otherwise."""
    if a.dtype in (torch.bfloat16, torch.float16):
        return _F32Product.apply(a, b)
    return a @ b


class ResidualLayer(nn.Module):
    def __init__(self, hidden: int):
        super().__init__()
        self.lins = nn.ModuleList([nn.Linear(hidden, hidden), nn.Linear(hidden, hidden)])

    def forward(self, x):
        return x + F.silu(self.lins[1](F.silu(self.lins[0](x))))


class InteractionBlock(nn.Module):
    def __init__(self, hidden: int, num_bilinear: int, num_spherical: int, num_radial: int,
                 num_before_skip: int, num_after_skip: int,
                 compute_dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_before_skip = num_before_skip
        self.lin_rbf = nn.Linear(num_radial, hidden, bias=False)
        self.lin_sbf = nn.Linear(num_spherical * num_radial, num_bilinear, bias=False)
        self.lin_ji = nn.Linear(hidden, hidden)
        self.lin_kj = nn.Linear(hidden, hidden)
        self.bilinear = nn.Parameter(torch.empty(hidden, num_bilinear, hidden))
        self.lin = nn.Linear(hidden, hidden)
        self.residuals = nn.ModuleList(
            ResidualLayer(hidden) for _ in range(num_before_skip + num_after_skip))

    def forward(self, x, rbf, sbf, slot, tmask, idx):
        """``x (G, N, M, H)`` edge states [target i, neighbour slot m];
        ``rbf (G, N, M, R)``; ``sbf (G, N, M, M, S*R)`` for the triplets
        (i, m -> j, m' -> k), in ``compute_dtype``; ``slot (G, N, M)`` valid
        slots; ``tmask (G, N, M, M)`` valid triplets; ``idx (G, N, M)``
        neighbour indices."""
        dt = self.compute_dtype
        m = slot[..., None].to(x.dtype)
        sbf_b = dense(self.lin_sbf, sbf, dt)  # (G, N, M, M, nb)
        x_ji = F.silu(self.lin_ji(x))
        x_kj = F.silu(self.lin_kj(x)) * self.lin_rbf(rbf)
        # sum over the neighbours k of j: edge k -> j lives at slot (j, m'),
        # so j's slot rows are gathered up to (i, m), and the contraction over
        # m' is a batched product of (nb, M) by (M, H) per (g, i, m), in f32
        x_kj_g = gather_rows(x_kj if dt is None else x_kj.to(dt), idx)  # (G, N, M, M, H)
        s1 = f32_product((sbf_b * tmask[..., None].to(sbf_b.dtype)).transpose(-1, -2),
                         x_kj_g)  # (G, N, M, nb, H)
        H = x.shape[-1]
        agg = s1.flatten(-2) @ self.bilinear.reshape(H, -1).t()  # sum over b, l of s1 w[h, b, l]
        h = (x_ji + agg) * m
        for layer in self.residuals[: self.num_before_skip]:
            h = layer(h) * m
        h = F.silu(self.lin(h)) + x
        for layer in self.residuals[self.num_before_skip:]:
            h = layer(h) * m
        return h * m


class OutputBlock(nn.Module):
    """``lins``: the rbf projection, ``num_layers`` hidden layers and the
    output projection (flax's ``Dense_0`` to ``Dense_{num_layers + 1}``)."""

    def __init__(self, hidden: int, out_channels: int, num_radial: int, num_layers: int):
        super().__init__()
        self.lins = nn.ModuleList(
            [nn.Linear(num_radial, hidden, bias=False)]
            + [nn.Linear(hidden, hidden) for _ in range(num_layers)]
            + [nn.Linear(hidden, out_channels, bias=False)])

    def forward(self, x, rbf, slot):
        per_edge = self.lins[0](rbf) * x * slot[..., None].to(x.dtype)
        node = torch.sum(per_edge, dim=-2)
        for lin in self.lins[1:-1]:
            node = F.silu(lin(node))
        return self.lins[-1](node)


class DimeNet3D(nn.Module):
    """Dense DimeNet with the SchNet backbone's API (``forward``,
    ``embed_dual``); ``out_channels`` 0 means ``hidden_channels // 2``;
    ``compute_dtype`` a name ``device.py::compute_dtype`` takes (the
    triplet tensors' type)."""

    def __init__(self, hidden_channels: int = 128, out_channels: int = 0, num_blocks: int = 6,
                 num_bilinear: int = 8, num_spherical: int = 2, num_radial: int = 3,
                 cutoff: float = 5.0, envelope_exponent: int = 5, num_before_skip: int = 1,
                 num_after_skip: int = 2, num_output_layers: int = 3, max_neighbors: int = 32,
                 compute_dtype: str = "float32"):
        super().__init__()
        H = hidden_channels
        dt = self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.cutoff, self.max_neighbors = cutoff, max_neighbors
        self.envelope_exponent = envelope_exponent
        self.num_spherical, self.num_radial, self.num_bilinear = num_spherical, num_radial, num_bilinear
        self.embedding = nn.Embedding(95, H)
        self.edge_emb_dense = nn.Linear(3 * H, H)
        self.rbf_emb = nn.Linear(num_radial, H)
        self.bessel_freq = nn.Parameter(torch.empty(num_radial))
        self.blocks = nn.ModuleList(
            InteractionBlock(H, num_bilinear, num_spherical, num_radial, num_before_skip,
                             num_after_skip, dt)
            for _ in range(num_blocks))
        self.outputs = nn.ModuleList(
            OutputBlock(H, out_channels or H // 2, num_radial, num_output_layers)
            for _ in range(num_blocks + 1))
        roots = _spherical_jn_roots(num_spherical, num_radial).astype(np.float32)
        self.register_buffer("sbf_roots", torch.from_numpy(roots), persistent=False)

    def flax_init(self, generator: torch.Generator) -> None:
        """The JAX module's initialisers: ``glorot_orthogonal`` (scale 2) on
        the dense layers, xavier on each output block's last, zero biases,
        the embedding uniform on +-sqrt(3), ``bilinear`` normal with standard
        deviation ``2 / num_bilinear`` and the Bessel frequencies ``n pi``."""
        last = {id(out.lins[-1].weight) for out in self.outputs}
        for name, p in self.named_parameters():
            if name == "embedding.weight":
                nn.init.uniform_(p, -math.sqrt(3.0), math.sqrt(3.0), generator=generator)
            elif name == "bessel_freq":
                p.copy_(torch.arange(1, self.num_radial + 1, dtype=p.dtype) * math.pi)
            elif name.endswith("bias"):
                nn.init.zeros_(p)
            elif name.endswith("bilinear"):
                nn.init.normal_(p, 0.0, 2.0 / self.num_bilinear, generator=generator)
            elif id(p) in last:
                nn.init.xavier_uniform_(p, generator=generator)
            else:
                glorot_orthogonal_(p, generator)

    def _bessel_rbf(self, dist):
        """Radial Bessel basis with the smooth envelope (trainable frequencies)."""
        x = dist / self.cutoff
        env = envelope(x, self.envelope_exponent)
        return env[..., None] * torch.sin(self.bessel_freq * x[..., None])

    def _spherical_basis(self, dist_kj, cos_angle):
        """``(..., S*R)`` basis: ``j_l(z_ln d / cutoff) * Y_l(angle)``."""
        x = dist_kj / self.cutoff
        env = envelope(x, self.envelope_exponent)
        parts = []
        for l in range(self.num_spherical):
            radial = torch.stack([_spherical_jn(l, self.sbf_roots[l, n] * x) * env
                                  for n in range(self.num_radial)], dim=-1)
            parts.append(radial * _legendre_cos(l, cos_angle)[..., None])
        return torch.cat(parts, dim=-1)

    def trunk(self, z, pos, mask):
        """``z (G, N)``, ``pos (G, N, 3)``, ``mask (G, N)`` bool; returns the
        node outputs ``(G, N, out)`` and the neighbour mask ``(G, N, N)``."""
        G, N = z.shape
        fdt = pos.dtype
        dist = pairwise_distances(pos)
        nbr = radius_graph_mask(dist, mask, self.cutoff, self.max_neighbors)
        # torch-cluster keeps the first cap + 1 candidates with self, then
        # drops the self loop: a row keeps cap + 1 sources when its own index
        # falls outside the kept window
        m_slots = min(self.max_neighbors + 1, N)
        # compact slots: a stable argsort puts the capped in-range sources
        # first, by index; invalid slots hold in-range indices and are masked
        # out of every reduction
        order = torch.argsort((~nbr).to(torch.int8), dim=-1, stable=True)
        idx = order[..., :m_slots]  # (G, N, M): j = idx[i, m]
        slot = torch.arange(m_slots, device=pos.device) < nbr.sum(-1)[..., None]
        dist_e = torch.gather(dist, -1, idx)  # (G, N, M)
        rbf = self._bessel_rbf(dist_e) * slot[..., None].to(fdt)

        # triplets (i, m -> j, m' -> k): edge j -> i aggregates edges k -> j,
        # k != i. The reference's quirk is kept: the angle is taken at atom i
        # between (j - i) and (k - i), and the radial part uses d(k -> j)
        rel_ij = gather_rows(pos, idx) - pos[:, :, None, :]
        idx_k = gather_rows(idx, idx)  # (G, N, M, M): k = idx[j, m']
        rel_ik = gather_rows(pos, idx_k) - pos[:, :, None, None, :]
        rel_ij = rel_ij[:, :, :, None, :].expand_as(rel_ik)
        dots = torch.sum(rel_ij * rel_ik, dim=-1)
        crosses = torch.linalg.cross(rel_ij, rel_ik, dim=-1)
        angle = torch.atan2(torch.sqrt(torch.sum(crosses**2, dim=-1) + 1e-18), dots)
        sbf = self._spherical_basis(gather_rows(dist_e, idx), torch.cos(angle))
        i_ids = torch.arange(N, device=pos.device)[None, :, None, None]
        tmask = slot[:, :, :, None] & gather_rows(slot, idx) & (idx_k != i_ids)
        sbf = sbf * tmask[..., None].to(fdt)
        if self.compute_dtype is not None:
            sbf = sbf.to(self.compute_dtype)

        # embedding block: per-edge state from the atom embeddings and rbf
        emb = embed_onehot(z, self.embedding.weight)
        emb_j = gather_rows(emb, idx)  # (G, N, M, H)
        e = torch.cat([emb[:, :, None, :].expand_as(emb_j), emb_j, self.rbf_emb(rbf)], dim=-1)
        x = F.silu(self.edge_emb_dense(e)) * slot[..., None].to(fdt)

        p_node = self.outputs[0](x, rbf, slot)
        for blk, out in zip(self.blocks, self.outputs[1:]):
            if torch.is_grad_enabled():
                # recomputed in the backward; nothing on this path draws random
                # numbers, and reading the RNG state would break a graph capture
                x = checkpoint(blk, x, rbf, sbf, slot, tmask, idx,
                               use_reentrant=False, preserve_rng_state=False)
            else:
                x = blk(x, rbf, sbf, slot, tmask, idx)
            p_node = p_node + out(x, rbf, slot)
        return p_node * mask[..., None].to(fdt), nbr

    def forward(self, z, pos, mask):
        """Per-node outputs ``(G, N, out_channels)``."""
        return self.trunk(z, pos, mask)[0]

    def embed_dual(self, z, pos, mask):
        """DimeNet has no separate barycenter head: both branches take the
        same node outputs. Returns ``(h_3d, h_bary, nbr)``."""
        p, nbr = self.trunk(z, pos, mask)
        return p, p, nbr
