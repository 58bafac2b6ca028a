"""Masked-dense ViSNet backbone with dual (3D / barycenter) heads
(port of ``conan_fgw_tpu/models/visnet.py``).

Exponential-normal RBF with a cosine cutoff, neighbour and edge embeddings,
``num_layers`` vector-scalar interactive attention blocks (``ViSMP``)
updating scalar ``x (G, N, H)``, vector ``vec (G, N, 3, H)`` and edge
``f (G, N, N, H)`` features, then gated-equivariant heads: ``output_model``
for the 3D branch and ``output_model_bary`` for the barycenter branch.

The representation graph includes self loops (``_self_loop_graph_mask``,
whose cap counts self); the neighbour embedding and the barycenter's
structure matrix use it without them. Attention is modulated (SiLU, scaled
by the cutoff), not softmax-normalised.

Edge quantities are ``(G, N, N, H)`` tensors. The sums over sources of the
vector messages and the rejection products are written as contractions, so
that nothing of ``(G, N, N, 3, H)`` is built: the same sums as the JAX
module's, in another order. Each block is recomputed in the backward
(``torch.utils.checkpoint``), as the JAX module remats it. The lookups are
one-hot products (``ops/graph.py::embed_onehot``), whose backward sums in a
fixed order.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from conan_fgw_tpu_torch.ops.graph import embed_onehot, pairwise_distances
from conan_fgw_tpu_torch.ops.rbf import cosine_cutoff, expnorm_initial_params, expnorm_smearing


def _self_loop_graph_mask(dist, mask, cutoff: float, cap: int) -> torch.Tensor:
    """``radius_graph(loop=True, max_num_neighbors=cap)``: per target, the
    first ``cap`` in-range candidates by index, self included."""
    n = dist.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=dist.device)
    valid = mask[..., :, None] & mask[..., None, :]
    within = valid & ((dist <= cutoff) | eye)
    w = within.to(torch.int32)
    rank = torch.cumsum(w, dim=-1) - w
    return within & (rank < cap)


def _safe_norm(v: torch.Tensor, dim: int) -> torch.Tensor:
    """Norm with a defined gradient at 0 (padded atoms carry zero vectors)."""
    return torch.sqrt(torch.sum(v * v, dim=dim) + 1e-16)


def _rejection_dot(ab, ad, bd, dd):
    """``sum_c rej(a, d)_c rej(b, d)_c`` per channel, where ``rej(v, d) = v -
    (v . d) d``, from the dot products ``ab = a . b``, ``ad = a . d``,
    ``bd = b . d`` and ``dd = d . d``: ``a.b - (a.d)(b.d)(2 - d.d)``."""
    return ab - ad * bd * (2.0 - dd)[..., None]


class ExpNormalSmearing(nn.Module):
    """ViSNet's exponential-normal RBF, its ``means`` and ``betas`` constant
    buffers (the reference's ``trainable_rbf=False``)."""

    def __init__(self, num_rbf: int, cutoff: float):
        super().__init__()
        self.cutoff = cutoff
        means, betas = expnorm_initial_params(num_rbf, cutoff)
        self.register_buffer("means", means, persistent=False)
        self.register_buffer("betas", betas, persistent=False)

    def forward(self, dist):
        return expnorm_smearing(dist, self.means, self.betas, self.cutoff)


class ViSMP(nn.Module):
    """One vector-scalar interactive attention block (dense masked form).
    The last layer has no edge update. The vector layer norm is the
    reference default's identity, so the vectors enter unnormalised."""

    def __init__(self, num_heads: int, hidden_channels: int, cutoff: float,
                 last_layer: bool = False):
        super().__init__()
        H = hidden_channels
        self.num_heads, self.cutoff, self.last_layer = num_heads, cutoff, last_layer
        self.layernorm = nn.LayerNorm(H, eps=1e-5)
        self.q_proj = nn.Linear(H, H)
        self.k_proj = nn.Linear(H, H)
        self.v_proj = nn.Linear(H, H)
        self.dk_proj = nn.Linear(H, H)
        self.dv_proj = nn.Linear(H, H)
        self.vec_proj = nn.Linear(H, 3 * H, bias=False)
        self.s_proj = nn.Linear(H, 2 * H)
        self.o_proj = nn.Linear(H, 3 * H)
        if not last_layer:
            self.w_trg_proj = nn.Linear(H, H, bias=False)
            self.w_src_proj = nn.Linear(H, H, bias=False)
            self.f_proj = nn.Linear(H, H)

    def forward(self, x, vec, f, dist, dvec_unit, edge_mask):
        """``x (G, N, H)``; ``vec (G, N, 3, H)``; ``f (G, N, N, H)``;
        ``dist (G, N, N)``; ``dvec_unit[g, i, j] = unit(pos_j - pos_i)``;
        ``edge_mask (G, N, N)`` with self loops. Returns ``(dx, dvec, df)``,
        ``df`` None in the last layer."""
        G, N, H = x.shape
        nh = self.num_heads

        def heads(t):
            return t.reshape(*t.shape[:-1], nh, H // nh)

        x_ln = self.layernorm(x)
        q, k, v = heads(self.q_proj(x_ln)), heads(self.k_proj(x_ln)), heads(self.v_proj(x_ln))
        dk = heads(F.silu(self.dk_proj(f)))
        dv = heads(F.silu(self.dv_proj(f)))
        vec1, vec2, vec3 = torch.split(self.vec_proj(vec), H, dim=-1)
        vec_dot = torch.sum(vec1 * vec2, dim=-2)  # (G, N, H)

        m = edge_mask.to(x.dtype)
        # modulated attention: SiLU(sum_d q_i k_j dk_ij) * cutoff(r_ij)
        attn = torch.sum(q[:, :, None] * dk * k[:, None], dim=-1)  # (G, i, j, nh)
        attn = F.silu(attn) * (cosine_cutoff(dist, self.cutoff) * m)[..., None]
        vmsg = (v[:, None] * dv * attn[..., None]).reshape(G, N, N, H)
        s1, s2 = torch.split(F.silu(self.s_proj(vmsg)), H, dim=-1)
        # sum over sources j of (vec_j * s1_ij + s2_ij * d_ij), masked
        s1, s2 = s1 * m[..., None], s2 * m[..., None]
        vec_agg = (torch.einsum("gijh,gjch->gich", s1, vec)
                   + torch.einsum("gijh,gijc->gich", s2, dvec_unit))
        x_agg = torch.sum(vmsg * m[..., None], dim=-2)
        o1, o2, o3 = torch.split(self.o_proj(x_agg), H, dim=-1)
        dx = vec_dot * o2 + o3
        dvec = vec3 * o1[:, :, None, :] + vec_agg
        if self.last_layer:
            return dx, dvec, None

        # edge update: the rejection products of vec_i against d_ij and of
        # vec_j against -d_ij, dotted over the vector axis
        dd = torch.sum(dvec_unit * dvec_unit, dim=-1)
        w_trg, w_src = self.w_trg_proj(vec), self.w_src_proj(vec)
        w_dot = _rejection_dot(
            torch.einsum("gich,gjch->gijh", w_trg, w_src),
            torch.einsum("gich,gijc->gijh", w_trg, dvec_unit),
            torch.einsum("gjch,gijc->gijh", w_src, dvec_unit), dd)
        df = F.silu(self.f_proj(f)) * w_dot
        return dx, dvec, df * m[..., None]


class GatedEquivariantBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, scalar_activation: bool = False):
        super().__init__()
        self.scalar_activation = scalar_activation
        self.out_channels = out_channels
        self.vec1_proj = nn.Linear(in_channels, in_channels, bias=False)
        self.vec2_proj = nn.Linear(in_channels, out_channels, bias=False)
        self.lins = nn.ModuleList([nn.Linear(2 * in_channels, in_channels),
                                   nn.Linear(in_channels, 2 * out_channels)])

    def forward(self, x, v):
        vec1 = _safe_norm(self.vec1_proj(v), dim=-2)
        vec2 = self.vec2_proj(v)
        h = self.lins[1](F.silu(self.lins[0](torch.cat([x, vec1], dim=-1))))
        x, gate = torch.split(h, self.out_channels, dim=-1)
        v = gate[..., None, :] * vec2
        return (F.silu(x) if self.scalar_activation else x), v


class EquivariantScalar(nn.Module):
    def __init__(self, hidden_channels: int, output_channels: int):
        super().__init__()
        half = hidden_channels // 2
        self.blocks = nn.ModuleList([GatedEquivariantBlock(hidden_channels, half, True),
                                     GatedEquivariantBlock(half, output_channels)])

    def forward(self, x, v):
        for blk in self.blocks:
            x, v = blk(x, v)
        return x


class Atomref(nn.Module):
    """Per-element scalar reference added to atomic outputs (zeros at init)."""

    def __init__(self, max_z: int = 100):
        super().__init__()
        self.embedding = nn.Embedding(max_z, 1)

    def flax_init(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.embedding.weight)

    def forward(self, x, z):
        return x + embed_onehot(z, self.embedding.weight)


class ViSNet3D(nn.Module):
    """Dense ViSNet trunk + dual output heads (the SchNet backbone's API:
    ``forward`` for the 3D branch, ``embed_dual`` for both).

    Reference defaults: lmax 1, 8 heads, 6 layers, 32 RBFs, cutoff 5, at
    most 32 neighbours with self loops counted in the representation graph.
    The JAX module's ``vertex``, ``vecnorm_type``, ``trainable_vecnorm`` and
    ``trainable_rbf`` options are not ported: no config sets them, and the
    port has their defaults built in.
    """

    def __init__(self, hidden_channels: int = 128, num_heads: int = 8, num_layers: int = 6,
                 num_rbf: int = 32, cutoff: float = 5.0, max_neighbors: int = 32):
        super().__init__()
        H = hidden_channels
        self.cutoff, self.max_neighbors = cutoff, max_neighbors
        self.embedding = nn.Embedding(100, H)
        self.neighbor_distance_proj = nn.Linear(num_rbf, H)
        self.neighbor_combine = nn.Linear(2 * H, H)
        self.neighbor_embedding_z = nn.Embedding(100, H)
        self.edge_proj = nn.Linear(num_rbf, H)
        self.rbf = ExpNormalSmearing(num_rbf, cutoff)
        self.layers = nn.ModuleList(
            ViSMP(num_heads, H, cutoff, last_layer=(i == num_layers - 1))
            for i in range(num_layers)
        )
        self.out_norm = nn.LayerNorm(H, eps=1e-5)
        self.output_model = EquivariantScalar(H, H // 2)
        self.prior_model = Atomref()
        self.output_model_bary = EquivariantScalar(H, H // 2)
        self.prior_model_bary = Atomref()

    def trunk(self, z, pos, mask):
        """``z (G, N)``, ``pos (G, N, 3)``, ``mask (G, N)`` bool; returns
        ``(x (G, N, H), vec (G, N, 3, H), nbr (G, N, N))``, ``nbr`` the
        representation graph without self loops."""
        G, N = z.shape
        dist = pairwise_distances(pos)
        edge_mask = _self_loop_graph_mask(dist, mask, self.cutoff, self.max_neighbors)
        eye = torch.eye(N, dtype=torch.bool, device=pos.device)
        nbr = edge_mask & ~eye
        # the self loops keep distance 0 (the reference zeroes self edge weights)
        dist = torch.where(eye, torch.zeros_like(dist), dist)
        rbf = self.rbf(dist) * edge_mask[..., None]
        # unit vectors pos_j - pos_i, zero on the diagonal
        dvec = pos[:, None, :, :] - pos[:, :, None, :]
        dvec_unit = torch.where(eye[..., None], torch.zeros_like(dvec),
                                dvec / torch.clamp(dist, min=1e-12)[..., None])

        fmask = mask[..., None].to(pos.dtype)
        x = embed_onehot(z, self.embedding.weight) * fmask
        # neighbour embedding, without self loops
        c = cosine_cutoff(dist, self.cutoff) * nbr.to(x.dtype)
        w = self.neighbor_distance_proj(rbf) * c[..., None]
        x_nb = torch.einsum("gijh,gjh->gih", w, embed_onehot(z, self.neighbor_embedding_z.weight))
        x = self.neighbor_combine(torch.cat([x, x_nb], dim=-1)) * fmask
        # edge embedding (x_i + x_j) * proj(rbf) on all edges, self loops included
        f = (x[:, :, None, :] + x[:, None, :, :]) * self.edge_proj(rbf) * edge_mask[..., None]

        vec = torch.zeros((G, N, 3, x.shape[-1]), dtype=x.dtype, device=x.device)
        for layer in self.layers:
            if torch.is_grad_enabled():
                # recomputed in the backward; nothing on this path draws random
                # numbers, and reading the RNG state would break a graph capture
                dx, dv, df = checkpoint(layer, x, vec, f, dist, dvec_unit, edge_mask,
                                        use_reentrant=False, preserve_rng_state=False)
            else:
                dx, dv, df = layer(x, vec, f, dist, dvec_unit, edge_mask)
            x, vec = x + dx, vec + dv
            if df is not None:
                f = f + df
        x = self.out_norm(x) * fmask
        vec = vec * fmask[..., None]
        return x, vec, nbr

    def forward(self, z, pos, mask):
        """3D branch only (stage 1): per-node features ``(G, N, H // 2)``."""
        x, vec, _ = self.trunk(z, pos, mask)
        return self.prior_model(self.output_model(x, vec), z) * mask[..., None].to(x.dtype)

    def embed_dual(self, z, pos, mask):
        """Both heads off the shared trunk: ``(h_3d, h_bary, nbr)``."""
        x, vec, nbr = self.trunk(z, pos, mask)
        fmask = mask[..., None].to(x.dtype)
        h3 = self.prior_model(self.output_model(x, vec), z) * fmask
        hb = self.prior_model_bary(self.output_model_bary(x, vec), z) * fmask
        return h3, hb, nbr
