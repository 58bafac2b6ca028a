"""Reference-style CPU baseline for a benchmark's ``vs_baseline`` ratio (the
port's own copy of ``conan_fgw_tpu/bench_baseline.py``).

The reference stack (PyTorch + PyG + torch-scatter) re-created on its *hot
path* in plain torch: a ragged edge-list gather/scatter SchNet with dual
heads, a per-conformer two-layer GAT, and the per-molecule Python-loop FGW
barycenter with the hardcoded 5/5/5 entropic solver; and a ragged DimeNet
with triplet interactions. ``measure_reference_style_step`` and
``measure_reference_dimenet_step`` time its forward, backward and Adam step
on the CPU, as the reference would run on the same host: the denominator of
a conformer-graphs/s speed-up. It stays a per-molecule Python loop on the
CPU by design, and is not made fast.

This is an original implementation for benchmarking only (not part of the
port's training path); iteration counts and dataflow follow the call stack
in SURVEY.md §3.2. Each function draws its weights from ``torch.manual_seed(0)``
as the JAX package's copy does, so the two give the same numbers.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


def _radius_edges(pos: np.ndarray, cutoff: float = 10.0, cap: int = 32):
    """torch-cluster ``radius_graph(r, max_num_neighbors=cap)`` semantics:
    per target, the first ``cap+1`` in-range candidates in index order
    *including self*, then the self-loop dropped (so a late-indexed node can
    keep ``cap+1`` true neighbors). PyG queries radius() with cap+1 and masks
    self-loops afterwards — replicated exactly (the port's ``ops/graph.py::radius_graph_mask``
    "index" mode implements the same rule densely)."""
    n = pos.shape[0]
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    src, dst = [], []
    for i in range(n):
        cand = np.nonzero(d[i] <= cutoff)[0][: cap + 1]
        for j in cand:
            if j != i:
                src.append(int(j))
                dst.append(i)
    return np.asarray([src, dst], np.int64), d


class _SSP(nn.Module):
    def forward(self, x):
        return F.softplus(x) - math.log(2.0)


class _Interaction(nn.Module):
    def __init__(self, hidden, filters, gaussians, cutoff):
        super().__init__()
        self.filter_net = nn.Sequential(
            nn.Linear(gaussians, filters), _SSP(), nn.Linear(filters, filters)
        )
        self.lin1 = nn.Linear(hidden, filters, bias=False)
        self.lin2 = nn.Linear(filters, hidden)
        self.lin = nn.Linear(hidden, hidden)
        self.act = _SSP()
        self.cutoff = cutoff

    def forward(self, h, edge_index, edge_weight, rbf):
        src, dst = edge_index
        c = 0.5 * (torch.cos(edge_weight * math.pi / self.cutoff) + 1.0)
        w = self.filter_net(rbf) * c[:, None]
        msg = self.lin1(h)[src] * w
        agg = torch.zeros_like(self.lin1(h))
        agg.index_add_(0, dst, msg)
        return self.lin(self.act(self.lin2(agg)))


class _TorchSchNetRef(nn.Module):
    def __init__(self, hidden=128, filters=128, gaussians=50, blocks=3, cutoff=10.0):
        super().__init__()
        self.embedding = nn.Embedding(100, hidden)
        self.blocks = nn.ModuleList(
            [_Interaction(hidden, filters, gaussians, cutoff) for _ in range(blocks)]
        )
        half = hidden // 2
        self.lin1, self.lin2 = nn.Linear(hidden, half), nn.Linear(half, half)
        self.lin1_bary, self.lin2_bary = nn.Linear(hidden, half), nn.Linear(half, half)
        self.act = _SSP()
        offset = torch.linspace(0.0, cutoff, gaussians)
        self.register_buffer("offset", offset)
        self.coeff = -0.5 / float(offset[1] - offset[0]) ** 2

    def forward(self, z, edge_index, edge_weight):
        rbf = torch.exp(self.coeff * (edge_weight[:, None] - self.offset) ** 2)
        h = self.embedding(z)
        for blk in self.blocks:
            h = h + blk(h, edge_index, edge_weight, rbf)
        h3 = self.act(self.lin2(self.lin1(h)))
        hb = self.act(self.lin2_bary(self.lin1_bary(h)))
        return h3, hb


class _TorchGATRef(nn.Module):
    def __init__(self, in_dim=9, out=64, edge_dim=3):
        super().__init__()
        self.l1 = _GATConvRef(in_dim, out, edge_dim)
        self.l2 = _GATConvRef(out, out, edge_dim)

    def forward(self, x, edge_index, edge_attr):
        return self.l2(self.l1(x, edge_index, edge_attr), edge_index, edge_attr).sum(0)


class _GATConvRef(nn.Module):
    """PyG ``GATConv(edge_dim=E, add_self_loops=True)`` semantics, ragged:
    self-loops appended with the *mean of each node's incoming edges'*
    attributes (``fill_value='mean'``), logits
    ``leaky_relu(a_src·Wx_j + a_dst·Wx_i + a_edge·We_ij, 0.2)`` softmaxed per
    target in-neighborhood, bias added after aggregation — the exact rules
    the dense ``DenseGATConv`` implements (models/gat.py)."""

    def __init__(self, in_dim, out, edge_dim):
        super().__init__()
        self.lin = nn.Linear(in_dim, out, bias=False)
        self.lin_e = nn.Linear(edge_dim, out, bias=False)
        self.a_src = nn.Parameter(torch.randn(out) * 0.1)
        self.a_dst = nn.Parameter(torch.randn(out) * 0.1)
        self.a_edge = nn.Parameter(torch.randn(out) * 0.1)
        self.bias = nn.Parameter(torch.zeros(out))

    def forward(self, x, edge_index, edge_attr):
        n = x.shape[0]
        src, dst = edge_index
        # add_self_loops(fill_value='mean'): loop attr = mean of incoming attrs
        loop_attr = torch.zeros(n, edge_attr.shape[1])
        loop_attr.index_add_(0, dst, edge_attr)
        deg = torch.zeros(n).index_add_(0, dst, torch.ones(dst.shape[0]))
        loop_attr = loop_attr / deg.clamp(min=1.0)[:, None]
        loops = torch.arange(n)
        src = torch.cat([src, loops])
        dst = torch.cat([dst, loops])
        ea = torch.cat([edge_attr, loop_attr], 0)

        xs = self.lin(x)
        ep = self.lin_e(ea)
        logit = F.leaky_relu(
            xs[src] @ self.a_src + xs[dst] @ self.a_dst + ep @ self.a_edge, 0.2
        )
        # segment softmax over incoming edges
        m = torch.full((n,), -1e30)
        m = m.scatter_reduce(0, dst, logit, reduce="amax")
        e = torch.exp(logit - m[dst])
        denom = torch.zeros(n).index_add_(0, dst, e) + 1e-16
        alpha = e / denom[dst]
        out = torch.zeros_like(xs).index_add_(0, dst, alpha[:, None] * xs[src])
        return out + self.bias


def _sinkhorn_log_t(p, q, cost, eps, iters=5, thr=1e-2):
    mr = -cost / eps
    u = torch.zeros_like(p)
    v = torch.zeros_like(q)
    logp, logq = torch.log(p), torch.log(q)
    for i in range(iters):
        v = logq - torch.logsumexp(mr + u[:, None], dim=0)
        u = logp - torch.logsumexp(mr + v[None, :], dim=1)
        if i == 0:
            col = torch.exp(mr + u[:, None] + v[None, :]).sum(0)
            if torch.norm(col - q) < thr:
                break
    return torch.exp(mr + u[:, None] + v[None, :])


def _fgw_barycenter_t(Ys, Cs, alpha=0.1, eps=0.1, outer=5, pgd=5, sk=5,
                      fixed_structure=False):
    K, N, D = Ys.shape
    p = torch.full((N,), 1.0 / N)
    lam = 1.0 / K
    C = Cs[0]
    Y = torch.zeros(N, D)
    T = [torch.outer(p, p) for _ in range(K)]
    Ms = [torch.cdist(Y, Ys[s]) ** 2 for s in range(K)]
    for _ in range(outer):
        with torch.no_grad():
            for s in range(K):
                constC = ((C**2) @ p)[:, None] + ((Cs[s] ** 2) @ p)[None, :]
                t = T[s]
                for it in range(pgd):
                    grad = alpha * 2 * (constC - C @ t @ (2 * Cs[s]).T) + (1 - alpha) * Ms[s]
                    t = _sinkhorn_log_t(p, p, grad, eps, sk)
                T[s] = t
        Y = (1.0 / p)[:, None] * sum(lam * (T[s] @ Ys[s]) for s in range(K))
        Ms = [torch.cdist(Y, Ys[s]) ** 2 for s in range(K)]
        if not fixed_structure:  # DimeNet keeps init_C (dimenet.py:235-260)
            C = sum(lam * (T[s] @ Cs[s] @ T[s].T) for s in range(K)) / torch.outer(p, p)
    return Y, C


def measure_reference_style_step(
    batch_molecules, steps: int = 3, hidden: int = 128, use_barycenter: bool = True
) -> float:
    """Seconds per training step of the reference-style CPU pipeline.

    ``batch_molecules``: list of (z, pos(K,n,3), x2d, bonds, battr, y).
    """
    torch.manual_seed(0)
    schnet = _TorchSchNetRef(hidden=hidden)
    gat = _TorchGATRef()
    half = hidden // 2
    t3d, tcov, tbary = nn.Linear(half, half), nn.Linear(half, half), nn.Linear(half, half)
    head = nn.Linear(half, 1)
    params = (
        list(schnet.parameters()) + list(gat.parameters()) + list(t3d.parameters())
        + list(tcov.parameters()) + list(tbary.parameters()) + list(head.parameters())
    )
    opt = torch.optim.Adam(params, lr=5e-4)

    # precompute ragged graphs per conformer (the DataLoader worker's job)
    prepared = []
    for z, pos, x2d, bonds, battr, y in batch_molecules:
        confs = []
        for k in range(pos.shape[0]):
            ei, dmat = _radius_edges(pos[k])
            ew = dmat[ei[0], ei[1]]
            confs.append((torch.tensor(ei), torch.tensor(ew, dtype=torch.float32)))
        be = np.concatenate([bonds, bonds[:, ::-1]], 0).T
        ba = np.concatenate([battr, battr], 0)
        prepared.append(
            (
                torch.tensor(z, dtype=torch.long),
                confs,
                torch.tensor(x2d, dtype=torch.float32),
                torch.tensor(be), torch.tensor(ba, dtype=torch.float32),
                torch.tensor([y], dtype=torch.float32),
            )
        )

    times = []
    for step in range(steps + 1):
        t0 = time.perf_counter()
        preds, ys = [], []
        for z, confs, x2d, be, ba, y in prepared:
            x3d_list, yb_in, cs = [], [], []
            n = z.shape[0]
            for ei, ew in confs:
                h3, hb = schnet(z, ei, ew)
                x3d_list.append(h3.sum(0))
                shifted = hb + 0.5
                lo, hi = shifted.min(), shifted.max()
                yb_in.append(0.1 + (shifted - lo) * 1.9 / (hi - lo))
                adj = torch.zeros(n, n)
                adj[ei[0], ei[1]] = 1.0
                cs.append(adj)
            x3d = torch.stack(x3d_list).mean(0)
            x = t3d(x3d) + tcov(gat(x2d, be, ba))
            if use_barycenter:
                Yb, _ = _fgw_barycenter_t(torch.stack(yb_in), torch.stack(cs))
                x = x + 0.2 * tbary(Yb.sum(0))
            preds.append(head(x))
            ys.append(y)
        loss = F.mse_loss(torch.stack(preds).squeeze(-1), torch.stack(ys).squeeze(-1))
        opt.zero_grad()
        loss.backward()
        opt.step()
        if step > 0:  # skip warmup
            times.append(time.perf_counter() - t0)
    return float(np.mean(times))


class _TorchDimeNetRef(nn.Module):
    """Reference-style DimeNet hot path (dimenet.py:93-341 dataflow): ragged
    edge messages with triplet (k->j->i) directional interactions — Bessel
    RBF on distances, radial x angular SBF on triplet angles, bilinear
    triplet aggregation via index_add scatter, before/after-skip residual
    MLPs, per-layer output blocks summed into dual per-atom heads. Sizes
    mirror the ``DimeNet3D`` defaults (hidden 128, 6 blocks, 3 radial,
    2 spherical, 8 bilinear, cutoff 5.0)."""

    def __init__(self, hidden=128, blocks=6, radial=3, spherical=2,
                 bilinear=8, cutoff=5.0, out=64):
        super().__init__()
        self.cutoff, self.radial, self.spherical = cutoff, radial, spherical
        self.hidden = hidden
        self.emb = nn.Embedding(95, hidden)
        self.edge_mlp = nn.Linear(2 * hidden + radial, hidden)
        self.lin_rbf = nn.ModuleList(nn.Linear(radial, hidden, bias=False) for _ in range(blocks))
        self.lin_kj = nn.ModuleList(nn.Linear(hidden, hidden) for _ in range(blocks))
        self.lin_ji = nn.ModuleList(nn.Linear(hidden, hidden) for _ in range(blocks))
        self.lin_sbf = nn.ModuleList(
            nn.Linear(radial * spherical, bilinear, bias=False) for _ in range(blocks)
        )
        self.W = nn.ParameterList(
            nn.Parameter(torch.randn(hidden, bilinear, hidden) * 0.01) for _ in range(blocks)
        )
        self.before_skip = nn.ModuleList(nn.Linear(hidden, hidden) for _ in range(blocks))
        self.after_skip = nn.ModuleList(
            nn.Sequential(nn.Linear(hidden, hidden), _SSP(), nn.Linear(hidden, hidden))
            for _ in range(blocks)
        )
        self.out_rbf = nn.ModuleList(
            nn.Linear(radial, hidden, bias=False) for _ in range(blocks + 1)
        )
        self.out_mlp = nn.ModuleList(
            nn.Sequential(nn.Linear(hidden, hidden), _SSP(), nn.Linear(hidden, out))
            for _ in range(blocks + 1)
        )
        self.out_mlp_b = nn.ModuleList(
            nn.Sequential(nn.Linear(hidden, hidden), _SSP(), nn.Linear(hidden, out))
            for _ in range(blocks + 1)
        )
        self.act = _SSP()

    @staticmethod
    def prepare_geometry(pos, cutoff, radial, spherical, cap=32):
        """Edges, triplet indices, RBF and SBF for one conformer — the
        DataLoader-worker share of the reference pipeline, computed once per
        conformer outside the timed step (conservative for the baseline).
        Neighbors are capped at ``cap`` per target in index order — the
        reference's ``radius_graph(max_num_neighbors=32)`` rule."""
        n = pos.shape[0]
        d = torch.cdist(pos, pos)
        mask = (d <= cutoff) & ~torch.eye(n, dtype=torch.bool)
        # first-cap-by-index per target (column), like _radius_edges
        keep = torch.zeros_like(mask)
        for i in range(n):
            cand = torch.nonzero(mask[:, i]).flatten()[:cap]
            keep[cand, i] = True
        mask = keep
        src, dst = torch.nonzero(mask, as_tuple=True)  # j -> i edges
        dji = d[src, dst]
        freq = torch.arange(1, radial + 1, dtype=torch.float32) * math.pi
        rbf = torch.sin(freq[None, :] * dji[:, None] / cutoff) / dji[:, None]
        # triplets: edge e1 = (k->j), edge e2 = (j->i), k != i
        e = src.shape[0]
        idx_kj, idx_ji = [], []
        by_dst = [[] for _ in range(n)]
        for eid in range(e):
            by_dst[int(src[eid])].append(eid)  # edges INTO j feed (j->i)
        for e2 in range(e):
            j, i = int(src[e2]), int(dst[e2])
            for e1 in by_dst[j]:
                if int(src[e1]) != i:
                    idx_kj.append(e1)
                    idx_ji.append(e2)
        idx_kj = torch.tensor(idx_kj, dtype=torch.long)
        idx_ji = torch.tensor(idx_ji, dtype=torch.long)
        # angle basis (cos^s, s < spherical) x radial basis of d_kj
        vkj = pos[src[idx_kj]] - pos[dst[idx_kj]]
        vji = pos[dst[idx_ji]] - pos[src[idx_ji]]
        cosa = (vkj * vji).sum(-1) / (
            vkj.norm(dim=-1) * vji.norm(dim=-1) + 1e-12
        )
        ang = torch.stack([cosa**s for s in range(spherical)], -1)
        sbf = (rbf[idx_kj][:, :, None] * ang[:, None, :]).reshape(
            idx_kj.shape[0], -1
        )
        return (src, dst, rbf, idx_kj, idx_ji, sbf)

    def forward(self, z, geom):
        n = z.shape[0]
        src, dst, rbf, idx_kj, idx_ji, sbf = geom

        h = self.emb(z)
        m = self.act(self.edge_mlp(torch.cat([h[src], h[dst], rbf], -1)))
        outs = torch.zeros(n, self.out_mlp[0][-1].out_features)
        outs_b = torch.zeros_like(outs)

        def collect(layer, msgs):
            per_edge = self.out_rbf[layer](rbf) * msgs
            agg = torch.zeros(n, self.hidden).index_add(0, dst, per_edge)
            return self.out_mlp[layer](agg), self.out_mlp_b[layer](agg)

        o, ob = collect(0, m)
        outs, outs_b = outs + o, outs_b + ob
        for b in range(len(self.W)):
            x_ji = self.act(self.lin_ji[b](m))
            x_kj = self.act(self.lin_kj[b](m)) * self.lin_rbf[b](rbf)
            tri = torch.einsum(
                "eh,hbo,eb->eo", x_kj[idx_kj], self.W[b], self.lin_sbf[b](sbf)
            )
            agg = torch.zeros_like(m).index_add(0, idx_ji, tri)
            m2 = x_ji + agg
            m2 = self.act(self.before_skip[b](m2)) + m
            m = self.after_skip[b](m2) + m2
            o, ob = collect(b + 1, m)
            outs, outs_b = outs + o, outs_b + ob
        return outs, outs_b, (src, dst)


def measure_reference_dimenet_step(batch_molecules, steps: int = 2) -> float:
    """Seconds per training step of the reference-style CPU DimeNet pipeline
    at the bench's ``dimenet_n96`` shape: per-conformer DimeNet forward,
    conformer-mean fusion, fixed-structure FGW barycenter (alpha=0.5,
    init_C kept — dimenet.py:235-260), dual heads, Adam."""
    torch.manual_seed(0)
    net = _TorchDimeNetRef()
    half = 64
    t3d, tbary, head = nn.Linear(half, half), nn.Linear(half, half), nn.Linear(half, 1)
    params = (
        list(net.parameters()) + list(t3d.parameters())
        + list(tbary.parameters()) + list(head.parameters())
    )
    opt = torch.optim.Adam(params, lr=5e-4)
    prepared = []
    for z, pos, _x2d, _b, _ba, y in batch_molecules:
        pos_t = torch.tensor(pos, dtype=torch.float32)
        geoms = [
            _TorchDimeNetRef.prepare_geometry(pos_t[k], net.cutoff, net.radial,
                                              net.spherical)
            for k in range(pos_t.shape[0])
        ]
        prepared.append((
            torch.tensor(z, dtype=torch.long), geoms,
            torch.tensor([y], dtype=torch.float32),
        ))
    times = []
    for step in range(steps + 1):
        t0 = time.perf_counter()
        preds, ys = [], []
        for z, geoms, y in prepared:
            n = z.shape[0]
            x3d_list, yb_in, cs = [], [], []
            for geom in geoms:
                h3, hb, (src, dst) = net(z, geom)
                x3d_list.append(h3.sum(0))
                shifted = hb + 0.5
                lo, hi = shifted.min(), shifted.max()
                yb_in.append(0.1 + (shifted - lo) * 1.9 / (hi - lo + 1e-12))
                adj = torch.zeros(n, n)
                adj[src, dst] = 1.0
                cs.append(adj)
            x = t3d(torch.stack(x3d_list).mean(0))
            Yb, _ = _fgw_barycenter_t(
                torch.stack(yb_in), torch.stack(cs), alpha=0.5,
                fixed_structure=True,
            )
            x = x + 0.2 * tbary(Yb.sum(0))
            preds.append(head(x))
            ys.append(y)
        loss = F.mse_loss(torch.stack(preds).squeeze(-1), torch.stack(ys).squeeze(-1))
        opt.zero_grad()
        loss.backward()
        opt.step()
        if step > 0:
            times.append(time.perf_counter() - t0)
    return float(np.mean(times))
