"""Plain reference of the ConAN SchNet model's stage-2 training step, for
the configurations whose ``reference`` is ``conan_schnet``.

It imports torch, numpy and math only: nothing of the program under test.
It takes the molecules as the traffic generator made them (``traffic.py``)
and the weights as ``make_weights`` made them, and recomputes everything
the program derives: the batches' padding, the radius graphs, the model,
the loss, the gradients, the global-norm clip and Adam.

The model (after the paper, arXiv 2402.01975, and its reference code,
``duyhominhnguyen/conan-fgw``): a SchNet trunk over each conformer's radius
graph (cutoff, a cap of the first ``max_neighbors`` candidates in index
order, self included, the self loop then dropped), written on edge lists;
two heads ``ssp(lin2(lin1 h))`` (the activation after both linears); a
two-layer GAT over the covalent graph with self loops carrying the mean of
the incoming bond attributes; the FGW barycenter of the K conformer graphs
at the batch's padded atom count (uniform marginals over the padding,
features min-max scaled per conformer, the structure the transposed
neighbour mask), its couplings solved without gradient by projected
gradient with log-domain Sinkhorn and the last feature update re-applied
with gradient; the fusion ``t3d(mean x3d) + tcov(x_cov) + agg tbary(x_bary)``
and the task's head and loss.

Everything is computed in ``dtype`` (float64 for the reference; the
control runs it in float32 with TF32 products). Which pairs are neighbours
is decided in float32 from the float32 coordinates, the precision the
configuration states, by the Gram form ``|a|^2 + |b|^2 - 2 a.b``; the
distances the model then uses are computed in ``dtype``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

ATOM_FEATURES, BOND_FEATURES, ELEMENTS = 9, 3, 100
BETA1, BETA2, ADAM_EPS, CLIP = 0.9, 0.999, 1e-8, 1.0
BARY_SHIFT, BARY_LO, BARY_HI = 0.5, 0.1, 2.0


# ------------------------------------------------------------------ weights
def widths(cfg: dict) -> dict:
    m = cfg["model"]
    return dict(H=m["hidden_channels"], F=m["num_filters"], G=m["num_gaussians"],
                L=m["num_interactions"], C=m["hidden_channels"] // 2)


# the final layer's bound against xavier's: the head then starts with logits
# and predictions of order one, as a trained stage 1 leaves them, where the
# flax init of a sum readout over 20-128 atoms gives them of order 10-500
# (a BCE of such logits rounds to 0 in float32)
FINAL_GAIN = 0.01


def weight_spec(cfg: dict) -> list[tuple[str, tuple, str]]:
    """``(name, shape, init)`` of every parameter, in order: ``xavier``
    (uniform, bound sqrt(6 / (rows + columns))), ``final`` (the same times
    ``FINAL_GAIN``), ``zeros`` or ``normal``."""
    w = widths(cfg)
    H, Fw, G, C = w["H"], w["F"], w["G"], w["C"]
    spec = [("backbone.embedding.weight", (ELEMENTS, H), "normal")]
    for b in range(w["L"]):
        p = f"backbone.blocks.{b}."
        spec += [(p + "filter_w1", (G, Fw), "xavier"), (p + "filter_b1", (Fw,), "zeros"),
                 (p + "filter_w2", (Fw, Fw), "xavier"), (p + "filter_b2", (Fw,), "zeros"),
                 (p + "lin1.weight", (Fw, H), "xavier"), (p + "lin2.weight", (H, Fw), "xavier"),
                 (p + "lin2.bias", (H,), "zeros"), (p + "lin.weight", (H, H), "xavier"),
                 (p + "lin.bias", (H,), "zeros")]
    for head in ("lin1", "lin2", "lin1_bary", "lin2_bary"):
        spec += [(f"backbone.{head}.weight", (C, H if head.startswith("lin1") else C), "xavier"),
                 (f"backbone.{head}.bias", (C,), "zeros")]
    for c, fin in ((0, ATOM_FEATURES), (1, C)):
        p = f"gat.convs.{c}."
        spec += [(p + "att_src", (1, C), "xavier"), (p + "att_dst", (1, C), "xavier"),
                 (p + "att_edge", (1, C), "xavier"), (p + "bias", (C,), "zeros"),
                 (p + "lin.weight", (C, fin), "xavier"), (p + "lin_edge.weight", (C, BOND_FEATURES), "xavier")]
    for t in ("t3d", "tcov", "tbary"):
        spec += [(f"{t}.weight", (C, C), "xavier"), (f"{t}.bias", (C,), "zeros")]
    if cfg["task"] == "classification":
        for i, (o, fin) in enumerate(((C, C), (C // 2, C), (1, C // 2))):
            spec += [(f"head.lins.{i}.weight", (o, fin), "final" if i == 2 else "xavier"),
                     (f"head.lins.{i}.bias", (o,), "zeros")]
        for i in range(3):
            spec += [(f"self_attention.qkv.{i}.weight", (C, C), "xavier"),
                     (f"self_attention.qkv.{i}.bias", (C,), "zeros")]
    else:
        spec += [("head.weight", (1, C), "final"), ("head.bias", (1,), "zeros")]
    return spec


def make_weights(cfg: dict, seed: int, device) -> dict[str, torch.Tensor]:
    """Float32 weights from ``seed``, drawn on ``device`` in two calls (one
    uniform draw for every xavier and final leaf, one normal draw for the
    embedding) and cut into leaves."""
    spec = weight_spec(cfg)
    gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + 17) % (1 << 63))
    n_uniform = sum(math.prod(s) for _, s, init in spec if init in ("xavier", "final"))
    n_normal = sum(math.prod(s) for _, s, init in spec if init == "normal")
    uniform = torch.rand(n_uniform, generator=gen, device=device) * 2.0 - 1.0
    normal = torch.randn(n_normal, generator=gen, device=device)
    out, iu, ino = {}, 0, 0
    for name, shape, init in spec:
        n = math.prod(shape)
        if init in ("xavier", "final"):
            gain = FINAL_GAIN if init == "final" else 1.0
            out[name] = uniform[iu: iu + n].view(shape) * (gain * math.sqrt(6.0 / sum(shape)))
            iu += n
        elif init == "normal":
            out[name] = normal[ino: ino + n].view(shape).clone()
            ino += n
        else:
            out[name] = torch.zeros(shape, device=device)
    return out


# ------------------------------------------------------------------ the graph
def ssp(x):
    return F.softplus(x) - math.log(2.0)


def neighbours(pos32: torch.Tensor, valid: torch.Tensor, cutoff: float, cap: int) -> torch.Tensor:
    """``nbr[g, i, j]``: j is a message source of i, decided in float32 from
    ``pos32 (G, N, 3)`` and the atoms ``valid (G, N)``."""
    x, y, z = pos32.unbind(-1)
    sq = x * x + y * y + z * z
    dot = (x[:, :, None] * x[:, None, :] + y[:, :, None] * y[:, None, :]
           + z[:, :, None] * z[:, None, :])
    d = torch.sqrt(torch.clamp(sq[:, :, None] + sq[:, None, :] - 2.0 * dot, min=1e-12))
    n = pos32.shape[1]
    eye = torch.eye(n, dtype=torch.bool, device=pos32.device)
    pair = valid[:, :, None] & valid[:, None, :]
    within = pair & (d <= cutoff)
    cand = (within | (eye & pair)).to(torch.int32)
    rank = torch.cumsum(cand, dim=-1) - cand
    return within & ~eye & (rank < cap + 1)


def pad_batch(mols, N: int, device, dtype):
    """The batch's conformer graphs padded to ``N`` atoms: ``z (B, N)``,
    ``pos (B, K, N, 3)`` in ``dtype`` and in float32, ``valid (B, N)``."""
    B, K = len(mols), mols[0].pos.shape[0]
    z = torch.zeros(B, N, dtype=torch.long)
    pos = torch.zeros(B, K, N, 3, dtype=torch.float32)
    valid = torch.zeros(B, N, dtype=torch.bool)
    for b, m in enumerate(mols):
        z[b, : m.n] = torch.from_numpy(m.z.astype(np.int64))
        pos[b, :, : m.n] = torch.from_numpy(m.pos)
        valid[b, : m.n] = True
    pos = pos.to(device)
    return z.to(device), pos.to(dtype), pos, valid.to(device)


# ------------------------------------------------------------------ the model
def schnet(w, z, pos, pos32, valid, cfg):
    """Per conformer graph ``(B, K)``: atom features ``h (B, K, N, H)`` of the
    trunk (zero on padding) and the neighbour mask ``(B, K, N, N)``."""
    m = cfg["model"]
    B, K, N, _ = pos.shape
    Gr = B * K
    v = valid[:, None, :].expand(B, K, N).reshape(Gr, N)
    nbr = neighbours(pos32.reshape(Gr, N, 3), v, m["cutoff"], m["max_neighbors"])
    g, i, j = nbr.nonzero(as_tuple=True)  # edge j -> i of graph g
    p = pos.reshape(Gr * N, 3)
    tgt, src = g * N + i, g * N + j
    d = torch.linalg.vector_norm(p[tgt] - p[src], dim=-1)
    mu = torch.linspace(0.0, m["cutoff"], m["num_gaussians"], dtype=pos.dtype, device=pos.device)
    rbf = torch.exp(-0.5 / (mu[1] - mu[0]) ** 2 * (d[:, None] - mu) ** 2)
    env = 0.5 * (torch.cos(d * math.pi / m["cutoff"]) + 1.0)
    h = w["backbone.embedding.weight"][z][:, None].expand(B, K, N, -1).reshape(Gr * N, -1)
    h = h * v.reshape(-1, 1).to(h.dtype)
    for b in range(m["num_interactions"]):
        p_ = f"backbone.blocks.{b}."
        x = h @ w[p_ + "lin1.weight"].T
        filt = ssp(rbf @ w[p_ + "filter_w1"] + w[p_ + "filter_b1"]) @ w[p_ + "filter_w2"] + w[p_ + "filter_b2"]
        msg = filt * env[:, None] * x[src]
        agg = torch.zeros_like(x).index_add(0, tgt, msg)
        out = ssp(agg @ w[p_ + "lin2.weight"].T + w[p_ + "lin2.bias"])
        out = out @ w[p_ + "lin.weight"].T + w[p_ + "lin.bias"]
        h = h + out * v.reshape(-1, 1).to(h.dtype)
    return h.reshape(B, K, N, -1), nbr.reshape(B, K, N, N)


def linear(w, name, x):
    return x @ w[name + ".weight"].T + w[name + ".bias"]


def gat(w, mols, device, dtype):
    """The covalent graph's two GAT layers and sum readout: ``(B, C)``."""
    offs = np.cumsum([0] + [m.n for m in mols])
    src, dst, attr = [], [], []
    for b, m in enumerate(mols):
        e = m.bonds.astype(np.int64) + offs[b]
        src += [e[:, 0], e[:, 1]]
        dst += [e[:, 1], e[:, 0]]
        attr += [m.bond_attr, m.bond_attr]
    src = torch.from_numpy(np.concatenate(src)).to(device)
    dst = torch.from_numpy(np.concatenate(dst)).to(device)
    attr = torch.from_numpy(np.concatenate(attr)).to(device=device, dtype=dtype)
    A = int(offs[-1])
    deg = torch.zeros(A, dtype=dtype, device=device).index_add(0, dst, torch.ones_like(src, dtype=dtype))
    loop_attr = torch.zeros(A, BOND_FEATURES, dtype=dtype, device=device).index_add(0, dst, attr)
    loop_attr = loop_attr / torch.clamp(deg, min=1.0)[:, None]
    node = torch.arange(A, device=device)
    src, dst = torch.cat([src, node]), torch.cat([dst, node])
    attr = torch.cat([attr, loop_attr])
    h = torch.from_numpy(np.concatenate([m.x2d for m in mols])).to(device=device, dtype=dtype)
    for c in range(2):
        p = f"gat.convs.{c}."
        xs = h @ w[p + "lin.weight"].T
        e = attr @ w[p + "lin_edge.weight"].T
        logit = ((xs * w[p + "att_src"]).sum(-1)[src] + (xs * w[p + "att_dst"]).sum(-1)[dst]
                 + (e * w[p + "att_edge"]).sum(-1))
        logit = F.leaky_relu(logit, 0.2)
        top = torch.full((A,), -math.inf, dtype=dtype, device=device).scatter_reduce(
            0, dst, logit, "amax", include_self=True)
        ex = torch.exp(logit - top[dst])
        den = torch.zeros(A, dtype=dtype, device=device).index_add(0, dst, ex)
        alpha = ex / den[dst]
        h = torch.zeros_like(xs).index_add(0, dst, alpha[:, None] * xs[src]) + w[p + "bias"]
    mol = torch.repeat_interleave(torch.arange(len(mols), device=device),
                                  torch.as_tensor([m.n for m in mols], device=device))
    return torch.zeros(len(mols), h.shape[1], dtype=dtype, device=device).index_add(0, mol, h)


def sinkhorn(p, q, cost, eps, iters, thr, check_every=10):
    mr = -cost / eps
    logp, logq = torch.log(torch.clamp(p, min=1e-30)), torch.log(torch.clamp(q, min=1e-30))
    u, v = torch.zeros_like(p), torch.zeros_like(q)
    frozen = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    diverged = torch.zeros_like(frozen)
    for it in range(iters):
        v_new = logq - torch.logsumexp(mr + u[:, :, None], dim=1)
        u_new = logp - torch.logsumexp(mr + v_new[:, None, :], dim=2)
        bad = ~(torch.isfinite(u_new).all(1) & torch.isfinite(v_new).all(1)) & ~frozen
        done = bad
        if it % check_every == 0:
            col = torch.exp(mr + u_new[:, :, None] + v_new[:, None, :]).sum(1)
            done = (torch.linalg.vector_norm(col - q, dim=1) < thr) | bad
        keep = (frozen | bad)[:, None]
        u, v = torch.where(keep, u, u_new), torch.where(keep, v, v_new)
        frozen = frozen | done
        diverged = diverged | bad
    return torch.exp(mr + u[:, :, None] + v[:, None, :]), diverged


def fgw_couplings(M, C1, C2, p, q, T, fgw, check_every=10):
    """The square-loss FGW couplings of ``S`` solves by projected gradient,
    each step an entropic OT in log-domain Sinkhorn; a solve whose step is
    not finite keeps its plan, one whose first step moved less than the
    tolerance stops."""
    alpha, eps = fgw["alpha"], fgw["epsilon"]
    const = (C1 * C1) @ p[:, :, None] + ((C2 * C2) @ q[:, :, None]).transpose(1, 2)
    frozen = torch.zeros(M.shape[0], dtype=torch.bool, device=M.device)
    for it in range(fgw["pgd_iters"]):
        grad = 2.0 * (const - C1 @ T @ (2.0 * C2).transpose(1, 2))
        T_new, diverged = sinkhorn(p, q, alpha * grad + (1.0 - alpha) * M, eps,
                                   fgw["sinkhorn_iters"], fgw["sinkhorn_thr"], check_every)
        bad = diverged | ~torch.isfinite(T_new).flatten(1).all(1)
        done = bad
        if it % check_every == 0:
            done = (torch.linalg.vector_norm((T_new - T).flatten(1), dim=1) <= fgw["pgd_tol"]) | bad
        T = torch.where((frozen | bad)[:, None, None], T, T_new)
        frozen = frozen | done
    return T


def sqdist(x, y):
    d = (x * x).sum(-1)[..., :, None] + (y * y).sum(-1)[..., None, :] - 2.0 * x @ y.transpose(-1, -2)
    return torch.clamp(d, min=0.0)


def barycenter(Ys, Cs, fgw):
    """``Ys (B, K, N, D)``, ``Cs (B, K, N, N)``, uniform marginals over all
    ``N``: the barycenter's features ``(B, N, D)``, the last update re-applied
    with gradient with respect to ``Ys``."""
    B, K, N, D = Ys.shape
    dt, dev = Ys.dtype, Ys.device
    p = torch.full((B, N), 1.0 / N, dtype=dt, device=dev)
    lam = 1.0 / K
    with torch.no_grad():
        Yd = Ys.detach()
        C, Y = Cs[:, 0], torch.zeros(B, N, D, dtype=dt, device=dev)
        T = (p[:, :, None] * p[:, None, :])[:, None].expand(B, K, N, N)
        Ms = sqdist(Y[:, None], Yd)
        frozen = torch.zeros(B, dtype=torch.bool, device=dev)
        flat = lambda x: x.reshape(B * K, *x.shape[2:])  # noqa: E731
        pk = flat(p[:, None].expand(B, K, N))
        for _ in range(fgw["outer_iters"]):
            T_new = fgw_couplings(flat(Ms), flat(C[:, None].expand(B, K, N, N)), flat(Cs), pk, pk,
                                  flat(T), fgw).reshape(B, K, N, N)
            Y_new = N * lam * torch.einsum("bknm,bkmd->bnd", T_new, Yd)
            C_new = lam * torch.einsum("bknm,bkmj,bklj->bnl", T_new, Cs, T_new) * N * N
            settled = ((torch.linalg.vector_norm((Y_new - Y).flatten(1), dim=1) <= fgw["outer_tol"])
                       & (torch.linalg.vector_norm((C_new - C).flatten(1), dim=1) <= fgw["outer_tol"]))
            keep = frozen[:, None, None]
            Y, C = torch.where(keep, Y, Y_new), torch.where(keep, C, C_new)
            T = torch.where(keep[..., None], T, T_new)
            Ms = torch.where(keep[..., None], Ms, sqdist(Y_new[:, None], Yd))
            frozen = frozen | settled
    return N * lam * torch.einsum("bknm,bkmd->bnd", T, Ys)


def forward(w, mols, N, cfg, device, dtype):
    """Predictions ``(B,)`` of one batch of molecules padded to ``N`` atoms."""
    z, pos, pos32, valid = pad_batch(mols, N, device, dtype)
    h, nbr = schnet(w, z, pos, pos32, valid, cfg)
    vm = valid[:, None, :, None].to(dtype)
    h3 = ssp(linear(w, "backbone.lin2", linear(w, "backbone.lin1", h))) * vm
    hb = ssp(linear(w, "backbone.lin2_bary", linear(w, "backbone.lin1_bary", h))) * vm
    x3d = h3.sum(2).mean(1)
    shifted = hb + BARY_SHIFT
    lo = shifted.amin(dim=(-2, -1), keepdim=True)
    hi = shifted.amax(dim=(-2, -1), keepdim=True)
    ys = BARY_LO + (shifted - lo) * (BARY_HI - BARY_LO) / (hi - lo + 1e-12)
    cs = nbr.transpose(-1, -2).to(dtype)
    x_bary = barycenter(ys, cs, cfg["fgw"]).sum(1)
    x_cov = gat(w, mols, device, dtype)
    x = (linear(w, "t3d", x3d) + linear(w, "tcov", x_cov)
         + cfg["yaml"]["agg_weight"] * linear(w, "tbary", x_bary))
    if cfg["task"] == "classification":
        x = torch.relu(linear(w, "head.lins.0", x))
        x = torch.relu(linear(w, "head.lins.1", x))
        return linear(w, "head.lins.2", x)[:, 0]
    return linear(w, "head", x)[:, 0]


def loss_of(pred, mols, cfg, scale):
    y = torch.as_tensor([m.y for m in mols], dtype=pred.dtype, device=pred.device)
    if cfg["task"] == "classification":
        bce = torch.clamp(pred, min=0.0) - pred * y + torch.log1p(torch.exp(-pred.abs()))
        return scale * bce.sum() / len(mols)
    return ((pred - y) ** 2).sum() / len(mols)


def class_scale(labels) -> float:
    """The BCE's class-weight ratio n0 / n1 of the training labels."""
    y = np.asarray(labels)
    return max(int((y == 0).sum()), 1) / max(int((y == 1).sum()), 1)


def first_losses(weights, batches, cfg, *, device, dtype=torch.float64, scale=1.0) -> list:
    """The loss of each batch (``[(N, molecules), ...]``) at ``weights``: the
    loss of a first step on it."""
    w = {k: v.detach().to(device=device, dtype=dtype) for k, v in weights.items()}
    with torch.no_grad():
        return [float(loss_of(forward(w, mols, N, cfg, device, dtype), mols, cfg, scale))
                for N, mols in batches]


def train(weights, batches, cfg, *, device, dtype=torch.float64, scale=1.0):
    """Train from ``weights`` on ``batches`` (``[(N, molecules), ...]``), one
    Adam step each after the global-norm clip: ``{"losses": [...], "grad":
    {leaf: norm of step 1's clipped gradient}, "change": {leaf: norm of
    the change after the last step}}`` (leaves with no gradient have norm
    0 and do not move)."""
    lr = cfg["yaml"]["learning_rate"]
    w = {k: v.detach().to(device=device, dtype=dtype).clone().requires_grad_(True)
         for k, v in weights.items()}
    start = {k: v.detach().clone() for k, v in w.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    s = {k: torch.zeros_like(v) for k, v in w.items()}
    out = {"losses": [], "grad": {}, "change": {}}
    for t, (N, mols) in enumerate(batches, 1):
        loss = loss_of(forward(w, mols, N, cfg, device, dtype), mols, cfg, scale)
        grads = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
        grads = dict(zip(w.keys(), grads))
        live = {k: g for k, g in grads.items() if g is not None}
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in live.values()]))
        factor = CLIP / norm if norm >= CLIP else torch.ones_like(norm)
        out["losses"].append(float(loss.detach()))
        with torch.no_grad():
            for k, g in live.items():
                g = g * factor
                if t == 1:
                    out["grad"][k] = float(torch.linalg.vector_norm(g))
                m[k] = BETA1 * m[k] + (1 - BETA1) * g
                s[k] = BETA2 * s[k] + (1 - BETA2) * g * g
                bc1, bc2 = 1 - BETA1 ** t, 1 - BETA2 ** t
                w[k] -= (lr / bc1) * m[k] / (torch.sqrt(s[k]) / math.sqrt(bc2) + ADAM_EPS)
        del loss, grads, live
    for k in w:
        out["grad"].setdefault(k, 0.0)
        out["change"][k] = float(torch.linalg.vector_norm(w[k].detach() - start[k]))
    return out
