"""The general traffic generator: seeded synthetic molecules from one traffic
file (``perfbench/traffic/<name>.json``).

A vectorised copy of the rules of ``conan_fgw_tpu_torch/data/synthetic.py``
(``random_molecule``): C/N/O/F heavy atoms joined in a random tree, a ring
closed in about half of them, hydrogens filling every free valence, 3D
coordinates from 60 sweeps of spring relaxation to 1.5 A bonds with a weak
repulsion below 1.2 A, and K conformers jittered from that geometry by
N(0, 0.15 A). What changed against the original:

- the relaxation runs for all molecules at once, padded, on the device
  (float32, dense bond matrices) instead of a Python loop over each
  molecule's bonds in float64 numpy, which took 10-40 ms a molecule;
- a molecule is built to an exact total atom count (hydrogens included):
  the heavy atom that would pass it is drawn among the kinds that reach it
  exactly. The counts themselves are a fixed multiset, drawn from the
  file's ``size_seed``; ``--seed`` only orders them within their buckets
  (the smallest bucket first) and draws each molecule's chemistry,
  geometry and jitter, so every seed gives the same buckets, met in the
  same order, and the same number of steps;
- labels: ``regression`` is the original's smooth property (composition
  and mean radius); ``active_share`` marks that share of the molecules
  with the highest property as actives (1) and the rest 0.

The traffic file's keys: ``molecules``; ``sizes``, either ``{"kind":
"lognormal", "counts", "mean", "largest", "of", "min", "max",
"size_seed"}`` (a lognormal fitted to a dataset's published statistics:
its mean is ``mean`` and one value in ``of`` lies above ``largest``, the
largest of a dataset of ``of`` molecules; draws rounded, and redrawn
outside ``[min, max]``; ``counts`` ``"heavy"`` draws heavy atoms and the
original's topology for each, ``original_size``, whose total atom counts
are the multiset, ``"atoms"`` draws the total atom counts) or ``{"kind":
"atom_ranges", "ranges": [[lo, hi], ...], "size_seed"}`` (total atom counts
uniform in each range in turn); ``ring_share``; ``jitter``; ``label``.
"""

from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist

import numpy as np
import torch

HEAVY = ((6, 4), (7, 3), (8, 2), (9, 1))  # (Z, valence): C, N, O, F
BOND_LEN, REPEL, SWEEPS, STEP = 1.5, 1.2, 60, 0.3
# the PyG atom feature layout of conan_fgw_tpu_torch/data/vocab.py: atomic
# number, chirality, degree, formal charge + 5, hydrogens, radicals,
# hybridization (SP3 = 4, unspecified 0), aromatic, in ring
FORMAL_CHARGE_OFFSET, SP3, BOND_SINGLE = 5, 4, 1


@dataclasses.dataclass
class Molecule:
    """One molecule: ``z (n,)`` int32, ``pos (K, n, 3)`` float32, ``x2d (n,
    9)`` int32, ``bonds (E, 2)`` int32 (each bond once), ``bond_attr (E, 3)``
    float32, ``y`` float."""

    z: np.ndarray
    pos: np.ndarray
    x2d: np.ndarray
    bonds: np.ndarray
    bond_attr: np.ndarray
    y: float

    @property
    def n(self) -> int:
        return int(self.z.shape[0])


def tree_total(kinds) -> int:
    """Atoms, hydrogens included, of a tree of these heavy kinds: every bond
    takes one valence from each end, so 2 + sum(valence - 1)."""
    return 2 + sum(HEAVY[k][1] - 1 for k in kinds)


def original_size(rng, heavy: int) -> int:
    """The atoms, hydrogens included, of ``synthetic.random_molecule``'s
    topology for ``heavy`` heavy atoms, drawn as it draws them: kinds
    uniform over C/N/O/F, each atom bonded to a random earlier one with a
    free valence (any earlier one where none has), a ring closed half the
    time from five heavy atoms, hydrogens on the free valences."""
    kinds = rng.integers(0, len(HEAVY), size=heavy)
    cap = [HEAVY[k][1] for k in kinds]
    deg, bonds = [0] * heavy, []
    for i in range(1, heavy):
        choices = [j for j in range(i) if deg[j] < cap[j]]
        j = int(rng.choice(choices)) if choices else int(rng.integers(0, i))
        bonds.append((j, i))
        deg[i] += 1
        deg[j] += 1
    if heavy >= 5 and rng.random() < 0.5:
        i, j = sorted(rng.choice(heavy, size=2, replace=False).tolist())
        if (i, j) not in bonds and deg[i] < cap[i] and deg[j] < cap[j]:
            deg[i] += 1
            deg[j] += 1
    return heavy + sum(max(c - d, 0) for c, d in zip(cap, deg))


def lognormal_sigma(mean: float, largest: float, of: int) -> float:
    """The log-spread of the lognormal of ``mean`` whose upper one-in-``of``
    tail begins at ``largest``: with mu = ln(mean) - s^2 / 2, (ln(largest)
    - mu) / s is the normal quantile z of 1 - 1 / of, so s^2 / 2 - z s +
    ln(largest / mean) = 0, the smaller root."""
    z = NormalDist().inv_cdf(1.0 - 1.0 / of)
    return z - math.sqrt(z * z - 2.0 * math.log(largest / mean))


def lognormal_draws(rng, spec: dict, count: int) -> list[int]:
    """``count`` rounded draws of the spec's fitted lognormal within
    ``[min, max]`` (a draw outside is drawn again)."""
    s = lognormal_sigma(spec["mean"], spec["largest"], spec["of"])
    mu = math.log(spec["mean"]) - s * s / 2.0
    out = []
    while len(out) < count:
        v = int(round(math.exp(mu + s * float(rng.standard_normal()))))
        if spec["min"] <= v <= spec["max"]:
            out.append(v)
    return out


def sizes(traffic: dict) -> list[int]:
    """The total atom counts of the traffic's molecules, in the order of
    its ``size_seed`` (a fixed multiset; a run's seed reorders it)."""
    spec, count = traffic["sizes"], traffic["molecules"]
    rng = np.random.default_rng(spec["size_seed"])
    if spec["kind"] == "lognormal":
        drawn = lognormal_draws(rng, spec, count)
        if spec["counts"] == "heavy":
            return [original_size(rng, h) for h in drawn]
        if spec["counts"] == "atoms":
            return drawn
        raise ValueError(f"unknown sizes counts {spec['counts']!r}")
    if spec["kind"] == "atom_ranges":
        ranges = spec["ranges"]
        return [int(rng.integers(lo, hi + 1)) for lo, hi in
                (ranges[i % len(ranges)] for i in range(count))]
    raise ValueError(f"unknown sizes kind {spec['kind']!r}")


def _tree(rng, target: int):
    """Heavy kinds and tree bonds whose tree total is ``target``: kinds
    uniform over C/N/O/F, each new atom bonded to a random earlier atom with
    a free valence; a kind is drawn only among those that do not pass the
    target and leave a free valence for the atoms still to come."""
    kinds, deg, bonds = [], [], []
    while True:
        left = target - (tree_total(kinds) if kinds else 0)
        free = (tree_total(kinds) - len(kinds)) if kinds else 0  # hydrogens so far
        if kinds and left == 0:
            return kinds, deg, bonds
        if not kinds:
            allowed = [k for k in range(len(HEAVY)) if HEAVY[k][1] + 1 <= target]
        else:
            allowed = [k for k in range(len(HEAVY)) if HEAVY[k][1] - 1 <= left
                       and not (HEAVY[k][1] == 1 and free <= 1)]
        k = int(rng.choice(allowed))
        i = len(kinds)
        if kinds:
            open_ = [j for j in range(i) if deg[j] < HEAVY[kinds[j]][1]]
            j = int(rng.choice(open_))
            bonds.append((j, i))
            deg[j] += 1
            deg.append(1)
        else:
            deg.append(0)
        kinds.append(k)


def topology(rng, total: int, ring_share: float):
    """``(z, bonds, heavy degree, hydrogens per heavy atom)`` of one molecule
    of exactly ``total`` atoms: heavy atoms first, then each heavy atom's
    hydrogens in its order. With probability ``ring_share`` a ring is closed
    between two heavy atoms with free valences (the tree is then built to
    two atoms more); where no such pair exists the molecule stays a tree of
    ``total`` atoms."""
    ring = rng.random() < ring_share
    kinds, deg, bonds = _tree(rng, total + 2 if ring else total)
    if ring:
        h = len(kinds)
        pairs = [(i, j) for i in range(h) for j in range(i + 1, h)
                 if deg[i] < HEAVY[kinds[i]][1] and deg[j] < HEAVY[kinds[j]][1]
                 and (i, j) not in bonds]
        if pairs:
            i, j = pairs[int(rng.integers(len(pairs)))]
            bonds.append((i, j))
            deg[i] += 1
            deg[j] += 1
        else:
            kinds, deg, bonds = _tree(rng, total)
    z = [HEAVY[k][0] for k in kinds]
    nh = [HEAVY[k][1] - d for k, d in zip(kinds, deg)]
    for i, c in enumerate(nh):
        for _ in range(c):
            bonds.append((i, len(z)))
            z.append(1)
    if len(z) != total:
        raise AssertionError(f"built {len(z)} atoms for {total}")
    return np.asarray(z, np.int32), np.asarray(bonds, np.int32).reshape(-1, 2), nh


def relax(n_atoms: np.ndarray, bonds: list, gen: torch.Generator, device) -> torch.Tensor:
    """Spring relaxation of every molecule at once: ``(M, n_max, 3)`` float32
    base geometries from random starts N(0, 2)."""
    M, n_max = len(n_atoms), int(n_atoms.max())
    n_t = torch.as_tensor(n_atoms, device=device)
    mask = torch.arange(n_max, device=device)[None, :] < n_t[:, None]
    adj = torch.zeros(M, n_max, n_max, device=device)
    idx = np.concatenate([np.column_stack([np.full(len(b), m), b]) for m, b in enumerate(bonds)])
    idx = torch.as_tensor(idx, device=device, dtype=torch.long)
    adj[idx[:, 0], idx[:, 1], idx[:, 2]] = 1.0
    adj[idx[:, 0], idx[:, 2], idx[:, 1]] = 1.0
    pair = (mask[:, :, None] & mask[:, None, :]).float()
    pos = torch.randn(M, n_max, 3, generator=gen, device=device) * 2.0
    pos = pos * mask[..., None]
    for _ in range(SWEEPS):
        diff = pos[:, :, None, :] - pos[:, None, :, :]
        dist = torch.linalg.vector_norm(diff, dim=-1) + 1e-9
        spring = adj * (dist - BOND_LEN) / dist
        rep = torch.where(dist < REPEL, (REPEL - dist) / dist, torch.zeros_like(dist)) * pair
        grad = ((0.5 * rep - spring)[..., None] * diff).sum(2)
        pos = pos + STEP * grad
    return pos * mask[..., None]


def generate(traffic: dict, seed: int, num_conformers: int, device="cpu") -> list[Molecule]:
    """The traffic's molecules for ``seed``: the fixed sizes in a seeded
    order, each molecule's topology from a numpy generator of ``seed``, the
    geometry and the conformers' jitter from a ``torch.Generator`` of
    ``seed`` on ``device``."""
    rng = np.random.default_rng([seed, 1])
    totals = np.asarray(sizes(traffic))[rng.permutation(traffic["molecules"])]
    # smallest bucket first, so that every seed's epoch meets its buckets in
    # one order (the program captures each bucket's graph when first met)
    totals = totals[np.argsort([bucket_of(int(n)) for n in totals], kind="stable")]
    tops = [topology(rng, int(t), traffic["ring_share"]) for t in totals]
    gen = torch.Generator(device=device).manual_seed(seed)
    base = relax(totals, [b for _, b, _ in tops], gen, device)
    M, n_max, K = len(totals), base.shape[1], num_conformers
    pos = base[:, None] + torch.randn(M, K, n_max, 3, generator=gen, device=device) * traffic["jitter"]
    base, pos = base.cpu().numpy(), pos.cpu().numpy().astype(np.float32)
    mols = []
    for m, (z, bonds, nh) in enumerate(tops):
        n = len(z)
        deg = np.bincount(bonds.ravel(), minlength=n)
        hs = np.zeros(n, np.int64)
        hs[: len(nh)] = nh
        x2d = np.zeros((n, 9), np.int32)
        x2d[:, 0] = z
        x2d[:, 2] = deg
        x2d[:, 3] = FORMAL_CHARGE_OFFSET
        x2d[:, 4] = hs
        x2d[:, 6] = np.where(z != 1, SP3, 0)
        battr = np.zeros((len(bonds), 3), np.float32)
        battr[:, 0] = BOND_SINGLE
        b = base[m, :n].astype(np.float64)
        y = float(0.1 * z.sum() / n + 0.5 * np.tanh(np.mean(np.linalg.norm(b - b.mean(0), axis=1)))
                  + 0.05 * len(bonds))
        mols.append(Molecule(z, np.ascontiguousarray(pos[m, :, :n]), x2d, bonds, battr, y))
    label = traffic["label"]
    if label["kind"] == "active_share":
        order = np.argsort([-mol.y for mol in mols], kind="stable")
        actives = set(order[: int(round(label["share"] * len(mols)))].tolist())
        for i, mol in enumerate(mols):
            mol.y = float(i in actives)
    elif label["kind"] != "regression":
        raise ValueError(f"unknown label kind {label['kind']!r}")
    return mols


BUCKETS = (32, 64, 96, 128)


def bucket_of(n: int, buckets=BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"{n} atoms exceed the largest bucket {buckets[-1]}")


def epoch_batches(mols: list[Molecule], batch_size: int) -> list[tuple[int, list[int]]]:
    """An unshuffled epoch's batches as ``(bucket N, molecule indices)``:
    molecules grouped by the smallest bucket that holds them (buckets up to
    the data's largest), groups in first-seen order, input order within a
    group, ``batch_size`` a batch, the last of a group short. This is the
    batching rule that the program's bucketed loader states; the harness
    checks it against the batches the program packs."""
    top = bucket_of(max(m.n for m in mols))
    buckets = tuple(b for b in BUCKETS if b < top) + (top,)
    groups: dict[int, list[int]] = {}
    for i, m in enumerate(mols):
        groups.setdefault(bucket_of(m.n, buckets), []).append(i)
    return [(b, idx[s: s + batch_size]) for b, idx in groups.items()
            for s in range(0, len(idx), batch_size)]
