"""The arithmetic and edge order of the cfconv kernels K1/K2, emulated on
the CPU (``ops/cuda/cfconv.py``: ``round_bits``, ``split_mm``,
``edge_list``, ``cfconv_edges``).

At the slice's width (F=128, 50 Gaussians, cap 32) on one N=32 set of
packed synthetic conformers:
- the kernels' three-term TF32 split (3xTF32; a three-term bf16 split
  until the kernels moved to TF32, hence the tests' names) holds the
  forward and all five gradients within a tenth of the 5e-4 contract (max
  |emulated - plain| / max |plain|); a single TF32 pass is computed beside
  it and its error is reported in the assertion message, not asserted;
- the compacted edge lists (target-major for K1, source-major for K2) hold
  exactly the gated edges, and summing the messages over either list in
  its order reproduces ``_cfconv_plain`` to 1e-6 relative.

At the classification width (F=256, 10 Gaussians), where K2 splits the
filters of h in slabs of 64 and sums the slabs' parts of dx in slab order,
the same two holds: the split with the slabs within a tenth of the
contract, and the edge formulation with the slabs to 1e-5 in f32.
"""

import functools

import numpy as np
import pytest
import torch

from conan_fgw_tpu_torch.data.packing import pack_batch
from conan_fgw_tpu_torch.data.synthetic import random_dataset
from conan_fgw_tpu_torch.ops.cuda.cfconv import (
    _cfconv_plain,
    cfconv_edges,
    edge_list,
    round_bits,
    split_mm,
)
from conan_fgw_tpu_torch.ops.graph import pairwise_distances, radius_graph_mask

CUTOFF, GAUSS, CAP, F, N, K = 10.0, 50, 32, 128, 32, 5
CONTRACT = 5e-4
MARGIN = 10.0  # the split must hold the contract with 10x to spare
NAMES = ("out", "dx", "dw1", "db1", "dw2", "db2")


@functools.cache
def _problem(seed=0, n_mols=4, F=F, GAUSS=GAUSS):
    recs = random_dataset(seed, n_mols, num_conformers=K, heavy_range=(8, 13), device="cpu")
    pb = pack_batch(recs, max_atoms=N, batch_size=n_mols).to("cpu")
    pos = pb.pos.reshape(-1, N, 3).contiguous()
    mask = pb.atom_mask.repeat_interleave(K, dim=0).to(torch.float32)
    G = pos.shape[0]
    rng = np.random.default_rng(seed)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    x = rnd(G, N, F)
    w1, b1 = rnd(GAUSS, F, scale=(6 / (GAUSS + F)) ** 0.5), rnd(F, scale=0.1)
    w2, b2 = rnd(F, F, scale=(3 / F) ** 0.5), rnd(F, scale=0.1)
    cot = rnd(G, N, F)
    return pos, mask, (x, w1, b1, w2, b2), cot


@functools.cache
def _results(F=F, GAUSS=GAUSS, slab=None):
    pos, mask, params, cot = _problem(F=F, GAUSS=GAUSS)
    leaves = [p.clone().requires_grad_(True) for p in params]
    out = _cfconv_plain(pos, mask, *leaves, CUTOFF, GAUSS, CAP)
    plain = (out.detach(), *torch.autograd.grad(out, leaves, cot))

    def run(mm):
        out, grads = cfconv_edges(pos, mask, *params, cot, CUTOFF, CAP, mm=mm, slab=slab)
        return (out, *grads)

    one_tf32 = functools.partial(split_mm, passes=1, drop=13)
    return plain, run(split_mm), run(one_tf32), run(torch.matmul)


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


@pytest.mark.parametrize("k", range(len(NAMES)), ids=NAMES)
def test_split_bf16_holds_the_contract(k):
    plain, split, single, _ = _results()
    err, err1 = _rel(split[k], plain[k]), _rel(single[k], plain[k])
    assert err <= CONTRACT / MARGIN, (
        f"{NAMES[k]}: 3xTF32 rel err {err:.3e} > {CONTRACT / MARGIN:.1e}"
        f" (one TF32 pass: {err1:.3e}, contract {CONTRACT})")
    print(f"{NAMES[k]}: 3xTF32 rel err {err:.3e}; one TF32 pass {err1:.3e} (contract {CONTRACT})")


def test_edge_formulation_matches_plain_in_f32():
    plain, _, _, exact = _results()
    for name, a, b in zip(NAMES, exact, plain):
        assert _rel(a, b) <= 1e-5, name


@pytest.mark.parametrize("source_major", [False, True], ids=["K1_target_major", "K2_source_major"])
def test_edge_list_order_and_sum(source_major):
    pos, mask, (x, w1, b1, w2, b2), _ = _problem()
    nbr = radius_graph_mask(pairwise_distances(pos), mask > 0.5, CUTOFF, CAP)
    g, i, j = edge_list(pos, mask, CUTOFF, CAP, source_major=source_major)
    assert len(g) == int(nbr.sum())
    assert bool(nbr[g, i, j].all())
    # compacted in the kernel's order: graph, then the item's key row, then the other index
    a, b = (j, i) if source_major else (i, j)
    key = (g * N + a) * N + b
    assert bool((key[1:] > key[:-1]).all())
    # messages summed over the list in that order reproduce the plain version
    w = (torch.nn.functional.softplus(
        torch.exp(-0.5 / (CUTOFF / (GAUSS - 1)) ** 2
                  * (pairwise_distances(pos)[g, i, j, None]
                     - torch.linspace(0.0, CUTOFF, GAUSS)) ** 2) @ w1 + b1)
         - np.log(2.0)) @ w2 + b2
    d = pairwise_distances(pos)[g, i, j]
    gate = 0.5 * (torch.cos(d * np.pi / CUTOFF) + 1.0)
    msg = w * gate[:, None] * x[g, j]
    out = torch.zeros(x.shape[0] * N, F)
    for e in range(0, len(g), 4096):  # in list order, chunk by chunk
        out.index_add_(0, (g * N + i)[e:e + 4096], msg[e:e + 4096])
    plain = _cfconv_plain(pos, mask, x, w1, b1, w2, b2, CUTOFF, GAUSS, CAP)
    assert _rel(out.view_as(plain), plain) <= 1e-6


@pytest.mark.parametrize("drop", [13, 16], ids=["tf32", "bf16"])
def test_round_bits_to_nearest_ties_away(drop):
    one = torch.tensor([1.0, -1.0])
    ulp = 2.0 ** (drop - 23)  # spacing at 1
    t = torch.cat([one * (1 + ulp / 2), one * (1 + ulp / 2 - 2.0 ** -22), one * (1 + 0.75 * ulp)])
    want = torch.cat([one * (1 + ulp), one, one * (1 + ulp)])
    assert torch.equal(round_bits(t, drop), want)
    r = round_bits(torch.randn(1000, generator=torch.Generator().manual_seed(0)), drop)
    assert not bool((r.view(torch.int32) & ((1 << drop) - 1)).any())


def test_split_product_error_is_far_below_one_pass():
    rng = np.random.default_rng(1)
    a = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((128, 128)).astype(np.float32))
    exact = a.double() @ b.double()

    def err(mm):
        return float((mm(a, b).double() - exact).abs().max() / exact.abs().max())

    e3, e1 = err(split_mm), err(lambda a, b: split_mm(a, b, passes=1, drop=13))
    assert e3 < 2e-5 < 1e-4 < e1, (e3, e1)


CLASSIFICATION = dict(F=256, GAUSS=10, slab=64)  # K2 at F=256: slabs of 64 filters of h


@pytest.mark.parametrize("k", range(len(NAMES)), ids=NAMES)
def test_split_bf16_holds_the_contract_at_f256(k):
    plain, split, single, _ = _results(**CLASSIFICATION)
    err, err1 = _rel(split[k], plain[k]), _rel(single[k], plain[k])
    assert err <= CONTRACT / MARGIN, (
        f"{NAMES[k]}: 3xTF32 rel err {err:.3e} > {CONTRACT / MARGIN:.1e}"
        f" (one TF32 pass: {err1:.3e}, contract {CONTRACT})")


def test_edge_formulation_with_slabs_matches_plain_in_f32():
    plain, _, _, exact = _results(**CLASSIFICATION)
    for name, a, b in zip(NAMES, exact, plain):
        assert _rel(a, b) <= 1e-5, name
