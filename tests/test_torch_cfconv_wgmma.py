"""K1/K2 above 128 atoms (``csrc/cfconv_wgmma.cu``'s route), on the CPU.

- The route's edge tiles (``wgmma_edge_tiles``): every edge of the capped
  radius graph once, in the kernels' order, in whole tiles of 64 edges (32
  for K2 at F=128) per work item of 4 keys; the plan's tile bound
  (``plan_sizes``, the library's ``cfconv_wgmma_plan`` restated) holds
  them.
- The route's arithmetic (``cfconv_wgmma_emulated``: the tiles, the items
  and the partition of the tiles among the weight-gradient kernel's
  blocks as the kernels cut them, the 3xTF32 products with both split
  parts rounded to nearest, the kernels' softplus, F=256's output slabs
  over layer 1's passes of 64 channels, the partials in the reduce
  kernel's order; K2 at F=128 as ``cfconv_bwd_wgmma_kernel``: tiles of 32
  edges, even runs of tiles a block, layer 1 once, its RBF and sigmoid,
  dx summed in the message's two TF32 parts, an item that runs share
  summed from its parts in block order, the tiles' weight-gradient
  products added in run and block order) at N=160 and
  N=192, both widths and both cap modes: ``out`` and all five gradients
  within a tenth of the kernels' 5e-4 gate of the plain version.
- The kernels' softplus (ex2/lg2 on the special-function unit) within
  3.5e-7 of the exact function, with those instructions' errors at their
  bounds; K2 at F=128's RBF and sigmoid on ex2.approx within their bounds
  too.
- The plain version at N=160 against the JAX package's XLA cfconv.
- The wrapper's choice of route and the buffers it allocates for a plan,
  in Python.
- Marked ``card``: the kernels against the plain version (K2 at F=128
  also with the nearest cap, twice bit for bit, and in bf16), and the
  library's plans against ``plan_sizes``, on the card (skipped without
  one; ``python -m pytest tests/test_torch_cfconv_wgmma.py -m card`` on the
  machine with the card).
"""

import math

import numpy as np
import pytest
import torch

from conan_fgw_tpu_torch.ops.cuda import cfconv as k12
from conan_fgw_tpu_torch.ops.cuda.cfconv import (
    WG_EDGES,
    WG_KEYS,
    WG_PAD_KEY,
    WgmmaPlan,
    _cfconv_plain,
    _wgmma_scratch,
    cfconv_wgmma_emulated,
    edge_list,
    rbf_approx,
    route,
    sigmoid_from_ssp,
    ssp_approx,
    wgmma_edge_tiles,
    wgmma_plan,
)

CUTOFF, CAP = 10.0, 32
GATE = 5e-4          # the kernels' gate against the plain version (chip_smoke.py)
TOL = GATE / 10
CF_RTOL, CF_ATOL = 5e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _graphs(n, seed, f, gauss, g=2):
    """``g`` graphs of ``n`` slots of random molecules filling most of them
    (a binding cap: up to about 60 atoms within the cutoff of an atom), the
    weights at the models' scales and a cotangent."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((g, n, 3), np.float32)
    mask = np.zeros((g, n), np.float32)
    for b in range(g):
        atoms = int(rng.integers(n - 40, n - 8))
        pos[b, :atoms] = rng.standard_normal((atoms, 3)) * (0.9 * atoms ** (1 / 3))
        mask[b, :atoms] = 1.0

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    weights = (rnd(g, n, f), rnd(gauss, f, scale=(6 / (gauss + f)) ** 0.5), rnd(f, scale=0.1),
               rnd(f, f, scale=(3 / f) ** 0.5), rnd(f, scale=0.1))
    return torch.from_numpy(pos), torch.from_numpy(mask), weights, rnd(g, n, f)


def _rel(a, b):
    return float((a - b).abs().max()) / float(b.abs().max())


def plan_sizes(G, N, F, cap, mode, sms, bwd):
    """csrc/cfconv_wgmma.cu's ``plan_of``, restated: a row keeps at most
    cap + 1 neighbours under the index rule (the first cap + 1 candidates,
    itself among them or not), cap under the nearest, N - 1 at most; each
    item's last tile adds at most one tile; a graph's 5 N floats of state
    leave shared memory above 11,571 atoms; the message kernel's grid is
    a multiple of its output slabs (1 at F=128, 4 at 256), the weight-
    gradient kernel's (K2 at F=256) two blocks an SM of its 16 block types,
    each with a 64 x 64 block of dW2, a 16 x 64 one of dW1, db1 and db2;
    K2 at F=128 one kernel of a block an SM on tiles of 32 edges, each
    block with all of dW2, dW1 (64 rows), db1, db2 and two slots of an
    item's dx rows (4 keys) that runs share."""
    words, per_graph = math.ceil(N / 32), math.ceil(N / 4)
    items = G * per_graph
    per_row = max(0, min(cap + (mode == "index"), N - 1))
    fused = bwd and F == 128
    tile = 32 if fused else 64
    tiles = G * N * per_row // tile + items + 1
    slabs = 1 if F == 128 else 4
    if fused:
        msg, dw, partial = 0, sms, sms * (128 * 128 + 64 * 128 + 2 * 128 + 2 * 4 * 128)
    else:
        msg, dw = slabs * max(1, sms // slabs), 16 * max(1, 2 * sms // 16) if bwd else 0
        partial = dw * (64 * 64 + 16 * 64 + 128)
    return WgmmaPlan(items=items, tiles=tiles,
                     scratch_ints=G * N * words + G * N + 2 * items + tiles,
                     edge_ints=4 * tile * tiles,
                     state_floats=G * 5 * N if 20 * N > 232_448 - 1024 else 0,
                     msg_blocks=msg, dw_blocks=dw, partial_floats=partial)


@pytest.mark.parametrize("tile", [64, 32])
@pytest.mark.parametrize("source_major", [False, True])
@pytest.mark.parametrize("cap_mode", ["index", "nearest"])
def test_edge_tiles_hold_every_edge_once_in_order(source_major, cap_mode, tile):
    pos, mask, _, _ = _graphs(192, seed=3, f=8, gauss=4)
    key, other, d, gate, tile_item, item_start, item_tiles = wgmma_edge_tiles(
        pos, mask, CUTOFF, CAP, source_major, cap_mode, tile)
    g, i, j = edge_list(pos, mask, CUTOFF, CAP, source_major, cap_mode)
    real = key != WG_PAD_KEY
    want_key, want_other = (j, i) if source_major else (i, j)
    assert torch.equal(key[real], want_key) and torch.equal(other[real], want_other)
    assert bool((gate[~real] == 0).all()) and bool((gate[real] >= 0).all())
    # whole tiles per item: a tile holds one item's edges, only its last is padded
    per_graph = -(-192 // WG_KEYS)
    item_of = torch.div(key, WG_KEYS, rounding_mode="floor") + per_graph * torch.div(
        tile_item, per_graph, rounding_mode="floor")[:, None]
    assert bool((item_of[real] == tile_item[:, None].expand_as(key)[real]).all())
    assert torch.equal(torch.repeat_interleave(torch.arange(len(item_tiles)), item_tiles), tile_item)
    assert torch.equal(item_start, torch.cumsum(item_tiles, 0) - item_tiles)
    pads = (~real).sum(1)
    last = torch.cat([tile_item[1:] != tile_item[:-1], torch.tensor([True])])
    assert key.shape[1] == tile
    assert bool((pads[~last] == 0).all()) and bool((pads < tile).all())
    # keys ascend within a tile, and the padding sorts last
    assert bool((key[:, 1:] >= key[:, :-1]).all())
    plan = plan_sizes(2, 192, 128, CAP, cap_mode, 132, bwd=tile == 32)
    assert key.shape[0] <= plan.tiles and plan.items == len(item_tiles)


@pytest.mark.parametrize("cap_mode", ["index", "nearest"])
@pytest.mark.parametrize("n", [160, 192])
@pytest.mark.parametrize("f,gauss", [(128, 50), (256, 10)])
def test_emulated_route_matches_the_plain_version(n, cap_mode, f, gauss):
    pos, mask, (x, w1, b1, w2, b2), cot = _graphs(n, seed=n + f, f=f, gauss=gauss)
    out, grads = cfconv_wgmma_emulated(pos, mask, x, w1, b1, w2, b2, cot, CUTOFF, CAP, cap_mode)
    leaves = [a.clone().requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    ref = _cfconv_plain(pos, mask, *leaves, CUTOFF, gauss, CAP, cap_mode)
    refs = torch.autograd.grad(ref, leaves, cot)
    assert _rel(out, ref.detach()) <= TOL
    for name, a, b in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, refs):
        assert _rel(a, b) <= TOL, name


@pytest.mark.parametrize("cap", [32, 8])
def test_plain_cfconv_at_n160_matches_jax(cap):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from conan_fgw_tpu.ops.pallas.cfconv import _cfconv_xla

    pos, mask, (x, w1, b1, w2, b2), cot = _graphs(160, seed=11, f=16, gauss=10)

    def jloss(x, w1, b1, w2, b2):
        out = _cfconv_xla(jnp.asarray(pos.numpy()), jnp.asarray(mask.numpy()), x, w1, b1, w2, b2,
                          cutoff=CUTOFF, num_gaussians=10, max_neighbors=cap)
        return jnp.sum(out * jnp.asarray(cot.numpy())), out

    (_, out_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a.numpy()) for a in (x, w1, b1, w2, b2)))
    leaves = [a.clone().requires_grad_(True) for a in (x, w1, b1, w2, b2)]
    out_t = _cfconv_plain(pos, mask, *leaves, CUTOFF, 10, cap)
    (out_t * cot).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=CF_RTOL, atol=CF_ATOL)
    for name, a, gj in zip(("x", "w1", "b1", "w2", "b2"), leaves, grads_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(gj), rtol=CF_RTOL, atol=CF_ATOL,
                                   err_msg=f"grad {name}")


def test_route_by_atom_count():
    assert route(1) == route(128) == "small"
    assert route(129) == route(192) == route(4096) == "wgmma"
    # K2 at both widths above 128 atoms: csrc/cfconv_wgmma.cu's kernels
    assert route(128, 128, bwd=True) == route(128, 256, bwd=True) == "small"
    assert route(129, 128, bwd=True) == route(4096, 128, bwd=True) == "wgmma"
    assert route(129, 256, bwd=True) == route(192, 256) == "wgmma"


@pytest.mark.parametrize("x0,x1", [(-30.0, -4.0), (-4.0, 4.0), (4.0, 30.0)])
def test_kernel_softplus_within_its_bound(x0, x1):
    """``ssp_approx`` (the kernels' formula in f32) and the same formula with
    ex2.approx's and lg2.approx's errors at their bounds (2^-22 of the
    result, 2^-22 absolute) lie within 3.5e-7 of the exact softplus(x) - log 2
    beyond half an f32 ulp of the result, over the pre-activations' range."""
    x = torch.linspace(x0, x1, 200_001, dtype=torch.float32)
    exact = torch.nn.functional.softplus(x.double()) - math.log(2.0)
    slack = 3.5e-7 + exact.abs() * 2.0**-24
    assert bool(((ssp_approx(x).double() - exact).abs() <= slack).all())
    xd = x.double()
    t = torch.exp2(-xd.abs() * (1 / math.log(2.0)))
    for et in (-1, 1):
        for el in (-1, 1):
            lg = torch.log2((1 + t * (1 + et * 2.0**-22)).float().double()) + el * 2.0**-22
            worst = xd.clamp(min=0) + (lg - 1) * math.log(2.0)
            assert bool(((worst - exact).abs() <= slack).all()), (et, el)


def test_kernel_rbf_within_its_bound():
    """``rbf_approx`` (K2 at F=128's Gaussians on ex2.approx), with
    ex2.approx's error (2^-22 of its result) at either bound, within 4e-7 of
    the same centres through an accurate exp, and within 2e-6 of
    ``gaussian_smearing`` in f32 (the values lie in [0, 1]; the kernels
    compute a centre above the middle as ``cutoff - step (Gs - 1 - k)`` in
    f32, an ulp from ``torch.linspace``'s at some k, as their accurate route
    does too), over distances past the cutoff, at 50 Gaussians and at 2."""
    from conan_fgw_tpu_torch.ops.rbf import gaussian_smearing

    d = torch.linspace(0.0, 12.0, 20_001, dtype=torch.float32)
    for gs in (50, 2):
        smeared = gaussian_smearing(d, gs, 0.0, CUTOFF).double()
        approx = rbf_approx(d, gs, CUTOFF).double()
        step = torch.tensor(CUTOFF / (gs - 1))
        k = torch.arange(gs)
        mu = torch.where(k < gs // 2, step * k, CUTOFF - step * (gs - 1 - k))
        accurate = torch.exp((-0.5 / (step * step)).double() * (d[:, None] - mu).double() ** 2)
        for err in (-1, 0, 1):
            worst = approx * (1 + err * 2.0**-22)
            assert float((worst - accurate).abs().max()) <= 4e-7, (gs, err)
            assert float((worst - smeared).abs().max()) <= 2e-6, (gs, err)


def test_kernel_sigmoid_within_its_bound():
    """``sigmoid_from_ssp`` (K2 at F=128's ssp' from the split h of
    ``ssp_approx``) within 1e-6 of the exact sigmoid over the
    pre-activations' range, with ex2.approx's error (2^-22 of its result)
    at either bound: at pre << 0 it cancels to an absolute error, far
    inside the 5e-4 gate of dpre = dh ssp'(pre) against its largest."""
    x = torch.linspace(-30.0, 30.0, 600_001, dtype=torch.float32)
    exact = torch.sigmoid(x.double())
    h = ssp_approx(x)
    assert float((sigmoid_from_ssp(h).double() - exact).abs().max()) <= 1e-6
    e = torch.exp(-h.double())
    for err in (-1, 1):
        worst = 1 - 0.5 * e * (1 + err * 2.0**-22)
        assert float((worst - exact).abs().max()) <= 1e-6, err


PLAN_CASES = [
    (90, 192, 128, 32, "index", 132, False),
    (90, 192, 128, 32, "nearest", 132, True),
    (10, 544, 128, 32, "index", 114, True),
    (90, 192, 256, 32, "nearest", 132, True),
    (18, 1000, 256, 1000, "index", 114, True),
    (3, 12000, 128, 32, "index", 132, False),
]


@pytest.mark.parametrize("G,N,F,cap,mode,sms,bwd", PLAN_CASES)
def test_plan_sizes_the_grids_and_scratch(G, N, F, cap, mode, sms, bwd):
    """The wrapper's buffers for a plan: the index scratch and the edge
    records of its sizes, a graph state scratch only where the plan has
    one (above 11,571 atoms), and grids that the kernels' C entries accept
    (multiples of the output slabs and of the block types)."""
    plan = plan_sizes(G, N, F, cap, mode, sms, bwd)
    scratch, edges, state = _wgmma_scratch(plan, "cpu")
    assert scratch.dtype == edges.dtype == torch.int32
    assert scratch.numel() == plan.scratch_ints and edges.numel() == plan.edge_ints
    assert (state is None) == (N <= 11571)
    assert state is None or state.numel() == plan.state_floats == G * 5 * N
    assert plan.msg_blocks % (1 if F == 128 else 4) == 0
    assert plan.dw_blocks == ((sms if F == 128 else 16 * max(1, 2 * sms // 16)) if bwd else 0)
    assert plan.items == G * math.ceil(N / 4) and (plan.dw_blocks > 0) == bwd
    assert (plan.msg_blocks > 0) == (not bwd or F == 256)


def test_the_tile_bound_holds_a_dense_graph():
    """Every atom within the cutoff of every other: N - 1 neighbours a row
    under a cap of N, the most edges a graph can have."""
    pos = torch.rand(1, 140, 3)
    mask = torch.ones(1, 140)
    for sm in (False, True):
        key = wgmma_edge_tiles(pos, mask, CUTOFF, 140, sm)[0]
        assert int((key != WG_PAD_KEY).sum()) == 140 * 139
        assert key.shape[0] <= plan_sizes(1, 140, 128, 140, "index", 132, False).tiles


@pytest.mark.card
@pytest.mark.parametrize("f,gauss", [(128, 50), (256, 10)])
def test_kernels_match_the_plain_version_on_the_card(f, gauss):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from conan_fgw_tpu_torch.device import pin_full_f32

    pin_full_f32()
    pos, mask, params, cot = (t.cuda() if torch.is_tensor(t) else tuple(a.cuda() for a in t)
                              for t in _graphs(160, seed=5, f=f, gauss=gauss, g=8))
    assert route(160) == "wgmma"
    out = k12.cfconv_forward(pos, mask, *params, CUTOFF, CAP)
    grads = k12.cfconv_backward(pos, mask, *params, cot, CUTOFF, CAP)
    again = k12.cfconv_backward(pos, mask, *params, cot, CUTOFF, CAP)
    leaves = [a.clone().requires_grad_(True) for a in params]
    ref = _cfconv_plain(pos, mask, *leaves, CUTOFF, gauss, CAP)
    refs = torch.autograd.grad(ref, leaves, cot)
    assert _rel(out, ref.detach()) <= GATE
    for name, a, b, c in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, refs, again):
        assert _rel(a, b) <= GATE, name
        assert torch.equal(a, c), name


@pytest.mark.card
@pytest.mark.parametrize("cap_mode", ["index", "nearest"])
def test_bwd_f128_kernel_on_the_card(cap_mode):
    """K2 at F=128 above 128 atoms (``cfconv_bwd_wgmma_kernel``) against the
    plain version at N=192, two launches bit for bit, and its bf16 variant
    the f32 kernel's result on the widened inputs, rounded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from conan_fgw_tpu_torch.device import pin_full_f32

    pin_full_f32()
    pos, mask, params, cot = (t.cuda() if torch.is_tensor(t) else tuple(a.cuda() for a in t)
                              for t in _graphs(192, seed=7, f=128, gauss=50, g=8))
    grads = k12.cfconv_backward(pos, mask, *params, cot, CUTOFF, CAP, cap_mode)
    again = k12.cfconv_backward(pos, mask, *params, cot, CUTOFF, CAP, cap_mode)
    leaves = [a.clone().requires_grad_(True) for a in params]
    ref = _cfconv_plain(pos, mask, *leaves, CUTOFF, 50, CAP, cap_mode)
    refs = torch.autograd.grad(ref, leaves, cot)
    for name, a, b, c in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, refs, again):
        assert _rel(a, b) <= GATE, name
        assert torch.equal(a, c), name
    x16, cot16 = params[0].to(torch.bfloat16), cot.to(torch.bfloat16)
    narrow = k12.cfconv_backward(pos, mask, x16, *params[1:], cot16, CUTOFF, CAP, cap_mode)
    wide = k12.cfconv_backward(pos, mask, x16.float(), *params[1:], cot16.float(), CUTOFF, CAP,
                               cap_mode)
    assert torch.equal(narrow[0], wide[0].to(torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(narrow[1:], wide[1:]))


@pytest.mark.card
@pytest.mark.parametrize("G,N,F,cap,mode,sms,bwd", PLAN_CASES)
def test_library_plan_matches_plan_sizes_on_the_card(G, N, F, cap, mode, sms, bwd):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from conan_fgw_tpu_torch.ops.cuda import _build

    gs = 50 if F == 128 else 10
    lib = _build.load_library()
    assert wgmma_plan(lib, G, N, F, gs, cap, mode, sms, bwd) == plan_sizes(G, N, F, cap, mode, sms,
                                                                           bwd)
