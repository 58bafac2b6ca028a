"""Port parity in bf16 compute (``compute_dtype: bfloat16``) against the JAX
package on the CPU, at a small size (hidden 32, 2 interactions, N=32, B=4,
K=2 for SchNet; hidden 16, 2 blocks for DimeNet), under weights copied by
``params_from_flax``.

The JAX SchNet sends a bf16 trunk through the Pallas cfconv on the card
(``use_pallas_cfconv=True``, run here in interpret mode), which computes the
filter in f32; its XLA route computes it in bf16. The port follows the
Pallas route, so it is held to it, and must lie at least 5 times closer to
it than to the XLA route and to the f32 model: a bf16 setting that did
nothing, or rounded elsewhere, fails.

Tolerances, from what these inputs measure (in brackets):
- the plain cfconv on bf16 ``x`` against ``fused_cfconv``'s bf16 contract:
  ``out`` and ``dx`` within one bf16 ulp of the JAX result beyond the f32
  results' own distance (both round an f32 sum once), the f32 weight
  gradients to 1e-5 of their largest [3e-7];
- the kernels' arithmetic in bf16 mode (``cfconv_edges``) against the plain
  version: the same one-ulp gate;
- the models' forward to 1e-5 of the largest output [2e-7 SchNet, 8e-7
  DimeNet], where the XLA route and the f32 model lie 1e-3 away;
- a training step's loss to 1e-5 [1e-7]; each gradient leaf to 1e-4 of its
  norm [7e-7], except the biases of the bf16 ``Dense`` layers, to 5e-2
  [3e-2]: the JAX gradient on the CPU sums a bias's bf16 cotangent over the
  rows in bf16 (``lax.reduce_sum`` in the broadcast's transpose), the port in
  f32 with one rounding;
- DimeNet's gradients to 5e-3 of the global norm [2e-3] and 1e-2 of each
  leaf's [5e-3]: the backward rounds bf16 cotangents (the triplet gather's
  transpose, the f32 contraction's) where XLA's CPU backend sums in bf16,
  and at least twice as close to the JAX bf16 gradients as to the f32 ones
  [4.5 times].
"""

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.data.packing import PackedBatch as JBatch
from conan_fgw_tpu.data.packing import pack_batch as jpack
from conan_fgw_tpu.data.synthetic import random_dataset as jdataset
from conan_fgw_tpu.models import dimenet as jdimenet
from conan_fgw_tpu.models.heads import ConanModel as JConan
from conan_fgw_tpu.ops.pallas.cfconv import fused_cfconv
from conan_fgw_tpu.ops.rbf import shifted_softplus as j_ssp
from conan_fgw_tpu_torch.convert import params_from_flax
from conan_fgw_tpu_torch.device import compute_dtype
from conan_fgw_tpu_torch.data.packing import pack_batch as tpack
from conan_fgw_tpu_torch.data.synthetic import random_dataset as tdataset
from conan_fgw_tpu_torch.models import dimenet as tdimenet
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.models.schnet import dense
from conan_fgw_tpu_torch.ops.cuda.cfconv import _cfconv_plain, cfconv_edges, split_mm
from conan_fgw_tpu_torch.ops.graph import gather_rows
from conan_fgw_tpu_torch.ops.rbf import shifted_softplus
from conan_fgw_tpu_torch.train import config as tconfig
from conan_fgw_tpu_torch.train import loop as tloop
from conan_fgw_tpu_torch.train import runner as trunner
from test_pallas_cfconv import _problem
from test_torch_runner import _cli, tiny_dataset, write_config
from test_torch_visnet import flat_inputs, grads_of

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(hidden_channels=32, num_filters=32, num_gaussians=10, num_interactions=2)
DIMENET = dict(hidden_channels=16, num_blocks=2)
BF16 = dict(compute_dtype="bfloat16")
FWD_RTOL, LOSS_RTOL, LEAF_RTOL, BIAS_RTOL = 1e-5, 1e-5, 1e-4, 5e-2
WEIGHT_GRAD_RTOL = 1e-5
DN_GLOBAL_RTOL, DN_LEAF_RTOL = 5e-3, 1e-2
CLOSER = 5.0  # the port lies this many times closer to the Pallas route


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    """One CPU thread runs these shapes about as fast as many and keeps the
    file from fighting other test workers for cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def bf16_ulp(t: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at each element of ``t``."""
    mant, exp = np.frexp(np.asarray(t, np.float64))
    return np.where(mant == 0, 0.0, np.ldexp(1.0, exp - 8))


def assert_within_ulp(got, want, got32, want32):
    """bf16 ``got`` within one bf16 ulp of ``want`` beyond the distance of
    the f32 results ``got32``, ``want32`` they round."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    ulp = np.maximum(bf16_ulp(got), bf16_ulp(want))
    slack = np.abs(np.asarray(got32, np.float64) - np.asarray(want32, np.float64))
    assert np.all(np.abs(got - want) <= ulp + slack)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


# ---------------------------------------------------------------- cfconv
def test_plain_cfconv_in_bf16_matches_the_pallas_contract():
    """Plain ``cfconv`` on bf16 ``x`` against JAX ``fused_cfconv`` on bf16
    ``x`` (interpret mode): out and dx bf16, the weight gradients f32."""
    pos, mask, x, w1, b1, w2, b2 = _problem(seed=4)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    cot_b = jnp.asarray(cot).astype(jnp.bfloat16)
    args = tuple(map(jnp.asarray, (w1, b1, w2, b2)))

    def jfun(x_, *w):
        return fused_cfconv(jnp.asarray(pos), jnp.asarray(mask), x_, *w, 10.0, 10, 32)

    out_j, vjp = jax.vjp(jfun, xb, *args)
    grads_j = vjp(cot_b)
    out32_j, vjp32 = jax.vjp(jfun, xb.astype(jnp.float32), *args)
    dx32_j = vjp32(cot_b.astype(jnp.float32))[0]
    assert out_j.dtype == grads_j[0].dtype == jnp.bfloat16

    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    x_t = t(xb).to(torch.bfloat16).requires_grad_(True)
    ws = [t(w).requires_grad_(True) for w in (w1, b1, w2, b2)]
    out_t = _cfconv_plain(t(pos), t(mask), x_t, *ws, 10.0, 10, 32)
    grads_t = torch.autograd.grad(out_t, [x_t, *ws], t(cot_b).to(torch.bfloat16))
    assert out_t.dtype == grads_t[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in grads_t[1:])

    x32 = x_t.detach().float().requires_grad_(True)
    out32_t = _cfconv_plain(t(pos), t(mask), x32, *ws, 10.0, 10, 32)
    dx32_t = torch.autograd.grad(out32_t, x32, t(cot_b))[0]
    assert_within_ulp(out_t.detach().float().numpy(), np.asarray(out_j, np.float32),
                      out32_t.detach().numpy(), np.asarray(out32_j))
    assert_within_ulp(grads_t[0].float().numpy(), np.asarray(grads_j[0], np.float32),
                      dx32_t.numpy(), np.asarray(dx32_j))
    for got, want in zip(grads_t[1:], grads_j[1:]):
        assert _rel(got.numpy(), np.asarray(want)) <= WEIGHT_GRAD_RTOL


@pytest.mark.parametrize("F,gauss,slab", [(128, 50, None), (256, 10, 64)], ids=["F128", "F256"])
def test_kernel_arithmetic_in_bf16_is_within_one_ulp_of_plain(F, gauss, slab):
    """``cfconv_edges`` in bf16 mode (the kernels' bf16 variants: widen,
    compute as in f32 with the 3xTF32 split, round once) against the plain
    version, forward and dx; the weight gradients equal f32 mode's."""
    recs = tdataset(0, 2, num_conformers=5, heavy_range=(8, 13), device="cpu")
    pb = tpack(recs, max_atoms=32, batch_size=2).to("cpu")
    pos = pb.pos.reshape(-1, 32, 3).contiguous()
    mask = pb.atom_mask.repeat_interleave(5, dim=0).to(torch.float32)
    rng = np.random.default_rng(F)

    def rnd(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32))

    G = pos.shape[0]
    x, cot = rnd(G, 32, F).bfloat16(), rnd(G, 32, F).bfloat16()
    w1, b1 = rnd(gauss, F, scale=(6 / (gauss + F)) ** 0.5), rnd(F, scale=0.1)
    w2, b2 = rnd(F, F, scale=(3 / F) ** 0.5), rnd(F, scale=0.1)
    out, (dx, *dw) = cfconv_edges(pos, mask, x, w1, b1, w2, b2, cot, 10.0, 32, mm=split_mm,
                                  slab=slab)
    out32, (dx32, *dw32) = cfconv_edges(pos, mask, x.float(), w1, b1, w2, b2, cot.float(), 10.0,
                                        32, mm=split_mm, slab=slab)
    assert out.dtype == dx.dtype == torch.bfloat16
    assert torch.equal(out, out32.bfloat16()) and torch.equal(dx, dx32.bfloat16())
    assert all(torch.equal(a, b) for a, b in zip(dw, dw32))
    leaves = [x.clone().requires_grad_(True)] + [
        w.clone().requires_grad_(True) for w in (w1, b1, w2, b2)]
    out_p = _cfconv_plain(pos, mask, *leaves, 10.0, gauss, 32)
    dx_p = torch.autograd.grad(out_p, leaves[0], cot)[0]
    x32 = x.float().requires_grad_(True)
    out_p32 = _cfconv_plain(pos, mask, x32, w1, b1, w2, b2, 10.0, gauss, 32)
    dx_p32 = torch.autograd.grad(out_p32, x32, cot.float())[0]
    assert_within_ulp(out.float().numpy(), out_p.detach().float().numpy(), out32.numpy(),
                      out_p32.detach().numpy())
    assert_within_ulp(dx.float().numpy(), dx_p.float().numpy(), dx32.numpy(), dx_p32.numpy())


def test_shifted_softplus_rounds_as_jax_in_bf16():
    """Forward bit for bit, and the gradient of ``logaddexp``'s JVP, on bf16."""
    x = np.random.default_rng(0).standard_normal(20000).astype(np.float32) * 4
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, grad_want = jax.value_and_grad(lambda v: jnp.sum(j_ssp(v).astype(jnp.float32)))(xb)
    del want
    xt = torch.from_numpy(np.asarray(xb, np.float32)).bfloat16().requires_grad_(True)
    got = shifted_softplus(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(), np.asarray(j_ssp(xb), np.float32))
    got.float().sum().backward()
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(grad_want, np.float32))


def test_dense_rounds_as_flax_dense_in_bf16():
    """``dense`` against flax ``Dense(dtype=bf16)``: the product and the bias
    add each rounded to bf16."""
    import flax.linen as fnn

    rng = np.random.default_rng(1)
    x = rng.standard_normal((64, 48)).astype(np.float32)
    layer = fnn.Dense(40, dtype=jnp.bfloat16)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: a + 0.1, params)  # a non-zero bias
    want = np.asarray(layer.apply(params, jnp.asarray(x)), np.float32)
    lin = torch.nn.Linear(48, 40)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(params["params"]["kernel"]).T.copy()))
        lin.bias.copy_(torch.from_numpy(np.array(params["params"]["bias"])))
    got = dense(lin, torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(), want)


# ---------------------------------------------------------------- SchNet models
def make_models(task="regression", seed=0, batch_seed=7):
    """The JAX model in f32, bf16 through the Pallas route and bf16 through
    the XLA route, all on the f32 model's parameters; the port's bf16 model
    with the same weights; one batch in both forms."""
    recs = jdataset(batch_seed, 4, num_conformers=2, heavy_range=(4, 9))
    pb = jpack(recs, max_atoms=32, batch_size=4)
    jbatch = JBatch(**jax.tree.map(jnp.asarray, dataclasses.asdict(pb)))
    j32 = JConan(task=task, **SMALL)
    params = j32.init(jax.random.PRNGKey(seed), jbatch, use_barycenter=True)
    params = {k: v for k, v in params.items() if k != "diagnostics"}
    jpallas = JConan(task=task, use_pallas_cfconv=True, **BF16, **SMALL)
    jxla = JConan(task=task, use_pallas_cfconv=False, **BF16, **SMALL)
    tmodel = ConanModel(task=task, device="cpu", **BF16, **SMALL)
    tmodel.load_state_dict(params_from_flax(jax.tree.map(np.asarray, params)))
    tbatch = tpack(tdataset(batch_seed, 4, num_conformers=2, heavy_range=(4, 9), device="cpu"),
                   max_atoms=32, batch_size=4).to("cpu")
    return (j32, jpallas, jxla), params, jbatch, tmodel, tbatch


def _forward_case(task, stage):
    (j32, jpallas, jxla), params, jbatch, tmodel, tbatch = make_models(task)
    bary = stage == 2
    with torch.no_grad():
        got = tmodel(tbatch, use_barycenter=bary)[0].numpy()
    want, xla, f32 = (np.asarray(m.apply(params, jbatch, use_barycenter=bary))
                      for m in (jpallas, jxla, j32))
    scale = float(np.abs(f32).max())
    err = float(np.abs(got - want).max()) / scale
    assert err <= FWD_RTOL, err
    for other in (xla, f32):
        assert float(np.abs(got - other).max()) / scale >= CLOSER * max(err, 1e-7)
    assert tmodel.backbone.blocks[0].compute_dtype == torch.bfloat16


@pytest.mark.parametrize("stage", [1, 2])
def test_regression_forward_matches_the_pallas_route(stage):
    _forward_case("regression", stage)


@pytest.mark.parametrize("stage", [1, 2])
def test_classification_forward_matches_the_pallas_route(stage):
    _forward_case("classification", stage)


def _masked_mse_j(pred, jbatch):
    m = jbatch.mol_mask.astype(jnp.float32)
    return jnp.sum(m * (pred[:, 0] - jbatch.y) ** 2) / jnp.maximum(jnp.sum(m), 1.0)


@pytest.mark.parametrize("stage", [1, 2])
def test_regression_train_step_matches_the_pallas_route(stage):
    """One training step's loss (masked MSE) and gradients."""
    models, params, jbatch, tmodel, tbatch = make_models()
    bary = stage == 2

    def jgrads(model):
        loss, g = jax.value_and_grad(
            lambda p: _masked_mse_j(model.apply(p, jbatch, use_barycenter=bary), jbatch))(params)
        return float(loss), {k: v.numpy() for k, v in
                             params_from_flax(jax.tree.map(np.asarray, g)).items()}

    (l32, g32), (lp, gp), (lx, gx) = (jgrads(m) for m in models)
    loss = tloop.masked_mse(tmodel(tbatch, use_barycenter=bary)[0], tbatch)
    loss.backward()
    lt = float(loss.detach())
    assert abs(lt - lp) <= LOSS_RTOL * abs(lp)
    for other in (lx, l32):
        assert abs(lt - other) >= CLOSER * abs(lt - lp)
    bf16_biases = {f"backbone.blocks.{i}.{lin}.bias" for i in range(SMALL["num_interactions"])
                   for lin in ("lin2", "lin")}
    got = {k: p.grad.numpy() for k, p in tmodel.named_parameters() if p.grad is not None}
    assert set(got) <= set(gp)  # stage 1: no gradient for the barycenter heads, JAX's zeros
    assert all(not np.any(gp[k]) for k in set(gp) - set(got))
    for k, g in got.items():
        rtol = BIAS_RTOL if k in bf16_biases else LEAF_RTOL
        assert np.linalg.norm(g - gp[k]) <= rtol * np.linalg.norm(gp[k]) + 1e-9, k

    def dist(want):
        return math.sqrt(sum(float(np.sum((got[k] - want[k]) ** 2)) for k in got
                             if k not in bf16_biases))

    assert min(dist(gx), dist(g32)) >= CLOSER * dist(gp)


def test_params_from_flax_maps_the_bf16_trees():
    """bf16 compute changes no parameter: the JAX bf16 models' trees equal
    the f32 ones' in shape and type, and load strictly into the port's bf16
    models (SchNet and DimeNet); their parameters stay f32."""
    (j32, jpallas, _), params, jbatch, _, _ = make_models()
    shapes = jax.tree.map(lambda a: (a.shape, a.dtype), params)
    bf16_params = jpallas.init(jax.random.PRNGKey(0), jbatch, use_barycenter=True)
    bf16_params = {k: v for k, v in bf16_params.items() if k != "diagnostics"}
    assert jax.tree.map(lambda a: (a.shape, a.dtype), bf16_params) == shapes
    model = ConanModel(device="cpu", **BF16, **SMALL)
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, bf16_params)))
    assert all(p.dtype == torch.float32 for p in model.parameters())

    (z, pos, mask), _ = flat_inputs()
    dn32 = jdimenet.DimeNet3D(**DIMENET, remat=False)
    dnb = jdimenet.DimeNet3D(**DIMENET, remat=False, **BF16)
    p32, pb = (m.init(jax.random.PRNGKey(0), z, pos, mask) for m in (dn32, dnb))
    assert jax.tree.map(lambda a: (a.shape, a.dtype), pb) == \
        jax.tree.map(lambda a: (a.shape, a.dtype), p32)
    state = params_from_flax({"backbone": jax.tree.map(np.asarray, pb["params"])})
    dn = tdimenet.DimeNet3D(**DIMENET, **BF16)
    dn.load_state_dict({k.removeprefix("backbone."): v for k, v in state.items()})
    assert all(p.dtype == torch.float32 for p in dn.parameters())


# ---------------------------------------------------------------- DimeNet
def test_dimenet_bf16_matches_jax():
    """``DimeNet3D(compute_dtype="bfloat16")``: f32 node outputs and
    gradients against the JAX module in bf16."""
    (z, pos, mask), (tz, tpos, tmask) = flat_inputs()
    j32 = jdimenet.DimeNet3D(**DIMENET, remat=False)
    jb = jdimenet.DimeNet3D(**DIMENET, remat=False, **BF16)
    params = j32.init(jax.random.PRNGKey(0), z, pos, mask)
    state = params_from_flax({"backbone": jax.tree.map(np.asarray, params["params"])})
    model = tdimenet.DimeNet3D(**DIMENET, **BF16)
    model.load_state_dict({k.removeprefix("backbone."): v for k, v in state.items()})
    out = model(tz, tpos, tmask)
    assert out.dtype == torch.float32
    want, f32 = (np.asarray(m.apply(params, z, pos, mask)) for m in (jb, j32))
    scale = float(np.abs(f32).max())
    err = float(np.abs(out.detach().numpy() - want).max()) / scale
    assert err <= FWD_RTOL, err
    assert float(np.abs(out.detach().numpy() - f32).max()) / scale >= CLOSER * err

    w = np.random.default_rng(0).standard_normal(f32.shape).astype(np.float32) / scale
    (out * torch.from_numpy(w)).sum().backward()
    got = grads_of(model)

    def jgrads(m):
        g = jax.grad(lambda p: jnp.sum(m.apply(p, z, pos, mask) * w))(params)
        flat = params_from_flax({"backbone": jax.tree.map(np.asarray, g["params"])})
        return {k.removeprefix("backbone."): v.numpy() for k, v in flat.items()}

    gb, g32 = jgrads(jb), jgrads(j32)

    def dist(want):
        return math.sqrt(sum(float(np.sum((got[k] - want[k]) ** 2)) for k in got))

    norm = math.sqrt(sum(float(np.sum(v ** 2)) for v in gb.values()))
    assert dist(gb) <= DN_GLOBAL_RTOL * norm
    for k in got:
        assert np.linalg.norm(got[k] - gb[k]) <= DN_LEAF_RTOL * np.linalg.norm(gb[k]) \
            + 1e-9 * norm, k
    assert dist(g32) >= 2.0 * dist(gb)


def test_dimenet_triplet_contraction_comes_out_in_f32():
    """``f32_product`` of bf16 operands: an f32 result equal to the product
    of the widened operands, gradients in the operands' type; and the bf16
    triplet gather's backward equals the f32 one rounded."""
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((2, 3, 8, 32)).astype(np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((2, 3, 32, 16)).astype(np.float32)).bfloat16()
    a.requires_grad_(True)
    b.requires_grad_(True)
    s1 = tdimenet.f32_product(a, b)
    assert s1.dtype == torch.float32
    torch.testing.assert_close(s1, a.detach().float() @ b.detach().float(), rtol=0, atol=0)
    s1.sum().backward()
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16

    table = torch.from_numpy(rng.standard_normal((2, 10, 6)).astype(np.float32)).bfloat16()
    idx = torch.from_numpy(rng.integers(0, 10, (2, 10, 4)))
    cot = torch.from_numpy(rng.standard_normal((2, 10, 4, 6)).astype(np.float32)).bfloat16()
    grads = []
    for dt in (torch.bfloat16, torch.float32):
        t = table.to(dt).detach().requires_grad_(True)
        gather_rows(t, idx).backward(cot.to(dt))
        grads.append(t.grad)
    assert grads[0].dtype == torch.bfloat16
    assert torch.equal(grads[0], grads[1].bfloat16())


# ---------------------------------------------------------------- the runner
def test_compute_dtype_leaves_visnet_and_the_aux_heads_unchanged(tmp_path):
    """As in the JAX runner, ``compute_dtype`` reaches the SchNet and DimeNet
    backbones only: a ViSNet model and an aux head built from a bf16 config
    give the f32 config's outputs bit for bit."""
    pb = tpack(tdataset(3, 2, num_conformers=2, heavy_range=(4, 8), device="cpu"),
               max_atoms=32, batch_size=2).to("cpu")
    cases = [(ROOT / "config" / "visnet" / "sol250_5.yaml", None),
             (Path(write_config(tmp_path, "aux.yaml", "pre", epochs=1)), "scalars")]
    for src, experiment in cases:
        text = src.read_text()
        if experiment:
            text = text.replace("experiment: regression", f"experiment: {experiment}")
        outs = []
        for dtype in ("float32", "bfloat16"):
            path = tmp_path / f"{src.stem}_{dtype}.yaml"
            path.write_text(text + f"compute_dtype: {dtype}\n")
            model = trunner.build_model(tconfig.load_config(str(path)), seed=1, device="cpu")
            with torch.no_grad():
                outs.append(model(pb, use_barycenter=False)[0])
        assert outs[0].dtype == torch.float32
        assert torch.equal(outs[0], outs[1]), src.name


def _jax_trunk_error(name):
    """The exception the JAX SchNet trunk raises at ``compute_dtype=name``
    on a tiny input, or None where it runs."""
    from conan_fgw_tpu.models.schnet import SchNet3D as JSchNet

    rng = np.random.default_rng(0)
    z, pos = jnp.asarray(rng.integers(1, 9, (2, 6))), jnp.asarray(rng.standard_normal((2, 6, 3)))
    mask = jnp.ones((2, 6), bool)
    kw = dict(hidden_channels=8, num_filters=8, num_gaussians=4, num_interactions=1)
    params = JSchNet(**kw).init(jax.random.PRNGKey(0), z, pos, mask)
    try:
        JSchNet(**kw, compute_dtype=name).apply(params, z, pos, mask, method=JSchNet.trunk)
    except (TypeError, ValueError) as e:
        return e
    return None


@pytest.mark.parametrize("name", ["float32", "f4", "bfloat16", "float16", "float64", "int32",
                                  "float8_e4m3fn", "bf16", "fp32", "float 32"])
def test_compute_dtype_refuses_as_jnp_dtype_does(name):
    """Each name maps as the JAX SchNet trunk treats it: float32 names to
    None (the parameters' type), bfloat16 and float16 to their types, a
    float64 name to None with a warning (JAX without x64 truncates it to
    float32); where the JAX trunk raises (an integer type, a float8 type
    with no promotion path), the port raises an error of the same class.
    A name ``jnp.dtype`` rejects raises ``ValueError``."""
    try:
        expected = jnp.dtype(name)
    except TypeError:
        with pytest.raises(ValueError, match="compute_dtype"):
            compute_dtype(name)
        return
    error = _jax_trunk_error(name)
    if error is not None:
        with pytest.raises((TypeError, ValueError)) as raised:
            compute_dtype(name)
        assert type(raised.value).__name__ == type(error).__name__, (raised.value, error)
        return
    if expected == jnp.float64:
        with pytest.warns(UserWarning, match="float32"):
            assert compute_dtype(name) is None
        return
    want = {jnp.float32: None, jnp.bfloat16: torch.bfloat16, jnp.float16: torch.float16}
    assert compute_dtype(name) is want[expected.type]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_dataset(tmp_path_factory.mktemp("tiny"))


def test_runner_trains_bf16_stage1_then_stage2(tiny, tmp_path, caplog):
    """A ``compute_dtype: bfloat16`` config trains stage 1 and then stage 2
    (warm-started from stage 1's f32 checkpoint) through the runner on the
    CPU, with the bf16 trunk."""
    import logging

    extra = "compute_dtype: bfloat16\n"
    pre = write_config(tmp_path, "pre.yaml", "pre", epochs=1, extra=extra)
    bc = write_config(tmp_path, "bc.yaml", "bc", epochs=1, extra=extra)
    built = []
    build = trunner.build_model

    def spy(*args, **kwargs):
        built.append(build(*args, **kwargs))
        return built[-1]

    trunner.build_model = spy
    try:
        with caplog.at_level(logging.INFO, logger="conan_fgw_tpu_torch"):
            trunner.main(_cli(tiny, pre, "conan_fgw_pre"))
            summary = trunner.main(_cli(tiny, bc, "conan_fgw"))
    finally:
        trunner.build_model = build
    assert "warm-started run 0" in caplog.text
    assert np.isfinite(summary["test_rmse"]["mean"])
    assert all(m.backbone.blocks[0].compute_dtype == torch.bfloat16 for m in built)
    best = np.load(tiny / "models" / "cli" / "1" / "run_conan_fgw:0" / "best.npz")
    assert all(best[k].dtype == np.float32 for k in best.files)
