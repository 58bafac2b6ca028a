"""Port parity in float16 compute (``compute_dtype: float16``) against the JAX
package on the CPU, and the other names ``device.py::compute_dtype``
takes: float64 computes as float32, and the names the JAX trunk refuses
raise. Small sizes (SchNet hidden 32, 2 interactions, N=32, B=4, K=2;
DimeNet hidden 16, 2 blocks, and its full width for the overflow).

The JAX SchNet sends an f16 trunk through its XLA cfconv (the Pallas kernels
take f32 and bf16 only), which the port's plain version follows on the CPU:
the filter MLP and the gated filter in f16, the neighbour sum in f32. The two
differ by f16 rounding alone (XLA's f16 ``log1p`` is off the correctly
rounded value in about an eighth of the elements, up to two ulps; PyTorch's
is correctly rounded), so the tolerances come from f16 itself, measured
against a float64 CPU step of the port's f32 model on the same weights:

- the port's f16 result may lie no farther from float64 than 1.5 times
  JAX's f16 result does, and no farther than 5e-3 (relative) from JAX's;
- a result is the trunk's output (relative L2 distance), or a training
  step's loss (relative) and gradient (the global norm of the difference
  over the gradient's): a step's distances are root mean squares over six
  batches, since one scalar loss at f16's rounding floor moves by a ulp
  either way from batch to batch (one batch alone put the port's loss 1.7
  times JAX's distance from float64, another 0.12 times).

DimeNet at full width (hidden 128, 6 blocks) overflows f16 in its triplet
tensors at random weights: about half its node outputs are inf or NaN in
JAX. The port must give them at the same positions (the non-finite mask
equal), and the finite ones within the gates above.
"""

import dataclasses
import math

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
from conan_fgw_tpu.models.schnet import SchNet3D as JSchNet3D
from conan_fgw_tpu.train import loop as jloop
from conan_fgw_tpu_torch.convert import params_from_flax
from conan_fgw_tpu_torch.data.packing import pack_batch as tpack
from conan_fgw_tpu_torch.data.synthetic import random_dataset as tdataset
from conan_fgw_tpu_torch.device import TypePromotionError
from conan_fgw_tpu_torch.models import dimenet as tdimenet
from conan_fgw_tpu_torch.models.heads import ConanModel
from conan_fgw_tpu_torch.models.schnet import SchNet3D
from conan_fgw_tpu_torch.train import loop as tloop
from test_torch_model import SMALL
from test_torch_visnet import flat_inputs

FARTHER = 1.5  # the port's distance from float64 over JAX's
RTOL_JAX = 5e-3  # the port's distance from JAX's f16 result
SEEDS = (7, 11, 13, 17, 19, 23)
F16 = dict(compute_dtype="float16")


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_f16_gates(port, jax16, f64, what):
    """The port's f16 result against JAX's and float64 (see the module
    docstring); ``port``, ``jax16`` and ``f64`` are distances' inputs."""
    d_port, d_jax, d_pj = _rel(port, f64), _rel(jax16, f64), _rel(port, jax16)
    assert d_port <= FARTHER * d_jax, (what, d_port, d_jax)
    assert d_pj <= RTOL_JAX, (what, d_pj)


# ---------------------------------------------------------------- SchNet
def _schnet_inputs():
    (z, pos, mask), (tz, tpos, tmask) = flat_inputs()
    return (z, pos, mask), (tz, tpos, tmask)


def _port_schnet(params, **options):
    model = SchNet3D(**SMALL, **options)
    state = params_from_flax({"backbone": jax.tree.map(np.asarray, params["params"])})
    model.load_state_dict({k.removeprefix("backbone."): v for k, v in state.items()})
    return model


def test_schnet_trunk_in_float16_matches_jax():
    (z, pos, mask), (tz, tpos, tmask) = _schnet_inputs()
    params = JSchNet3D(**SMALL).init(jax.random.PRNGKey(0), z, pos, mask)
    h_j, _ = JSchNet3D(**SMALL, **F16).apply(params, z, pos, mask, method=JSchNet3D.trunk)
    with torch.no_grad():
        h_t = _port_schnet(params, **F16).trunk(tz, tpos, tmask)
        h_64 = _port_schnet(params).double().trunk(tz, tpos.double(), tmask)
    assert h_t.dtype == torch.float32 and np.asarray(h_j).dtype == np.float32
    _assert_f16_gates(h_t.numpy(), np.asarray(h_j), h_64.numpy(), "trunk")
    # an f16 setting that did nothing would sit at f32's distance, 1e-7
    assert _rel(h_t.numpy(), h_64.numpy()) > 1e-5


def _batches(seed):
    recs = jdataset(seed, 4, num_conformers=2, heavy_range=(4, 9))
    jb = JBatch(**jax.tree.map(jnp.asarray, dataclasses.asdict(
        jpack(recs, max_atoms=32, batch_size=4))))
    tb = tpack(tdataset(seed, 4, num_conformers=2, heavy_range=(4, 9), device="cpu"),
               max_atoms=32, batch_size=4).to("cpu")
    return jb, tb


def _flat_grads(grads: dict) -> np.ndarray:
    return np.concatenate([np.asarray(grads[k], np.float64).ravel() for k in sorted(grads)])


def _port_step(model, tb, bary, f64=False):
    if f64:
        model, tb = model.double(), dataclasses.replace(tb, pos=tb.pos.double())
    pred, _ = model(tb, use_barycenter=bary)
    loss = tloop.masked_mse(pred, tb)
    loss.backward()
    grads = {k: np.zeros(p.shape) if p.grad is None else p.grad.numpy()
             for k, p in model.named_parameters()}
    return float(loss.detach()), _flat_grads(grads)


@pytest.mark.parametrize("stage", [1, 2])
def test_flagship_step_in_float16_matches_jax(stage):
    """The flagship ``ConanModel`` (SchNet) training step's loss and
    gradients in f16, over six batches (RMS distances)."""
    bary = stage == 2
    jb0, _ = _batches(SEEDS[0])
    params = JConan(**SMALL).init(jax.random.PRNGKey(0), jb0, use_barycenter=True)
    params = {k: v for k, v in params.items() if k != "diagnostics"}
    state = params_from_flax(jax.tree.map(np.asarray, params))
    jstep = jax.jit(jax.value_and_grad(
        jloop.make_loss_fn(JConan(**SMALL, **F16), jloop.TrainSettings(use_barycenter=bary)),
        has_aux=True))

    def port(**options):
        model = ConanModel(device="cpu", **SMALL, **options)
        model.load_state_dict(state)
        return model

    dist = {"port": [], "jax": [], "port-jax": []}
    for seed in SEEDS:
        jb, tb = _batches(seed)
        (loss_j, _), grads_j = jstep(params, jb)
        j16 = (float(loss_j), _flat_grads(params_from_flax(jax.tree.map(np.asarray, grads_j))))
        t16 = _port_step(port(**F16), tb, bary)
        r64 = _port_step(port(), tb, bary, f64=True)
        for key, (a, b) in (("port", (t16, r64)), ("jax", (j16, r64)), ("port-jax", (t16, j16))):
            dist[key].append((abs(a[0] - b[0]) / abs(b[0]), _rel(a[1], b[1])))
    rms = {k: np.sqrt(np.mean(np.square(v), axis=0)) for k, v in dist.items()}
    assert np.all(rms["port"] <= FARTHER * rms["jax"]), rms
    assert np.max(dist["port-jax"]) <= RTOL_JAX, dist["port-jax"]
    assert rms["port"][1] > 1e-5  # f16 did something


# ---------------------------------------------------------------- DimeNet
def _dimenet_pair(**kw):
    (z, pos, mask), (tz, tpos, tmask) = flat_inputs()
    params = jdimenet.DimeNet3D(**kw, remat=False).init(jax.random.PRNGKey(0), z, pos, mask)
    state = params_from_flax({"backbone": jax.tree.map(np.asarray, params["params"])})
    state = {k.removeprefix("backbone."): v for k, v in state.items()}

    def port(**options):
        model = tdimenet.DimeNet3D(**kw, **options)
        model.load_state_dict(state)
        return model

    return (z, pos, mask), (tz, tpos, tmask), params, port


def test_dimenet_in_float16_matches_jax():
    """Node outputs and the gradients of a fixed projection of them, at a
    width where f16 does not overflow."""
    kw = dict(hidden_channels=16, num_blocks=2)
    (z, pos, mask), (tz, tpos, tmask), params, port = _dimenet_pair(**kw)
    j16 = jdimenet.DimeNet3D(**kw, remat=False, **F16)
    out_j = np.asarray(j16.apply(params, z, pos, mask))
    w = np.random.default_rng(0).standard_normal(out_j.shape) / np.abs(out_j).max()

    def port_run(model, pos_t):
        out = model(tz, pos_t, tmask)
        (out * torch.from_numpy(w).to(out.dtype)).sum().backward()
        return out.detach().numpy(), _flat_grads({k: p.grad.numpy()
                                                  for k, p in model.named_parameters()})

    out_t, g_t = port_run(port(**F16), tpos)
    out_64, g_64 = port_run(port().double(), tpos.double())
    g_j = jax.grad(lambda p: jnp.sum(j16.apply(p, z, pos, mask) * w.astype(np.float32)))(params)
    g_j = _flat_grads({k.removeprefix("backbone."): v.numpy() for k, v in params_from_flax(
        {"backbone": jax.tree.map(np.asarray, g_j["params"])}).items()})
    assert out_t.dtype == np.float32 and np.isfinite(out_t).all()
    _assert_f16_gates(out_t, out_j, out_64, "dimenet outputs")
    _assert_f16_gates(g_t, g_j, g_64, "dimenet gradients")


def test_dimenet_full_width_overflows_where_jax_does():
    """At hidden 128 and 6 blocks the triplet tensors overflow f16: the
    port's inf and NaN stand where JAX's do, node by node, and the finite
    outputs pass the f16 gates."""
    kw = dict(hidden_channels=128, num_blocks=6)
    (z, pos, mask), (tz, tpos, tmask), params, port = _dimenet_pair(**kw)
    out_j = np.asarray(jdimenet.DimeNet3D(**kw, remat=False, **F16).apply(params, z, pos, mask))
    with torch.no_grad():
        out_t = port(**F16)(tz, tpos, tmask).numpy()
        out_64 = port().double()(tz, tpos.double(), tmask).numpy()
    bad = ~np.isfinite(out_j)
    assert 0 < bad.mean() < 1, bad.mean()
    np.testing.assert_array_equal(~np.isfinite(out_t), bad)
    np.testing.assert_array_equal(np.isnan(out_t), np.isnan(out_j))
    _assert_f16_gates(out_t[~bad], out_j[~bad], out_64[~bad], "finite dimenet outputs")


# ---------------------------------------------------------------- other names
def test_float64_computes_as_float32_bit_for_bit():
    """``compute_dtype: float64`` warns and gives the float32 model's step
    bit for bit (JAX without x64 truncates it to float32)."""
    _, tb = _batches(SEEDS[0])
    torch.manual_seed(0)
    with pytest.warns(UserWarning, match="float32"):
        m64 = ConanModel(device="cpu", seed=1, compute_dtype="float64", **SMALL)
    m32 = ConanModel(device="cpu", seed=1, **SMALL)
    assert all(p.dtype == torch.float32 for p in m64.parameters())
    loss64, g64 = _port_step(m64, tb, True)
    loss32, g32 = _port_step(m32, tb, True)
    assert loss64 == loss32 and np.array_equal(g64, g32)


@pytest.mark.parametrize("name,error,match", [
    ("float8_e4m3fn", TypePromotionError, "promotion"),
    ("float8_e5m2", TypePromotionError, "promotion"),
    ("float4_e2m1fn", TypePromotionError, "promotion"),
    ("float6_e3m2fn", TypeError, "JAX only supports"),
    ("int8", ValueError, "inexact"),
    ("uint4", ValueError, "inexact"),
    ("bool", ValueError, "inexact"),
    ("float 16", ValueError, "names no type"),
    ("complex64", NotImplementedError, "ROADMAP"),
])
def test_models_refuse_what_the_jax_trunk_refuses(name, error, match):
    """The SchNet and DimeNet models raise at construction where the JAX
    trunk raises at its first product (``TypePromotionError`` is a
    ``ValueError``, as JAX's is); complex, which the JAX trunk runs, is left
    out of the port and says so."""
    assert issubclass(TypePromotionError, ValueError)
    for build in (lambda: ConanModel(device="cpu", compute_dtype=name, **SMALL),
                  lambda: tdimenet.DimeNet3D(hidden_channels=16, num_blocks=2,
                                             compute_dtype=name)):
        with pytest.raises(error, match=match):
            build()


def test_log2_constants_are_exact_in_their_types():
    from conan_fgw_tpu_torch.ops.rbf import LOG2_BF16, LOG2_F16

    for value, dtype in ((LOG2_BF16, torch.bfloat16), (LOG2_F16, torch.float16)):
        assert float(torch.tensor(math.log(2.0), dtype=dtype)) == value
