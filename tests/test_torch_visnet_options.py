"""Port parity: ViSNet's options (``vertex``, ``vecnorm_type="max_min"``,
``trainable_vecnorm``, ``trainable_rbf``) against the JAX package's
``ViSNet3D`` on the CPU, under weights copied by ``params_from_flax``, at
``tests/test_torch_visnet.py``'s small size (hidden 32, 4 heads, 2 layers,
8 RBFs; N=32, B=4, K=2): forward within rtol 1e-4, atol 1e-5 and every
parameter's gradient within 1e-4 of its norm, as that file holds the
defaults. The JAX module has no Pallas path here.

The JAX module's ``trainable_rbf`` cannot run: ``_rbf`` declares its two
parameters with ``self.param`` outside ``setup`` and ``@compact``, and
flax raises ``ValueError`` at ``init``. ``JViSNet`` declares them in
``setup`` under the same names and keeps ``_rbf``'s formula; it is the
JAX module otherwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.models import visnet as jvisnet
from conan_fgw_tpu.ops.rbf import cosine_cutoff as j_cosine_cutoff
from conan_fgw_tpu.ops.rbf import expnorm_initial_params as j_expnorm_params
from conan_fgw_tpu_torch.convert import params_from_flax
from conan_fgw_tpu_torch.models import visnet as tvisnet
from conan_fgw_tpu_torch.models.heads import init_like_flax
from conan_fgw_tpu_torch.ops.rbf import expnorm_initial_params
from test_torch_visnet import RTOL, SMALL, _close, flat_inputs, grads_of

ALL = dict(vertex=True, vecnorm_type="max_min", trainable_vecnorm=True, trainable_rbf=True)
OPTIONS = {"vertex": dict(vertex=True), "max_min": dict(vecnorm_type="max_min"),
           "trainable_vecnorm": dict(trainable_vecnorm=True),
           "trainable_rbf": dict(trainable_rbf=True), "all": ALL}


class JViSNet(jvisnet.ViSNet3D):
    """The JAX ``ViSNet3D`` with ``trainable_rbf``'s ``rbf_means`` and
    ``rbf_betas`` declared in ``setup`` (the module's own ``_rbf`` raises)."""

    def setup(self):
        super().setup()
        if self.trainable_rbf:
            means, betas = j_expnorm_params(self.num_rbf, self.cutoff)
            self.rbf_means = self.param("rbf_means", lambda _: means)
            self.rbf_betas = self.param("rbf_betas", lambda _: betas)

    def _rbf(self, dist, edge_mask):
        if not self.trainable_rbf:
            return super()._rbf(dist, edge_mask)
        alpha = 5.0 / self.cutoff
        env = j_cosine_cutoff(dist, self.cutoff)
        rbf = env[..., None] * jnp.exp(
            -self.rbf_betas * (jnp.exp(-alpha * dist[..., None]) - self.rbf_means) ** 2)
        return rbf * edge_mask[..., None]


def backbone_pair(**options):
    """``JViSNet`` with its parameters and the port's holding the same
    weights."""
    (z, pos, mask), _ = flat_inputs()
    jmodel = JViSNet(**SMALL, **options)
    params = jmodel.init(jax.random.PRNGKey(0), z, pos, mask)
    tmodel = tvisnet.ViSNet3D(**SMALL, **options)
    state = params_from_flax({"backbone": jax.tree.map(np.asarray, params["params"])})
    tmodel.load_state_dict({k.removeprefix("backbone."): v for k, v in state.items()})
    return jmodel, params, tmodel


def test_the_jax_modules_trainable_rbf_raises():
    """Why ``JViSNet`` exists: flax refuses the module's own declaration."""
    (z, pos, mask), _ = flat_inputs()
    with pytest.raises(ValueError, match="setup"):
        jvisnet.ViSNet3D(**SMALL, trainable_rbf=True).init(jax.random.PRNGKey(0), z, pos, mask)


@pytest.fixture(autouse=True, scope="module")
def one_cpu_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", list(OPTIONS))
def test_backbone_with_options_matches_flax(name):
    """The trunk's scalars and vectors and both heads, with a binding cap
    (6), after one random perturbation of every weight the options add (a
    trainable weight left at its start would hide a wrong mapping)."""
    jmodel, params, tmodel = backbone_pair(max_neighbors=6, **OPTIONS[name])
    rng = np.random.default_rng(3)

    def nudge(path, leaf):
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        if any(s in key for s in ("VecLayerNorm", "vec_out_norm", "rbf_", "t_trg", "t_src")):
            return leaf * (1.0 + 0.2 * rng.standard_normal(np.shape(leaf)).astype(np.float32))
        return leaf

    params = jax.tree_util.tree_map_with_path(nudge, params)
    state = params_from_flax({"backbone": jax.tree.map(np.asarray, params["params"])})
    tmodel.load_state_dict({k.removeprefix("backbone."): v for k, v in state.items()})
    (z_j, pos_j, mask_j), (z, pos, mask) = flat_inputs(seed=5)
    h3_j, hb_j, nbr_j = jmodel.apply(params, z_j, pos_j, mask_j, method="embed_dual")
    x_j, vec_j, _ = jmodel.apply(params, z_j, pos_j, mask_j, method="trunk")
    with torch.no_grad():
        h3, hb, nbr = tmodel.embed_dual(z, pos, mask)
        x, vec, _ = tmodel.trunk(z, pos, mask)
    np.testing.assert_array_equal(nbr.numpy(), np.asarray(nbr_j))
    _close(x, x_j)
    _close(vec, vec_j)
    _close(h3, h3_j)
    _close(hb, hb_j)


@pytest.mark.parametrize("name", ["vertex", "max_min", "all"])
def test_backbone_gradients_with_options_match_flax(name):
    """Every parameter's gradient, the options' own included, with a
    binding cap."""
    jmodel, params, tmodel = backbone_pair(max_neighbors=6, **OPTIONS[name])
    (z_j, pos_j, mask_j), (z, pos, mask) = flat_inputs(seed=9)

    def loss_j(p):
        h3, hb, _ = jmodel.apply(p, z_j, pos_j, mask_j, method="embed_dual")
        return jnp.sum(h3 ** 2) + jnp.sum(jnp.sin(hb))

    grads_j = params_from_flax(
        {"backbone": jax.tree.map(np.asarray, jax.grad(loss_j)(params)["params"])})
    h3, hb, _ = tmodel.embed_dual(z, pos, mask)
    (torch.sum(h3 ** 2) + torch.sum(torch.sin(hb))).backward()
    got = grads_of(tmodel)
    assert set(got) == {k.removeprefix("backbone.") for k in grads_j}
    for key, g in got.items():
        want = grads_j[f"backbone.{key}"].numpy()
        assert np.linalg.norm(g - want) <= RTOL * np.linalg.norm(want) + 1e-8, key


def test_options_add_the_jax_parameters():
    """The options' parameters, by the names ``convert.py`` maps the flax
    tree to, at their flax initial values."""
    model = tvisnet.ViSNet3D(**SMALL, **ALL)
    init_like_flax(model, torch.Generator().manual_seed(0))
    names = dict(model.named_parameters())
    H = SMALL["hidden_channels"]
    means, betas = expnorm_initial_params(SMALL["num_rbf"], 5.0)
    assert torch.equal(names["rbf.means"], means) and torch.equal(names["rbf.betas"], betas)
    assert torch.equal(names["vec_out_norm.weight"], torch.ones(H))
    assert torch.equal(names["layers.0.vec_layernorm.weight"], torch.ones(H))
    assert names["layers.0.f_proj.weight"].shape == (2 * H, H)
    assert "layers.0.t_trg_proj.weight" in names and "layers.1.t_trg_proj.weight" not in names
    plain = dict(tvisnet.ViSNet3D(**SMALL).named_parameters())
    assert not any(k.startswith(("rbf.", "vec_out_norm")) or "vec_layernorm" in k for k in plain)


def test_max_min_norm_matches_flax_and_refuses_unknown_types():
    """``VecLayerNorm``'s max-min norm (with an all-zero atom, whose
    channels tie) and its gradient against flax's."""
    rng = np.random.default_rng(4)
    vec = rng.standard_normal((2, 5, 3, 8)).astype(np.float32)
    vec[1, 2] = 0.0
    w = (1.0 + 0.3 * rng.standard_normal(8)).astype(np.float32)
    jmod = jvisnet.VecLayerNorm(8, True, "max_min")

    def f(v):
        return jmod.apply({"params": {"weight": jnp.asarray(w)}}, v)

    out_j, vjp = jax.vjp(f, jnp.asarray(vec))
    g = rng.standard_normal(vec.shape).astype(np.float32)
    tmod = tvisnet.VecLayerNorm(8, True, "max_min")
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(w))
    v = torch.from_numpy(vec).requires_grad_(True)
    out = tmod(v)
    out.backward(torch.from_numpy(g))
    _close(out, out_j)
    _close(v.grad, vjp(jnp.asarray(g))[0])
    with pytest.raises(ValueError, match="vecnorm_type"):
        tvisnet.VecLayerNorm(8, norm_type="layer")
