"""Port parity: the JAX package's last public names in the port —
``models/attention.py::AttentionLayer``, ``models/heads.py::RegressionHead``
and ``data/vocab.py::BOND_STEREO``.

Tolerances: the attention map and the head's output rtol 1e-6 (f32, one
small product and a softmax); the vocabulary equal."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conan_fgw_tpu.data import vocab as jvocab
from conan_fgw_tpu.models.attention import AttentionLayer as JAttentionLayer
from conan_fgw_tpu.models.heads import RegressionHead as JRegressionHead
from conan_fgw_tpu_torch.convert import params_from_flax
from conan_fgw_tpu_torch.data import vocab as tvocab
from conan_fgw_tpu_torch.models.attention import AttentionLayer
from conan_fgw_tpu_torch.models.heads import ConanModel, RegressionHead

RTOL = 1e-6


def test_attention_layer_matches_flax():
    """``softmax(x * Dense(x), axis=1)`` on the JAX test's input
    (``tests/test_esan_aux.py::test_attention_layer``), weights carried by
    ``params_from_flax``; its columns sum to one."""
    x = np.random.default_rng(0).standard_normal((3, 5, 8)).astype(np.float32)
    layer = JAttentionLayer(n_feats=8)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    port = AttentionLayer(8)
    state = params_from_flax(jax.tree.map(np.asarray, params))
    assert set(state) == {"lin.weight", "lin.bias"}
    port.load_state_dict(state)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-5)


def test_regression_head_matches_flax_and_keeps_the_head_keys():
    """One Dense to one output; in ``ConanModel`` it keeps the state-dict
    keys ``head.weight``/``head.bias`` that checkpoints and
    ``convert.py`` use."""
    x = np.random.default_rng(1).standard_normal((4, 16)).astype(np.float32)
    head = JRegressionHead()
    params = head.init(jax.random.PRNGKey(1), jnp.asarray(x))
    want = np.asarray(head.apply(params, jnp.asarray(x)))
    port = RegressionHead(16)
    dense = params["params"]["Dense_0"]
    port.load_state_dict({"weight": torch.from_numpy(np.asarray(dense["kernel"]).T.copy()),
                          "bias": torch.from_numpy(np.asarray(dense["bias"]))})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 1)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)

    model = ConanModel(device="cpu", hidden_channels=32, num_filters=32, num_gaussians=10,
                       num_interactions=1)
    assert isinstance(model.head, RegressionHead)
    keys = [k for k in model.state_dict() if k.startswith("head.")]
    assert keys == ["head.weight", "head.bias"]


def test_bond_stereo_equals_jax():
    assert tvocab.BOND_STEREO == jvocab.BOND_STEREO
