"""Port parity: the cfconv (kernels K1/K2's plain version) against the JAX
package's XLA formulation and, in one tiny case, its Pallas kernel in
interpret mode. Tolerance: forward and all five gradients rtol 5e-4
(the kernel contract of ``conan_fgw_tpu/ops/pallas/cfconv.py``), with an
absolute 1e-5 floor for entries near zero."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conan_fgw_tpu.ops.pallas.cfconv import _cfconv_xla, fused_cfconv
from conan_fgw_tpu_torch.ops.cuda import launches, reset_launches
from conan_fgw_tpu_torch.ops.cuda.cfconv import _cfconv_plain, cfconv

RTOL, ATOL = 5e-4, 1e-5


def _problem(g=3, n=16, f=32, gauss=10, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.standard_normal((g, n, 3)).astype(np.float32) * 2.0
    mask = np.ones((g, n), np.float32)
    mask[:, n - 3:] = 0.0
    pos[:, n - 3:] += 1e4  # padding far away
    x = rng.standard_normal((g, n, f)).astype(np.float32)
    w1 = (rng.standard_normal((gauss, f)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal((f,)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((f, f)) * 0.2).astype(np.float32)
    b2 = (rng.standard_normal((f,)) * 0.1).astype(np.float32)
    cot = rng.standard_normal((g, n, f)).astype(np.float32)
    return (pos, mask, x, w1, b1, w2, b2), cot


@pytest.mark.parametrize("cap", [32, 5])
def test_forward_and_grads_match_jax(cap):
    args, cot = _problem(seed=1)
    pos, mask = (jnp.asarray(a) for a in args[:2])

    def jloss(x, w1, b1, w2, b2):
        out = _cfconv_xla(pos, mask, x, w1, b1, w2, b2, cutoff=10.0, num_gaussians=10,
                          max_neighbors=cap)
        return jnp.sum(out * jnp.asarray(cot)), out

    (_, out_j), grads_j = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3, 4), has_aux=True)(
        *(jnp.asarray(a) for a in args[2:])
    )
    t = [torch.from_numpy(a) for a in args]
    for a in t[2:]:
        a.requires_grad_(True)
    out_t = cfconv(*t, 10.0, 10, cap)
    (out_t * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j), rtol=RTOL, atol=ATOL)
    for name, a, gj in zip(("x", "w1", "b1", "w2", "b2"), t[2:], grads_j):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(gj), rtol=RTOL, atol=ATOL,
                                   err_msg=f"grad {name}")
    if cap == 5:
        full = _cfconv_plain(*t[:2], *(a.detach() for a in t[2:]), 10.0, 10, 32)
        assert not torch.allclose(full, out_t.detach()), "the cap never took effect"


def test_plain_matches_pallas_interpret():
    args, _ = _problem(g=2, n=8, f=16, gauss=6, seed=2)
    out_p = fused_cfconv(*(jnp.asarray(a) for a in args), 10.0, 6, 4)
    out_t = _cfconv_plain(*(torch.from_numpy(a) for a in args), 10.0, 6, 4)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_p), rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_plain_path_and_launch_nothing():
    args, _ = _problem(g=2, n=8, f=16, gauss=6, seed=3)
    t = [torch.from_numpy(a) for a in args]
    reset_launches()
    out = cfconv(*t, 10.0, 6, None)
    assert sum(launches.values()) == 0
    torch.testing.assert_close(out, _cfconv_plain(*t, 10.0, 6, 8))
