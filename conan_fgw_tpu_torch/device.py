"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``.
With no card present that default raises: nothing falls back to the CPU
unless the caller asks for it. Resolving a device also pins float32 matrix
products to full precision (no TF32), as the JAX solver pins
``default_matmul_precision("highest")``, and bf16 products to f32 sums, as
XLA accumulates them.

``compute_dtype`` maps a config's ``compute_dtype`` to the type the trunks
that take it (the SchNet and DimeNet backbones) cast to.
"""

from __future__ import annotations

import numpy as np
import torch


def pin_full_f32() -> None:
    """Disable TF32 in matmuls and convolutions (full-f32 parity contract),
    and the bf16 products' partial sums in bf16 (cuBLAS may take them by
    default): they sum in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


# the type names ml_dtypes registers with numpy, which ``jnp.dtype`` takes too
_ML_DTYPES = frozenset({
    "float4_e2m1fn", "float6_e2m3fn", "float6_e3m2fn", "float8_e3m4", "float8_e4m3",
    "float8_e4m3b11fnuz", "float8_e4m3fn", "float8_e4m3fnuz", "float8_e5m2",
    "float8_e5m2fnuz", "float8_e8m0fnu", "int2", "int4", "uint2", "uint4"})


def compute_dtype(name: str) -> torch.dtype | None:
    """The type a ``compute_dtype`` setting makes a trunk cast to: bf16 for
    ``"bfloat16"``, None for a float32 name, where the trunk computes in its
    parameters' type (float32, or float64 in a reference step). Another
    type that ``jnp.dtype`` takes raises ``NotImplementedError``; a name it
    rejects raises ``ValueError``."""
    if name == "bfloat16":
        return torch.bfloat16
    if name not in _ML_DTYPES:
        try:
            if np.dtype(name) == np.float32:
                return None
        except TypeError:
            raise ValueError(f"compute_dtype: {name!r} names no type") from None
    raise NotImplementedError(
        f"compute_dtype: {name} is not ported yet; float32 and bfloat16 are (ROADMAP.md §1, item 6)")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``; raise if it is CUDA and no
    card is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    pin_full_f32()
    return dev
