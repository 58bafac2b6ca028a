"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``.
With no card present that default raises: nothing falls back to the CPU
unless the caller asks for it. Resolving a device also pins float32 matrix
products to full precision (no TF32), as the JAX solver pins
``default_matmul_precision("highest")``, and bf16 products to f32 sums, as
XLA accumulates them.

``compute_dtype`` maps a config's ``compute_dtype`` to the type the trunks
that take it (the SchNet and DimeNet backbones) cast to, and raises where
the JAX trunk raises.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def pin_full_f32() -> None:
    """Disable TF32 in matmuls and convolutions (full-f32 parity contract),
    and the bf16 products' partial sums in bf16 (cuBLAS may take them by
    default): they sum in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class TypePromotionError(ValueError):
    """A compute type that has no promotion path with the trunk's float32
    parameters (JAX's error of the same name)."""


# the type names ml_dtypes registers with numpy, which ``jnp.dtype`` takes
# too: JAX refuses the float6 ones outright (a TypeError), and the trunk's
# first product of float32 with the others has no promotion path
_ML_NO_ARRAYS = frozenset({"float6_e2m3fn", "float6_e3m2fn"})
_ML_NO_PROMOTION = frozenset({
    "float4_e2m1fn", "float8_e3m4", "float8_e4m3", "float8_e4m3b11fnuz", "float8_e4m3fn",
    "float8_e4m3fnuz", "float8_e5m2", "float8_e5m2fnuz", "float8_e8m0fnu"})
_ML_INTEGERS = frozenset({"int2", "int4", "uint2", "uint4"})


def compute_dtype(name: str) -> torch.dtype | None:
    """The type a ``compute_dtype`` setting makes a trunk cast to, as the JAX
    trunk treats the name: bf16 for ``"bfloat16"``, f16 for a float16 name,
    None for a float32 name, where the trunk computes in its parameters'
    type (float32, or float64 in a reference step). A float64 name is None
    too, with a warning: JAX without x64 truncates it to float32. The float8
    and float4 names raise ``TypePromotionError`` (a ``ValueError``), the
    float6 ones ``TypeError``, integer and bool names ``ValueError("Dtype
    must be inexact")``, and a name ``jnp.dtype`` rejects ``ValueError``.
    Complex names, which the JAX trunk runs, raise ``NotImplementedError``
    (ROADMAP.md, "Left out on purpose")."""
    if name == "bfloat16":
        return torch.bfloat16
    if name in _ML_NO_ARRAYS:
        raise TypeError(f"compute_dtype: JAX only supports number, bool, and string dtypes,"
                        f" got {name}")
    if name in _ML_NO_PROMOTION:
        raise TypePromotionError(f"compute_dtype: float32 and {name} have no implicit"
                                 f" promotion path")
    if name in _ML_INTEGERS:
        raise ValueError(f"Dtype must be inexact: {name}")
    try:
        dt = np.dtype(name)
    except TypeError:
        raise ValueError(f"compute_dtype: {name!r} names no type") from None
    if dt == np.float32:
        return None
    if dt == np.float16:
        return torch.float16
    if dt == np.float64:
        warnings.warn(f"compute_dtype: {name} computes in float32, as the JAX trunk truncates"
                      f" float64 without x64", stacklevel=2)
        return None
    if dt.kind in "biu":
        raise ValueError(f"Dtype must be inexact: {dt}")
    raise NotImplementedError(
        f"compute_dtype: {name} is left out of the port (ROADMAP.md, \"Left out on purpose\")")


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
