"""Device resolution for the port's entry points.

Every entry point takes a ``device`` argument that defaults to ``"cuda"``.
With no card present that default raises: nothing falls back to the CPU
unless the caller asks for it. Resolving a device also pins float32 matrix
products to full precision (no TF32), as the JAX solver pins
``default_matmul_precision("highest")``.
"""

from __future__ import annotations

import torch


def pin_full_f32() -> None:
    """Disable TF32 in matmuls and convolutions (full-f32 parity contract)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


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
