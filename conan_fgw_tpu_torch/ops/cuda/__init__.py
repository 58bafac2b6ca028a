"""Hand-written CUDA kernels (``csrc/``) and their PyTorch wrappers.

Each wrapper launches its kernel for CUDA tensors and runs the plain PyTorch
version beside it for CPU tensors. ``launches`` counts kernel launches by
name; a wrapper adds one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import collections

launches: collections.Counter = collections.Counter()


def reset_launches() -> None:
    """Set every launch count to zero."""
    launches.clear()
