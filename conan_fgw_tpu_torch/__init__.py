"""PyTorch/CUDA port of ``conan_fgw_tpu`` for NVIDIA Hopper cards.

Mirrors the JAX package's layout (``data/``, ``ops/``, ``ops/fgw/``,
``models/``, ``train/``). The Pallas TPU kernels of the JAX package are CUDA
C++ kernels here (``csrc/``, bound in ``ops/cuda/``); every kernel has a plain
PyTorch version beside it, used for tensors that live on the CPU.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from conan_fgw_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
