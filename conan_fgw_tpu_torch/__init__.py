"""PyTorch/CUDA port of ``conan_fgw_tpu`` for NVIDIA Hopper cards.

Mirrors the JAX package's layout (``data/``, ``ops/``, ``ops/fgw/``,
``models/``, ``train/``). The Pallas TPU kernels of the JAX package are CUDA
C++ kernels here (``csrc/``, bound in ``ops/cuda/``); every kernel has a plain
PyTorch version beside it, used for tensors that live on the CPU.

Entry points run on the card unless the caller passes ``device="cpu"``
(``device.py::resolve_device``). Importing the package imports nothing else,
so that a worker process that needs only the host data layer (the conformer
pool of ``data/conformers.py::generate_store``) starts without torch.
"""
