"""Command-line tools of the port (counterparts of the JAX package's
``scripts/``), each run as ``python -m conan_fgw_tpu_torch.tools.<name>``."""
