"""Data parallelism: ranks over ``torch.distributed`` (``mesh.py``) and the
gradient all-reduce and host-side gathers (``collectives.py``)."""
