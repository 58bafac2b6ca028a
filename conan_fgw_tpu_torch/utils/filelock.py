"""An exclusive lock between processes on a file (``fcntl.flock``).

The port builds its native libraries on first use (``ops/cuda/_build.py``,
``data/native.py``), and the ranks of a data-parallel run all reach that
first use at once: each build holds the lock of its build directory, so one
process compiles and the others, once they hold the lock, find the library
built. The kernel releases the lock when its holder exits, killed or not.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
from pathlib import Path


@contextlib.contextmanager
def locked(path: Path):
    """Hold an exclusive lock on ``path`` (created if missing) inside the
    block, waiting for any other holder."""
    os.makedirs(path.parent, exist_ok=True)
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)
