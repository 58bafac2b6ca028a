"""ctypes binding for the port's native batch packer (``native/packer.cpp``).

Port of the JAX package's ``data/native.py``, with its own source and
library. The library is built with ``g++ -O3 -shared -fPIC`` on first use
into ``conan_fgw_tpu_torch/_build/``, under a name that carries a hash of
the source and flags, so an edited source is rebuilt and an unchanged one
loaded as built; a build holds the directory's lock (``utils/filelock.py``),
so processes that start at once build it once. A build or load that fails
raises: nothing falls back to the numpy packer
(``data/packing.py::pack_batch``), which runs only where a caller asks for
it.

The foreign call releases the interpreter lock; the concatenation of the
records before it holds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

from conan_fgw_tpu_torch.data.packing import MoleculeRecord, PackedBatch, batch_layout, bucket_for
from conan_fgw_tpu_torch.data.vocab import NUM_ATOM_FEATURES, NUM_BOND_FEATURES
from conan_fgw_tpu_torch.utils.filelock import locked

PKG_DIR = Path(__file__).resolve().parents[1]
SOURCE = PKG_DIR / "native" / "packer.cpp"
BUILD_DIR = PKG_DIR / "_build"
FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build() -> Path:
    """Compile the packer if its library is missing; return the library's path."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    h.update(SOURCE.read_bytes())
    lib = BUILD_DIR / f"libpacker_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found: the native packer is built from {SOURCE} with g++")
    with locked(BUILD_DIR / ".lock"):
        if lib.exists():  # built by another process while this one waited
            return lib
        tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.{threading.get_ident()}"
        proc = subprocess.run([gxx, *FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed to build the native packer {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees a partial file
    return lib


def load_library() -> ctypes.CDLL:
    """Build on first use and load the packer's library (any thread)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.pack_batch.argtypes = (
                [ctypes.c_int32] * 6
                + [i32p, f32p, i32p, i32p, f32p, i32p, i32p, f32p]
                + [i32p, f32p, u8p, i32p, u8p, f32p, f32p, u8p]
            )
            lib.pack_batch.restype = None
            _lib = lib
        return _lib


def empty_batch(batch_size: int, num_conformers: int, max_atoms: int) -> PackedBatch:
    """Uninitialised host arrays of a batch's shape, for ``out=``."""
    return PackedBatch(**{name: np.empty(shape, dtype) for name, (shape, dtype)
                          in batch_layout(batch_size, num_conformers, max_atoms).items()})


def pack_batch_native(
    records: Sequence[MoleculeRecord],
    *,
    max_atoms: int | None = None,
    batch_size: int | None = None,
    out: PackedBatch | None = None,
) -> PackedBatch:
    """``packing.pack_batch`` in C++, byte for byte. With ``out`` (numpy
    arrays of the batch's shape and dtypes, e.g. views of pinned memory) it
    packs into those arrays and returns ``out``; every byte is written."""
    if not records:
        raise ValueError("empty batch")
    B_real = len(records)
    # this thread holds the interpreter lock until the foreign call: few
    # Python-level operations per record
    n_atoms = np.fromiter((r.z.shape[0] for r in records), np.int32, B_real)
    n_bonds = np.fromiter((r.bonds.shape[0] for r in records), np.int32, B_real)
    K = records[0].pos.shape[0]
    n_max = int(n_atoms.max())
    N = max_atoms if max_atoms is not None else bucket_for(n_max)
    if n_max > N:
        raise ValueError(f"molecule with {n_max} atoms does not fit max_atoms={N}")
    B = batch_size if batch_size is not None else B_real
    if B_real > B:
        raise ValueError("more records than batch_size")
    if any(r.pos.shape[0] != K for r in records):
        raise ValueError("all molecules in a batch must share K")

    # flattened in record order (pos per record as (K, n, 3))
    z_c = np.ascontiguousarray(np.concatenate([r.z for r in records]), np.int32)
    pos_c = np.ascontiguousarray(np.concatenate([r.pos.ravel() for r in records]), np.float32)
    x2d_c = np.ascontiguousarray(np.concatenate([r.x2d.ravel() for r in records]), np.int32)
    bonds_c = np.ascontiguousarray(np.concatenate([r.bonds.ravel() for r in records]), np.int32)
    battr_c = np.ascontiguousarray(np.concatenate([r.bond_attr.ravel() for r in records]),
                                   np.float32)
    y = np.fromiter((r.y for r in records), np.float32, B_real)
    # the C code trusts these sizes and indices
    n_sum, e_sum = int(n_atoms.sum()), int(n_bonds.sum())
    if (z_c.size, pos_c.size, x2d_c.size, bonds_c.size, battr_c.size) != (
            n_sum, n_sum * K * 3, n_sum * NUM_ATOM_FEATURES, 2 * e_sum, e_sum * NUM_BOND_FEATURES):
        raise ValueError("a record's arrays disagree with its atom and bond counts")
    if e_sum and (bonds_c.min() < 0 or np.any(
            bonds_c.reshape(-1, 2) >= np.repeat(n_atoms, n_bonds)[:, None])):
        raise ValueError("a bond index lies outside its molecule")

    if out is None:
        out = empty_batch(B, K, N)
    flat = []
    for name, (shape, dtype) in batch_layout(B, K, N).items():
        a = getattr(out, name)
        if a.shape != shape or a.dtype != dtype or not a.flags.c_contiguous:
            raise ValueError(f"out.{name} is {a.dtype}{a.shape}; the batch needs a C-contiguous"
                             f" {np.dtype(dtype)}{shape}")
        flat.append((a.view(np.uint8) if a.dtype == np.bool_ else a).reshape(-1))
    load_library().pack_batch(
        B_real, B, K, N, NUM_ATOM_FEATURES, NUM_BOND_FEATURES,
        z_c, pos_c, x2d_c, bonds_c, battr_c, n_atoms, n_bonds, y, *flat,
    )
    return out
