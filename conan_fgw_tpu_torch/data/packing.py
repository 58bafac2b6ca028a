"""Fixed-shape batch packing: molecules -> padded dense arrays.

Port of ``conan_fgw_tpu/data/packing.py`` without the JAX pytree
registration. A molecule with ``n`` atoms and ``K`` conformers becomes rows
of padded ``(K, N, ...)`` arrays, ``N`` an atom-count bucket boundary.
``PackedBatch`` holds numpy arrays on the host and torch tensors after
``.to(device)``.
"""

from __future__ import annotations

import dataclasses
from typing import ClassVar, Sequence

import numpy as np
import torch

from conan_fgw_tpu_torch.data.vocab import NUM_ATOM_FEATURES, NUM_BOND_FEATURES

DEFAULT_BUCKETS = (32, 64, 96, 128)


@dataclasses.dataclass
class MoleculeRecord:
    """One featurised molecule with K conformers (host-side, numpy).

    Attributes:
      z: ``(n,)`` atomic numbers.
      pos: ``(K, n, 3)`` conformer coordinates.
      x2d: ``(n, 9)`` categorical atom features (see ``vocab``).
      bonds: ``(E, 2)`` undirected bond list (each bond once).
      bond_attr: ``(E, 3)`` categorical bond features.
      y: scalar target.
      smiles: source string (bookkeeping only).
      mol_id: identifier for conformer-store lookups.
    """

    z: np.ndarray
    pos: np.ndarray
    x2d: np.ndarray
    bonds: np.ndarray
    bond_attr: np.ndarray
    y: float
    smiles: str = ""
    mol_id: str = ""

    @property
    def num_atoms(self) -> int:
        return int(self.z.shape[0])

    @property
    def num_conformers(self) -> int:
        return int(self.pos.shape[0])


@dataclasses.dataclass
class PackedBatch:
    """Padded batch of B molecules with K conformers each.

    ``bond_adj``/``bond_attr`` are per-molecule ``(N, N)`` structures shared
    across conformers.
    """

    z: np.ndarray  # (B, K, N) int32
    pos: np.ndarray  # (B, K, N, 3) float32
    atom_mask: np.ndarray  # (B, N) bool
    x2d: np.ndarray  # (B, N, 9) int32
    bond_adj: np.ndarray  # (B, N, N) bool
    bond_attr: np.ndarray  # (B, N, N, 3) float32
    y: np.ndarray  # (B,) float32
    mol_mask: np.ndarray  # (B,) bool — False for batch-padding rows
    # under data parallelism, the real molecules of the global batch whose
    # row block this batch holds (``parallel/mesh.py::rank_packer`` sets it
    # on the instance); None for a whole batch. Not a field: ``fields()``,
    # ``to()`` and the packers leave it out
    global_rows: ClassVar[int | None] = None

    @property
    def max_atoms(self) -> int:
        return int(self.z.shape[2])

    def to(self, device: str | torch.device) -> "PackedBatch":
        """Copy every field to ``device`` as a torch tensor."""
        return PackedBatch(**{
            f.name: torch.as_tensor(getattr(self, f.name), device=device)
            for f in dataclasses.fields(self)
        })


def batch_layout(batch_size: int, num_conformers: int, max_atoms: int) -> dict:
    """``{field: (shape, dtype)}`` of a ``PackedBatch`` of B molecules, K
    conformers and N atoms, in field order."""
    B, K, N = batch_size, num_conformers, max_atoms
    return {
        "z": ((B, K, N), np.int32),
        "pos": ((B, K, N, 3), np.float32),
        "atom_mask": ((B, N), np.bool_),
        "x2d": ((B, N, NUM_ATOM_FEATURES), np.int32),
        "bond_adj": ((B, N, N), np.bool_),
        "bond_attr": ((B, N, N, NUM_BOND_FEATURES), np.float32),
        "y": ((B,), np.float32),
        "mol_mask": ((B,), np.bool_),
    }


def bucket_for(num_atoms: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    for b in buckets:
        if num_atoms <= b:
            return b
    raise ValueError(f"molecule with {num_atoms} atoms exceeds largest bucket {buckets[-1]}")


def pack_batch(
    records: Sequence[MoleculeRecord],
    *,
    max_atoms: int | None = None,
    batch_size: int | None = None,
) -> PackedBatch:
    """Pack molecules into one padded batch.

    ``max_atoms`` defaults to the bucket covering the largest molecule.
    ``batch_size`` pads the molecule axis (masked via ``mol_mask``).
    """
    if not records:
        raise ValueError("empty batch")
    K = records[0].num_conformers
    n_max = max(r.num_atoms for r in records)
    N = max_atoms if max_atoms is not None else bucket_for(n_max)
    if n_max > N:
        raise ValueError(f"molecule with {n_max} atoms does not fit max_atoms={N}")
    B = batch_size if batch_size is not None else len(records)
    if len(records) > B:
        raise ValueError("more records than batch_size")

    z = np.zeros((B, K, N), np.int32)
    pos = np.zeros((B, K, N, 3), np.float32)
    atom_mask = np.zeros((B, N), bool)
    x2d = np.zeros((B, N, NUM_ATOM_FEATURES), np.int32)
    bond_adj = np.zeros((B, N, N), bool)
    bond_attr = np.zeros((B, N, N, NUM_BOND_FEATURES), np.float32)
    y = np.zeros((B,), np.float32)
    mol_mask = np.zeros((B,), bool)

    for b, r in enumerate(records):
        n = r.num_atoms
        if r.num_conformers != K:
            raise ValueError("all molecules in a batch must share K")
        z[b, :, :n] = r.z[None, :]
        pos[b, :, :n] = r.pos
        # park padding atoms far away from everything so no radius edge forms
        pos[b, :, n:] = 1e4 + 10.0 * np.arange(N - n, dtype=np.float32)[None, :, None]
        atom_mask[b, :n] = True
        x2d[b, :n] = r.x2d
        for (i, j), attr in zip(r.bonds, r.bond_attr):
            bond_adj[b, i, j] = bond_adj[b, j, i] = True
            bond_attr[b, i, j] = bond_attr[b, j, i] = attr
        y[b] = r.y
        mol_mask[b] = True

    return PackedBatch(
        z=z, pos=pos, atom_mask=atom_mask, x2d=x2d, bond_adj=bond_adj,
        bond_attr=bond_attr, y=y, mol_mask=mol_mask,
    )
