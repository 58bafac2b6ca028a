"""Host batch iterators for the epoch loop.

Port of the part of ``conan_fgw_tpu/data/loader.py`` that the runner
reaches without prefetch: molecules grouped by atom-count bucket, packed
with the numpy packer (``bucketed_batches``, with ``bucket_order`` to align
per-record outputs), and plain sequential batches (``batches``, the LR
finder's). The prefetching loader and the native packer come later.
"""

from __future__ import annotations

from typing import Iterator, Sequence

from conan_fgw_tpu_torch.data.packing import (
    DEFAULT_BUCKETS,
    MoleculeRecord,
    PackedBatch,
    bucket_for,
    pack_batch,
)


def batches(records: Sequence[MoleculeRecord], batch_size: int,
            max_atoms: int) -> Iterator[PackedBatch]:
    """Batches in input order, every one padded to ``max_atoms`` atoms and
    ``batch_size`` molecules."""
    for s in range(0, len(records), batch_size):
        yield pack_batch(records[s : s + batch_size], max_atoms=max_atoms, batch_size=batch_size)


def _groups(records: Sequence[MoleculeRecord], buckets) -> dict[int, list[int]]:
    """Record indices by bucket: groups in first-seen order, input order
    within each."""
    groups: dict[int, list[int]] = {}
    for i, r in enumerate(records):
        groups.setdefault(bucket_for(r.num_atoms, buckets), []).append(i)
    return groups


def bucketed_batches(
    records: Sequence[MoleculeRecord],
    batch_size: int,
    buckets=DEFAULT_BUCKETS,
) -> Iterator[PackedBatch]:
    """Atom-count-bucketed batching in input order (the reference's loaders
    do not shuffle): group molecules by padded size, groups in first-seen
    order, then emit full-width batches (the last of each group padded via
    ``mol_mask``). A bucket's batches come one after another."""
    for b, idx in _groups(records, buckets).items():
        for s in range(0, len(idx), batch_size):
            chunk = [records[i] for i in idx[s : s + batch_size]]
            yield pack_batch(chunk, max_atoms=b, batch_size=batch_size)


def bucket_order(records: Sequence[MoleculeRecord], buckets=DEFAULT_BUCKETS) -> list[int]:
    """The record permutation ``bucketed_batches`` emits. Callers that align
    per-record outputs (predictions, embeddings) with their input records
    reindex through this."""
    return [i for idx in _groups(records, buckets).values() for i in idx]
