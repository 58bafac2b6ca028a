"""Host batch iterator for the epoch loop.

Port of the part of ``conan_fgw_tpu/data/loader.py`` that ``fit`` reaches
with bucketing on and no prefetch: molecules grouped by atom-count bucket,
packed with the numpy packer. The prefetching loader and the native packer
come later.
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


def bucketed_batches(
    records: Sequence[MoleculeRecord],
    batch_size: int,
    buckets=DEFAULT_BUCKETS,
) -> Iterator[PackedBatch]:
    """Atom-count-bucketed batching in input order (the reference's loaders
    do not shuffle): group molecules by padded size, groups in first-seen
    order, then emit full-width batches (the last of each group padded via
    ``mol_mask``)."""
    groups: dict[int, list[MoleculeRecord]] = {}
    for r in records:
        groups.setdefault(bucket_for(r.num_atoms, buckets), []).append(r)
    for b, g in groups.items():
        for s in range(0, len(g), batch_size):
            yield pack_batch(g[s : s + batch_size], max_atoms=b, batch_size=batch_size)
