"""Host data layer: vocabularies, packing, synthetic molecules, batching."""
