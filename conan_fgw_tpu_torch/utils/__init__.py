"""Run logging, multi-run summaries and profiling helpers."""
