"""Layer: host pipeline (``data/loader.py::Prefetcher``). Mean milliseconds
a graphed step the main thread waits on the prefetch thread's queue: the
program's ``pipeline.queue_wait_s`` (its ``conan.queue_wait`` spans)
outside the traced epochs, over the replays; every pass of the run, the
set-up's warm epochs too (``perfbench/program_spans.py::untraced_ms``)."""

from perfbench import program_spans


def read(run):
    return program_spans.untraced_ms("conan.queue_wait", "pipeline.queue_wait_s")
