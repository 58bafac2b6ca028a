"""Layer: host pipeline (``data/loader.py``, ``data/native.py`` +
``native/packer.cpp``). Mean milliseconds the prefetch thread takes to pack
a batch: the program's counters ``pipeline.pack_s`` over
``pipeline.packs``, over every pass of the run (no profiler records on that
thread, so its packs are not told apart by epoch)."""

from perfbench import program_spans


def read(run):
    prog = program_spans.program()
    if prog is None or not prog.counters["pipeline.packs"]:
        return None
    return 1e3 * prog.counters["pipeline.pack_s"] / prog.counters["pipeline.packs"]
