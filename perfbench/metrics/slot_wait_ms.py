"""Layer: graphed step (``train/graphs.py::PinnedSlots.reclaim``). Mean
milliseconds a step the host waits for a pinned slot's copy to the card to
land, backpressure from the device: the program's ``graphs.slot_wait_s``
(its ``conan.slot_wait`` spans) outside the traced epochs, over the
replays; every pass of the run, the set-up's warm epochs too
(``perfbench/program_spans.py::untraced_ms``)."""

from perfbench import program_spans


def read(run):
    return program_spans.untraced_ms("conan.slot_wait", "graphs.slot_wait_s")
