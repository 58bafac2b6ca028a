"""Layer: train loop (``train/loop.py::_train_epoch``, ``step_batches``).
Device-idle milliseconds a traced epoch in the gaps that begin while the
innermost program span open on the main thread is ``conan.bucket_sync``,
``conan.epoch_start`` or ``conan.epoch_end``: a bucket's closing
synchronise, a pass's set-up (pinned slots, the prefetch thread's start)
and the thread's end (``perfbench/program_spans.py``)."""

from perfbench import program_spans


def read(run):
    idle = program_spans.idle_by_span(run)
    if idle is None:
        return None
    return sum(v for k, v in idle.items() if k in program_spans.EDGES)
