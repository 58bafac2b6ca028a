"""Layer: host pipeline (``data/loader.py``, ``data/native.py``,
``native/packer.cpp``, ``train/graphs.py::PinnedSlots``,
``train/loop.py::step_batches``). Mean host milliseconds from the return of
one ``StepGraphs.train`` call to the next, epoch gaps included (the
traced epoch's edges left out), over the window's steps."""


def read(run):
    wait = run.recorder.wait
    return 1e3 * sum(wait) / len(wait) if wait else None
