"""Layer: graphed step (``train/graphs.py::StepGraphs``). Mean host
milliseconds inside ``StepGraphs.train``: the staging copy, the replay and
the output clones, over the window's steps."""


def read(run):
    host = run.recorder.host
    return 1e3 * sum(host) / len(host) if host else None
