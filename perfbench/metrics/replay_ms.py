"""Layer: graphed step (``train/graphs.py::StepGraphs._run``). Mean host
milliseconds a step of the graph's replay, its launch counts and the output
clones: the program's ``graphs.replay_s`` (its ``conan.replay`` spans)
outside the traced epochs, where the profiler slows a replay several
times, over the replays; every pass of the run, the set-up's warm epochs
too (``perfbench/program_spans.py::untraced_ms``)."""

from perfbench import program_spans


def read(run):
    return program_spans.untraced_ms("conan.replay", "graphs.replay_s")
