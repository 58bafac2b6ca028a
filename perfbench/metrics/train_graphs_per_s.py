"""Conformer graphs trained a second: the real molecules of every step of
the window times K, over the window's host time (from its start to the
synchronise after its last step)."""


def read(run):
    return sum(run.recorder.real) * run.K / run.window_s
