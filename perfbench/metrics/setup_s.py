"""Seconds from the process's start to the window's: imports and the
kernels' library (built on a checkout's first run), data, model and
weights, warm epochs with their captures, and the checked steps."""


def read(run):
    return run.setup_s
