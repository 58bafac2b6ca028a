"""Layer: device. The share of the traced epochs (three whole epochs in the
window's middle) in which the card runs no kernel, copy or memset."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
