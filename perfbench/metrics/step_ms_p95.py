"""The 95th percentile, over all steps of the window, of the time between
consecutive steps' completions on the device (CUDA events recorded after
each ``StepGraphs.train`` call; nothing is synchronised per step)."""

import numpy as np


def read(run):
    return float(np.percentile(run.recorder.intervals_ms(), 95))
