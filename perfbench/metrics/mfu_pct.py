"""Layer: model step (``models/schnet.py``, ``gat.py``, ``heads.py``,
``ops/fgw/barycenter.py``, ``train/loop.py::train_step``). The forward and
backward operations that the window's batches need (the configuration's
``counts`` file: real atoms, capped edges, no recomputation) over the
window's time and 495 TFLOP/s, the TF32 dense peak: the fastest rate at
which the card runs the float32 products the configurations state."""

from perfbench.peaks import PEAK_TF32


def read(run):
    per_batch = [run.counts.step_flops(b, run.cfg) for b in run.batch_counts]
    flops = sum(per_batch[p] for p in run.recorder.pos)
    return 100.0 * flops / (run.window_s * PEAK_TF32)
