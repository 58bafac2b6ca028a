"""Learning-rate range finder, for configs that set ``use_lr_finder: true``
(port of ``conan_fgw_tpu/train/lr_finder.py``).

The reference delegates to Lightning's ``Tuner.lr_find``
(``train_val.py:196-198``): sweep the LR exponentially over a short run,
record the loss curve, and pick the steepest-descent point. The sweep trains
a copy of the model, so the model passed in keeps its weights. Each step
takes the task's loss (``settings.task``: MSE, or the scaled BCE). Under
data parallelism rank 0 sweeps on its device and every rank takes its
result.
"""

from __future__ import annotations

import copy

import numpy as np

from conan_fgw_tpu_torch.device import resolve_device
from conan_fgw_tpu_torch.parallel import collectives
from conan_fgw_tpu_torch.train import loop as loop_lib


def lr_find(model, settings, records, *, min_lr: float = 1e-6, max_lr: float = 1.0,
            num_steps: int = 60, device="cuda", mesh=None) -> dict:
    """Returns ``{"suggestion": lr, "lrs": [...], "losses": [...]}``. With a
    ``mesh`` rank 0 sweeps, on the mesh's device, and every rank returns
    rank 0's result."""
    if mesh is not None:
        found = (lr_find(model, settings, records, min_lr=min_lr, max_lr=max_lr,
                         num_steps=num_steps, device=mesh.device) if mesh.rank == 0 else None)
        return collectives.broadcast_object(found, mesh)
    dev = resolve_device(device)
    max_atoms = settings.max_atoms or loop_lib.dataset_max_atoms(records)
    lrs = np.exp(np.linspace(np.log(min_lr), np.log(max_lr), num_steps))

    def batch_stream():
        """Endless stream over the dataset, one device batch at a time."""
        while True:
            for pb in loop_lib.batch_iterator(records, settings.batch_size, max_atoms,
                                              prefetch=False):
                yield pb.to(dev)

    trial = copy.deepcopy(model).to(dev)
    optimizer = loop_lib.make_optimizer(trial, settings)
    stream = batch_stream()
    losses = []
    for lr in lrs:
        loop_lib.set_learning_rate(optimizer, float(lr))
        loss, _ = loop_lib.train_step(trial, optimizer, next(stream), settings)
        losses.append(float(loss))
        if not np.isfinite(losses[-1]) or (len(losses) > 5 and losses[-1] > 4 * min(losses)):
            lrs = lrs[: len(losses)]
            break

    # steepest negative slope of the smoothed loss curve
    lo = np.asarray(losses)
    if len(lo) >= 3:
        smooth = np.convolve(lo, np.ones(3) / 3, mode="valid")
        idx = int(np.argmin(np.gradient(smooth))) + 1
    else:
        idx = len(lo) - 1
    return {"suggestion": float(lrs[idx]), "lrs": list(map(float, lrs)), "losses": losses}
