"""On the card (``card`` marker; skipped without one): at a cell's own
size, the program's checked steps keep within the cell's limits, and the
control (the plain reference in float32 with TF32 products in the
program's place) and the fault of half of each batch left out, in every
bucket and in each bucket alone, do not.

    pytest perfbench/tests -m card
"""

import pytest
import torch

from conftest import ROOT

from perfbench import core
from perfbench.drivers import conan_train as drv

CELLS = ["schnet_esol.stage2", "schnet_cov2.stage2"]


@pytest.mark.card
@pytest.mark.parametrize("cell_name", CELLS)
def test_control_and_half_batch_fail_the_cell_limits(card, cell_name):
    bench = core.benchmark(ROOT)
    w = core.workload(bench, cell_name)
    cfg = core.config(bench, w["config"], ROOT)
    cell = core.cell(cell_name)
    s = drv.Session(cfg, core.traffic(w["traffic"]), 2**31 + 77, "cuda")
    s.warm()
    prog = s.checked_steps()
    s.free()
    ref = drv.reference_steps(s)
    buckets = drv.first_buckets(s)

    def fails(out):
        numbers = drv.gaps(out, ref, buckets)
        return any(numbers[k] > v for k, v in cell["limits"].items())

    assert not fails(prog), drv.gaps(prog, ref, buckets)
    assert fails(drv.reference_steps(s, dtype=torch.float32, tf32=True))
    assert fails(drv.reference_steps(s, half=tuple(buckets)))
    for N in dict.fromkeys(buckets):
        assert fails(drv.reference_steps(s, half=(N,))), N
