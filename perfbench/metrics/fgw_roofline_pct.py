"""Layer: FGW kernel (``ops/cuda/fgw.py``, ``csrc/fgw.cu``,
``csrc/fgw_team.cu``). K3's least time over the traced epochs (the
configuration's ``counts``: ``fgw_least_s``, each solve at its real atom
count, the Sinkhorn sweeps at the budget) over the profiled device time of
every kernel named ``fgw_couplings*``. Nothing is read where the trace's
K3 executions differ from the launch counters'."""

PREFIXES = ("fgw_couplings",)
# kernel name in the trace -> launch counter names it executes for (the
# routes up to 128 atoms; the routes above run other kernels)
EXECUTIONS = {"fgw_couplings_kernel": "fgw_couplings"}


def launched(t, counter: str) -> int:
    return sum(v for k, v in t.launches.items()
               if k.startswith(counter) and not k.endswith(("_large", "_cluster", "_stream"))
               and "_large_" not in k)


def read(run):
    t = run.trace
    if t is None or any(t.count(k) != launched(t, v) for k, v in EXECUTIONS.items()):
        return None
    device = t.seconds(PREFIXES)
    if device <= 0:
        return None
    least = sum(run.counts.fgw_least_s(b, run.cfg) for b in run.batch_counts) * t.epochs
    return 100.0 * least / device
