"""Layer: cfconv kernels (``ops/cuda/cfconv.py``, ``csrc/cfconv.cu``,
``csrc/cfconv_wgmma.cu``). K1 and K2's least time over the traced epochs
(the configuration's ``counts``: ``cfconv_least_s``, whichever route runs)
over the profiled device time of every kernel named ``cfconv_*``. Nothing
is read where the trace's K1/K2 executions differ from the launch
counters' (the profiler dropped records)."""

PREFIXES = ("cfconv_",)
# kernel name in the trace -> launch counter names (ops.cuda.launches)
# kernel name in the trace -> launch counter names it executes for (the
# routes up to 128 atoms; the routes above run other kernels)
EXECUTIONS = {"cfconv_fwd_kernel": "cfconv_fwd", "cfconv_bwd_kernel": "cfconv_bwd"}


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
    least = sum(run.counts.cfconv_least_s(b, run.cfg) for b in run.batch_counts) * t.epochs
    return 100.0 * least / device
