"""Layer: FGW kernel (``ops/cuda/fgw.py``, ``csrc/fgw.cu``). The Sinkhorn
iterations K3 ran in the traced epochs (the program's
``fgw.sinkhorn_iters``, added once an epoch) over the budget: the traced
steps times ``batch_size`` times K solves, each ``outer_iters`` times
``pgd_iters`` times ``sinkhorn_iters`` (``perfbench/program_spans.py``)."""

from perfbench import program_spans


def read(run):
    got = program_spans.spans(run)
    if got is None:
        return None
    iters = program_spans.total(run, "fgw.sinkhorn_iters")
    fgw = run.cfg["fgw"]
    budget = (got[1] * run.cfg["yaml"]["batch_size"] * run.K * fgw["outer_iters"]
              * fgw["pgd_iters"] * fgw["sinkhorn_iters"])
    return 100.0 * iters / budget if iters else None
