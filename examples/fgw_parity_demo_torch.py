"""FGW barycenter demo on the card: the PyTorch port of
``examples/fgw_parity_demo.py``.

The same steps as the JAX demo: load the captured solver input of the
reference notebook (K=10 conformer graphs, N=22 atoms, d=3, the
``cfm_log.pt`` that ``--fixture`` names) where it exists, else the JAX
demo's random graphs; solve the barycenter once
(``fgw_barycenter``, K3 over the molecule's K solves) and time ten solves;
then solve ``--batch`` copies at once (``fgw_barycenter_batch``, one K3
launch over all batch x K solves an outer iteration) and time that. On the
card the times are CUDA-event times after a warm-up call; on the CPU
(``--device cpu``) they are host times of the plain solver.

    python examples/fgw_parity_demo_torch.py [--fixture PATH] [--device cpu] [--batch 256]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from conan_fgw_tpu_torch.device import resolve_device  # noqa: E402
from conan_fgw_tpu_torch.ops.fgw.barycenter import (  # noqa: E402
    FGWConfig,
    fgw_barycenter,
    fgw_barycenter_batch,
)


def load_problem(fixture: str | None):
    """``(Ys (K, N, D), Cs (K, N, N), ps (K, N), lambdas (K,), captured Y or
    None)`` as float32 numpy arrays: the fixture's, or the JAX demo's
    random graphs (``default_rng(0)``, K=10, N=22, D=3)."""
    if fixture and os.path.exists(fixture):
        d = torch.load(fixture, map_location="cpu", weights_only=False)
        Ys = np.stack([y.numpy() for y in d["Ys"]]).astype(np.float32)
        Cs = np.stack([c.numpy() for c in d["Cs"]]).astype(np.float32)
        ps = np.stack([w.numpy() for w in d["ps"]]).astype(np.float32)
        lam = d["lambdas"].numpy().astype(np.float32)
        print(f"loaded fixture: K={Ys.shape[0]} graphs, N={Ys.shape[1]}, d={Ys.shape[2]}")
        return Ys, Cs, ps, lam, d["F_bary"].numpy()
    rng = np.random.default_rng(0)
    K, N, D = 10, 22, 3
    Ys = (rng.standard_normal((K, N, D)) * 0.5 + 1).astype(np.float32)
    a = (rng.random((K, N, N)) < 0.3).astype(np.float32)
    Cs = np.maximum(a, a.transpose(0, 2, 1))
    ps = np.full((K, N), 1 / N, np.float32)
    lam = np.full((K,), 1 / K, np.float32)
    print("fixture not found; using random graphs")
    return Ys, Cs, ps, lam, None


def timed_ms(fn, dev: torch.device, repeats: int = 1) -> tuple:
    """``(the last result, ms per call)`` of ``repeats`` calls after one
    warm-up call: CUDA events on the card, the host clock on the CPU."""
    fn()
    if dev.type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(repeats):
            out = fn()
        stop.record()
        torch.cuda.synchronize(dev)
        return out, start.elapsed_time(stop) / repeats
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = fn()
    return out, (time.perf_counter() - t0) / repeats * 1e3


def main(argv=None) -> dict:
    """Run the demo; return ``{"Y", "C", "Y_batch"}`` (CPU tensors) and the
    times ``single_ms``, ``batch_ms``, ``batch``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixture", default=None,
                    help="the reference notebook's captured solver input (cfm_log.pt)")
    ap.add_argument("--device", default="cuda", help="the card by default; cpu runs the plain solver")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--repeats", type=int, default=10, help="timed single solves")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    Ys, Cs, ps, lam, ref_Y = load_problem(args.fixture)
    N = Ys.shape[1]
    Ys_t, Cs_t, ps_t, lam_t = (torch.from_numpy(a).to(dev) for a in (Ys, Cs, ps, lam))
    p = torch.full((N,), 1.0 / N, device=dev)
    cfg = FGWConfig()
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

    (Y, C), single_ms = timed_ms(lambda: fgw_barycenter(Ys_t, Cs_t, ps_t, p, lam_t, cfg), dev,
                                 args.repeats)
    print(f"single barycenter solve: {single_ms:.3f} ms on {where} "
          f"(reference notebook: 5201 ms torch-CPU, 58 ms POT-CG)")
    if ref_Y is not None:
        print(f"max |Y - captured notebook Y|: {np.abs(Y.cpu().numpy() - ref_Y).max():.2e}")

    B = args.batch
    Yb = Ys_t.expand(B, *Ys_t.shape)
    Cb = Cs_t.expand(B, *Cs_t.shape)
    out, batch_ms = timed_ms(lambda: fgw_barycenter_batch(Yb, Cb, config=cfg)[0], dev)
    print(f"{B} simultaneous solves: {batch_ms:.3f} ms on {where} "
          f"({batch_ms / B:.4f} ms/molecule)")
    return {"Y": Y.cpu(), "C": C.cpu(), "Y_batch": out.cpu(), "single_ms": single_ms,
            "batch_ms": batch_ms, "batch": B}


if __name__ == "__main__":
    main()
