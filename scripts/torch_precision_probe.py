#!/usr/bin/env python3
"""Where a training step's distance from float64 comes from, on one NVIDIA
card: ``chip_smoke.py`` phase 11's attention head at N=64 (a sol250 batch of
32, stage 1), the family whose saturated softmax over 160 conformers turns
the least rounding into its gradient norm; or, with ``--deep``, phase 13's
stage-2 step of ``config/schnet/sol1k_5_bc_deep.yaml``'s model (the
barycenter at 15 outer x 10 PGD x 10 Sinkhorn iterations, eps 0.05) on
phase 4's synthetic batch of 24 molecules at N=32.

    PYTHONPATH=. python3 scripts/torch_precision_probe.py [--family attention] [--n 64] [--cpu]
    PYTHONPATH=. python3 scripts/torch_precision_probe.py --deep --cpu

Prints the loss's and the global gradient norm's signed relative distance
from the same step in float64 on the CPU, for the step computed
1. on the card through K1/K2 (as ``chip_smoke.py`` runs it);
2. on the card with the cfconv in plain PyTorch (``_cfconv_plain``): what
   the card's other operations add;
3. on the card in K1/K2's arithmetic (``cfconv_edges`` with ``split_mm``);
4. on the CPU in plain f32, and in K1/K2's arithmetic with the products
   split as the kernels do (3xTF32) and as they might (a three-term and a
   four-term bf16 split);
5. on the CPU in plain f32 with every weight moved by 1e-7 relative noise
   (``--noise`` draws), each from its own float64 step: how far f32
   rounding alone moves this step;
and each beside phase 4's gate (1e-3 of the plain f32 CPU step). With
``--cpu`` only 4 and 5 run, and no card is needed; otherwise it needs one.
With ``--deep`` it also prints the gate that ``chip_smoke.py`` holds the
deep step to: the larger of phase 4's gate and 4 times the largest
distance of a plain f32 CPU step from its float64 step (part 4's plain
step and part 5's draws), the margin the attention head's gate was derived with.
Prints no result line.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


@contextlib.contextmanager
def plain_cfconv():
    """Within it, the SchNet blocks' cfconv is ``_cfconv_plain`` on any device."""
    from conan_fgw_tpu_torch.models import schnet
    from conan_fgw_tpu_torch.ops.cuda.cfconv import _cfconv_plain

    original = schnet.cfconv
    schnet.cfconv = lambda pos, mask, x, w1, b1, w2, b2, cutoff=10.0, num_gaussians=50, \
        max_neighbors=32, cap_mode="index": _cfconv_plain(
            pos, mask, x, w1, b1, w2, b2, cutoff, num_gaussians,
            x.shape[-2] if max_neighbors is None else max_neighbors, cap_mode)
    try:
        yield
    finally:
        schnet.cfconv = original


def card_step(model, pb, context, bary=False):
    """Loss and gradient norms of one step of ``model`` on the card (stage 2
    with ``bary``)."""
    import torch

    from conan_fgw_tpu_torch.train.loop import masked_mse

    m = copy.deepcopy(model).to("cuda")
    batch = pb.to("cuda")
    with context:
        loss = masked_mse(m(batch, use_barycenter=bary)[0], batch)
        loss.backward()
    torch.cuda.synchronize()
    return float(loss.detach()), {k: float(p.grad.norm()) for k, p in m.named_parameters()
                                  if p.grad is not None}


def four_term_bf16(a, b):
    """``a @ b`` with a four-term bf16 split: the kernels' former three
    terms and ``a_lo b_lo``."""
    from conan_fgw_tpu_torch.ops.cuda.cfconv import round_bits

    ah, bh = round_bits(a, 16), round_bits(b, 16)
    al, bl = round_bits(a - ah, 16), round_bits(b - bh, 16)
    return al @ bl + al @ bh + ah @ bl + ah @ bh


@contextlib.contextmanager
def split(mm):
    """Within it, ``kernel_arithmetic`` splits the products with ``mm``."""
    from conan_fgw_tpu_torch.ops.cuda import cfconv

    original = cfconv.split_mm
    cfconv.split_mm = mm
    try:
        yield
    finally:
        cfconv.split_mm = original


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--family", default="attention")
    parser.add_argument("--n", type=int, default=64, choices=(32, 64))
    parser.add_argument("--noise", type=int, default=4, help="noise draws of part 5")
    parser.add_argument("--cpu", action="store_true", help="the CPU parts only")
    parser.add_argument("--deep", action="store_true",
                        help="the deep-budget stage-2 step of phase 13 instead of a family")
    args = parser.parse_args(argv)
    import functools

    import torch

    if not args.cpu and not torch.cuda.is_available():
        print("torch_precision_probe: no CUDA device is available (--cpu runs the CPU parts)",
              file=sys.stderr)
        return 2
    from conan_fgw_tpu_torch.device import pin_full_f32
    from conan_fgw_tpu_torch.ops.cuda import _build, cfconv
    from conan_fgw_tpu_torch.train.config import load_config
    from conan_fgw_tpu_torch.data.packing import pack_batch
    from conan_fgw_tpu_torch.data.synthetic import random_dataset
    from conan_fgw_tpu_torch.train.runner import build_aux_model, build_model, load_datasets

    pin_full_f32()
    where = "the CPU" if args.cpu else cs.card_line()
    if not args.cpu:
        _build.load_library()
    if args.deep:
        tag, bary = "deep", True
        model = build_model(load_config(cs.DEEP_STAGES[1][1]), seed=cs.SEED, device="cpu")
        recs = random_dataset(cs.SEED + 3, cs.B, num_conformers=cs.K, heavy_range=(8, 10),
                              device="cpu")
        pb = pack_batch(recs, max_atoms=32, batch_size=cs.B)  # phase_parity's batch
    else:
        tag, bary = f"{args.family} N{args.n}", False
        records = load_datasets(load_config(cs.ESAN_CONFIGS[0]), "data")["train"].records()
        _, pb = cs.sol250_batch(records, args.n, cs.FAMILY_BATCH)
        model = build_aux_model(args.family, 128, seed=cs.SEED, device="cpu")
    l64, n64 = cs._plain_step(model, pb, bary, torch.float64)
    g64 = cs._norm(n64)
    _, n_plain = cs._plain_step(model, pb, bary)
    g_plain = cs._norm(n_plain)
    steps = {} if args.cpu else {
        "card, K1/K2": card_step(model, pb, contextlib.nullcontext(), bary),
        "card, plain cfconv": card_step(model, pb, plain_cfconv(), bary),
        "card, K1/K2's arithmetic": card_step(model, pb, cs.kernel_arithmetic(), bary),
    }
    steps["CPU, plain f32"] = cs._plain_step(model, pb, bary)
    for name, mm in (("3xTF32 (K1/K2)", cfconv.split_mm),
                     ("3-term bf16", functools.partial(cfconv.split_mm, drop=16)),
                     ("4-term bf16", four_term_bf16)):
        with split(mm):
            steps[f"CPU, {name}"] = cs._plain_step(model, pb, bary, kernel=True)
    print(f"[precision {tag}] float64 CPU step: loss {l64!r}, gradient norm {g64!r}; on {where}")
    plain_f32 = []  # distances of plain f32 CPU steps from their float64 steps
    for name, (loss, norms) in steps.items():
        g = cs._norm(norms)
        if name == "CPU, plain f32":
            plain_f32 += [abs(loss - l64) / abs(l64), abs(g - g64) / g64]
        print(f"[precision {tag}] {name:26s} from float64: loss"
              f" {(loss - l64) / abs(l64):+.3e}, gradient norm {(g - g64) / g64:+.3e}; from the plain"
              f" f32 CPU step: gradient norm {abs(g - g_plain) / g_plain:.3e} (gate {cs.STEP_RTOL})")
    gen = torch.Generator().manual_seed(cs.SEED)
    for draw in range(args.noise):
        noisy = copy.deepcopy(model)
        with torch.no_grad():
            for p in noisy.parameters():
                p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen))
        loss, norms = cs._plain_step(noisy, pb, bary)
        loss64, norms64 = cs._plain_step(noisy, pb, bary, torch.float64)
        g, g_own = cs._norm(norms), cs._norm(norms64)
        plain_f32 += [abs(loss - loss64) / abs(loss64), abs(g - g_own) / g_own]
        print(f"[precision {tag}] CPU, plain f32, weights moved by 1e-7 noise"
              f" (draw {draw}): from its own float64 step: loss {(loss - loss64) / abs(loss64):+.3e},"
              f" gradient norm {(g - g_own) / g_own:+.3e}")
    if args.deep:
        print(f"[precision {tag}] largest plain f32 distance from float64 {max(plain_f32):.3e};"
              f" gate max({cs.STEP_RTOL}, 4 x that) = {max(cs.STEP_RTOL, 4 * max(plain_f32)):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
