"""The plain reference against the program's plain CPU path at N <= 32 and
64: the same predictions, loss and gradients from the same weights and
molecules, for the regression and the classification configuration."""

import numpy as np
import pytest
import torch

from conftest import ROOT

from perfbench import core, traffic
from perfbench.drivers.conan_train import Session, gaps, reference_steps
from perfbench.references import conan_schnet as ref

BENCH = core.benchmark(ROOT)


def program_step(cfg, mols, N, weights):
    """The program's forward, loss and gradients on the CPU (its plain
    cfconv and FGW versions) for one batch padded to ``N``."""
    from conan_fgw_tpu_torch.data.packing import MoleculeRecord, pack_batch
    from conan_fgw_tpu_torch.train import loop, runner

    from perfbench.drivers.conan_train import yaml_text
    from conan_fgw_tpu_torch.train.config import parse_yaml, ExperimentConfig

    raw = parse_yaml(yaml_text(cfg["yaml"]))
    es = raw.pop("early_stopping")
    config = ExperimentConfig(**raw, es_min_delta=es["min_delta"], es_patience=es["patience"])
    model = runner.build_model(config, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    scale = ref.class_scale([m.y for m in mols]) if cfg["task"] == "classification" else None
    settings = runner.build_settings(config, runner.STAGE_BC, scale)
    records = [MoleculeRecord(z=m.z, pos=m.pos, x2d=m.x2d, bonds=m.bonds, bond_attr=m.bond_attr,
                              y=m.y) for m in mols]
    pb = pack_batch(records, max_atoms=N, batch_size=len(mols) + 1).to("cpu")  # one padding row
    pred, _ = model(pb, use_barycenter=True)
    loss = loop.task_loss(pred, pb, settings)
    loss.backward()
    return pred.detach()[: len(mols), 0], float(loss.detach()), {n: p.grad for n, p in model.named_parameters()}


def reference_step(cfg, mols, N, weights):
    w = {k: v.double().requires_grad_(True) for k, v in weights.items()}
    scale = ref.class_scale([m.y for m in mols])
    pred = ref.forward(w, mols, N, cfg, "cpu", torch.float64)
    loss = ref.loss_of(pred, mols, cfg, scale)
    grads = torch.autograd.grad(loss, list(w.values()), allow_unused=True)
    return pred.detach(), float(loss.detach()), dict(zip(w, grads))


@pytest.mark.parametrize("name, sizes, N", [
    ("schnet_esol", [[8, 20], [21, 32]], 32),
    ("schnet_esol", [[33, 50]], 64),
    ("schnet_cov2", [[10, 32]], 32),
])
def test_reference_against_the_programs_cpu_path(name, sizes, N):
    torch.set_num_threads(2)
    cfg = core.config(BENCH, name, ROOT)
    t = dict(core.traffic("esol"), molecules=4,
             sizes={"kind": "atom_ranges", "ranges": sizes, "size_seed": 1})
    if cfg["task"] == "classification":
        t["label"] = {"kind": "active_share", "share": 0.5}
    mols = traffic.generate(t, 2**32 + 3, 2)
    weights = ref.make_weights(cfg, 4, "cpu")
    p_pred, p_loss, p_grad = program_step(cfg, mols, N, weights)
    r_pred, r_loss, r_grad = reference_step(cfg, mols, N, weights)
    assert torch.allclose(p_pred.double(), r_pred, rtol=1e-4, atol=1e-4 * float(r_pred.abs().max()))
    assert p_loss == pytest.approx(r_loss, rel=1e-4)
    norm = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in r_grad.values() if g is not None])))
    for k, g in r_grad.items():
        if g is None:
            assert p_grad[k] is None
            continue
        assert float((p_grad[k].double() - g).abs().max()) <= 1e-4 * norm, k


def test_reference_training_is_adam_after_the_clip():
    # one leaf, one step: the clipped gradient and Adam's first update by hand
    cfg = core.config(BENCH, "schnet_esol", ROOT)
    t = dict(core.traffic("esol"), molecules=3,
             sizes={"kind": "atom_ranges", "ranges": [[8, 16]], "size_seed": 1})
    mols = traffic.generate(t, 5, 2)
    weights = ref.make_weights(cfg, 6, "cpu")
    out = ref.train(weights, [(32, mols)], cfg, device="cpu")
    _, _, grads = reference_step(cfg, mols, 32, weights)
    total = float(torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads.values() if g is not None])))
    factor = min(1.0, 1.0 / total)
    g = grads["head.bias"] * factor
    assert out["grad"]["head.bias"] == pytest.approx(float(g.abs().sum()), rel=1e-9)
    # Adam's first step moves each element by lr * g / (|g| + eps)
    step = cfg["yaml"]["learning_rate"] * float(g.abs().sum()) / (float(g.abs().sum()) + 1e-8)
    assert out["change"]["head.bias"] == pytest.approx(step, rel=1e-9)


def test_gaps_by_hand():
    leaves = {"a": 1.0, "b": 2.0, "c": 3.0, "d": 1e-9}
    ref_ = {"change": {"a": 1.0, "b": 1.0, "c": 1.0, "d": 1.0},
            "first_losses": [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
            "grads": {32: dict(leaves), 64: dict(leaves)}}
    prog = {"change": {"a": 1.0, "b": 0.5, "c": 1.0, "d": 0.0},
            "first_losses": [1.0, 1.5, 1.02, 1.0, 1.1, 1.2, 1.3],
            "grads": {32: dict(leaves), 64: {"a": 1.0, "b": 2.0, "c": 2.4, "d": 0.0}}}
    buckets = [32, 32, 32, 32, 64, 64, 64]
    g = gaps(prog, ref_, buckets)
    # bucket 32's gaps 0, 0.5, 0.02, 0: median 0.01; bucket 64's 0.1, 0.2, 0.3: median 0.2
    assert g["loss_med.32"] == pytest.approx(0.01) and g["loss_med.64"] == pytest.approx(0.2)
    assert g["loss_gap"] == pytest.approx(0.5)
    # leaves over their norm or the median leaf's (1.5): bucket 64 a 0, b 0, c 0.2, d 0
    assert g["grad_med.32"] == 0.0 and g["grad_med.64"] == pytest.approx(0.0, abs=1e-9)
    assert g["grad_gap"] == pytest.approx(0.2) and g["grad_med"] == pytest.approx(0.0, abs=1e-9)
    # d is left out of the change: its gradient is noise; a 0, b 0.5, c 0
    assert g["change_gap"] == pytest.approx(0.5) and g["change_med"] == pytest.approx(0.0)
    # a fault in every step of one bucket shows in its median, whatever the others read
    prog["first_losses"][4:] = [1.5, 1.5, 1.5]
    assert gaps(prog, ref_, buckets)["loss_med.64"] == pytest.approx(0.5)
    assert callable(reference_steps) and Session is not None
    assert np.isfinite(list(g.values())).all()
