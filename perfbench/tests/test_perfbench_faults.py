"""A whole run, with the harness's look for a card skipped (on the CPU, at
a throw-away cell's small size), sees ``correct`` true on the program and
false with the timed path broken underneath: a step that leaves its state
unchanged, half of the batch left out with the mean over the rest (in
every batch, and in the batches of the second bucket alone), and the loss
altered where the step produces it. (A one-card cell has no exchange
between chips to leave out.)"""

import dataclasses

import pytest
import torch

from conftest import tiny_run


def test_sound_run_is_correct(tiny_root):
    result, lines = tiny_run(tiny_root, trace=0)
    assert result["correct"] is True, lines
    assert list(result)[-1] == "checks" and result["attempted"] >= 1 and result["failed"] == 0
    assert {"train_graphs_per_s", "step_ms_p95", "setup_s"} <= set(result["metrics"])


def unchanged_state(monkeypatch):
    monkeypatch.setattr(torch.optim.Adam, "step", lambda self, closure=None: None)


def halve(monkeypatch, bucket=None):
    """The loss over the first half of the rows of each batch (of the
    batches padded to ``bucket`` atoms alone, where given)."""
    from conan_fgw_tpu_torch.train import loop

    orig = loop.task_loss

    def halved(pred, batch, settings, rows=None):
        if bucket is not None and batch.max_atoms != bucket:
            return orig(pred, batch, settings, rows)
        mask = batch.mol_mask.clone()
        mask[mask.shape[0] // 2:] = False
        return orig(pred, dataclasses.replace(batch, mol_mask=mask), settings, rows)

    monkeypatch.setattr(loop, "task_loss", halved)


def half_batch(monkeypatch):
    halve(monkeypatch)


def half_batch_one_bucket(monkeypatch):
    halve(monkeypatch, bucket=64)


def loss_altered(monkeypatch):
    from conan_fgw_tpu_torch.train import loop

    orig = loop.task_loss
    monkeypatch.setattr(loop, "task_loss", lambda *a, **k: orig(*a, **k) * 1.01)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, half_batch_one_bucket,
                                   loss_altered])
def test_broken_step_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    result, lines = tiny_run(tiny_root, trace=0)
    assert result["correct"] is False, lines


def test_traced_run_reports_its_per_layer_metrics(tiny_root):
    result, _ = tiny_run(tiny_root, trace=1, seconds=2.0)
    assert result["correct"] is True and list(result)[-1] == "checks"
    # the host spans and the counts read on the CPU; the device's do not
    assert {"batch_wait_ms", "step_host_ms", "mfu_pct", "steps_seen"} <= set(result["metrics"])
    assert "cfconv_roofline_pct" not in result["metrics"]
    assert result["device"]["window_s"] > 0 and "breakdown" in result
