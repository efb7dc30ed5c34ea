"""A whole run of each cell on the CPU at a small size, the chip check
skipped: sound, it comes out correct; with the timed path broken
underneath (a step that leaves its state unchanged, half of each batch
left out and the mean taken over the rest, BatchNorm's running statistics
left as they were), ``correct`` comes out false."""

from __future__ import annotations

import time

import pytest
import torch

from port_bench import harness

from .conftest import TINY


def _run(cell: str, seed: int = 5):
    out, lines = harness.run_cell(cell, seed, 0.3, False, time.perf_counter(), device="cpu", extra=TINY,
                                  log=lambda m: None)
    assert len(lines) == len(out["checks"]) and list(out)[-1] == "checks"
    return out


@pytest.mark.parametrize("cell", ["hdce_train.p128_6q"])
def test_a_sound_run_is_correct(cell):
    out = _run(cell)
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["device"]["platform"] == "cpu"
    assert "setup_s" in out["metrics"]


def _no_update(train_step):
    """A step that computes its loss and leaves parameters and optimizer
    state as they were."""
    def step(model, opt, batch, *args, **kwargs):
        with torch.no_grad():
            out = train_step.__globals__["hdce_loss"](model, batch)
        loss = out[0] if isinstance(out, tuple) else out
        return {"loss": loss.detach()}
    return step


def _half_batch(loss_fn):
    """The loss over each cell's first half of the batch only."""
    def loss(model, batch, *args, **kwargs):
        b = batch["yp_img"].shape[2]
        half = {k: v[:, :, : b // 2] if torch.is_tensor(v) and v.dim() >= 3 else v for k, v in batch.items()}
        return loss_fn(model, half, *args, **kwargs)
    return loss


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_training_step_is_not_correct(fault, monkeypatch):
    from qdml_tpu_torch.train import hdce

    if fault == "state_unchanged":
        monkeypatch.setattr(hdce, "hdce_train_step", _no_update(hdce.hdce_train_step))
    else:
        monkeypatch.setattr(hdce, "hdce_loss", _half_batch(hdce.hdce_loss))
    assert _run("hdce_train.p128_6q")["correct"] is False


def test_batchnorm_statistics_left_unchanged_are_not_correct(monkeypatch):
    """The HDCE steps train as they should but never move BatchNorm's
    running statistics, which evaluation and serving read."""
    from qdml_tpu_torch.models import cnn

    monkeypatch.setattr(cnn.BatchNorm2d, "_update_running", lambda self, mean, var: None)
    out = _run("hdce_train.p128_6q")
    assert out["correct"] is False
    assert out["checks"]["stats_gap"]["value"] > out["checks"]["stats_gap"]["limit"]
    assert all(out["checks"][k]["value"] <= out["checks"][k]["limit"] for k in ("loss_gap", "grad_gap"))
