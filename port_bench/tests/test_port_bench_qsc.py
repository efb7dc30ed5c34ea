"""The quantum classifier's cell at a small size on the CPU: the plain
reference against the program (the circuit alone, then three AdamW steps
from the same seeded weights), the reference loaded without the program,
and whole runs of the cell: sound, it comes out correct; with the timed
step frozen or half of each batch left out, not."""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from port_bench import checks, harness, inputs
from port_bench.reference import qsc as ref_qsc

from .conftest import REPO, TINY

CELL = "qsc_train.dp_8q"
CPU = torch.device("cpu")


def _cfg(extra=None):
    return harness.experiment_config(harness.config_file("dp_8q"), {**TINY, **(extra or {})})


@pytest.mark.parametrize("n", [2, 5, 8])
def test_the_statevector_circuit_matches_the_ports(n):
    from qdml_tpu_torch.quantum.circuits import run_circuit

    g = torch.Generator().manual_seed(n)
    a = torch.rand((7, n), generator=g) * 2 - 1
    w = torch.rand((3, n, 2), generator=g) * 2 * np.pi
    want = run_circuit(a, w, n, 3, backend="tensor", impl="tensor")
    torch.testing.assert_close(ref_qsc.circuit(a, w, n, 3), want, rtol=1e-5, atol=2e-6)


def test_three_steps_match_the_ports_trainer():
    """The reference's losses, first gradient and parameters after three
    AdamW steps against the port's per-step classifier trainer from the
    same seeded weights and rows."""
    from qdml_tpu_torch.data.datasets import GridData
    from qdml_tpu_torch.train import qsc

    cfg = _cfg()
    geom = harness.geometry(cfg)
    q, s, u, b = cfg.quantum, cfg.data.n_scenarios, cfg.data.n_users, cfg.train.batch_size
    rows = inputs.make_grid(geom, s, u, 32, 5, CPU)
    idx = [torch.as_tensor(i) for i in inputs.step_indices(3, s, u, b, 32, 5)]
    specs = ref_qsc.qsc_specs(q.n_qubits, q.n_layers, q.n_classes, cfg.image_hw)
    w0 = inputs.make_weights(specs, 5, "weights", CPU)
    w0["qlayer.weights"] = 2 * np.pi * torch.rand((q.n_layers, q.n_qubits, 2), generator=torch.Generator().manual_seed(5))
    ref = ref_qsc.follow(w0, rows, idx, 10.0, geom, q.n_qubits, q.n_layers, cfg.train.lr, cfg.train.weight_decay)
    data = GridData(cfg.data, rows, cached=False)
    model, opt = qsc.make_trainer(cfg, True, CPU, steps_per_epoch=100)
    model.load_state_dict(w0)
    params = dict(model.named_parameters())
    assert sorted(params) == sorted(w0)
    losses = []
    for i, ix in enumerate(idx):
        losses.append(float(qsc.classifier_train_step(model, opt, data.batch(ix, 10.0))["loss"]))
        if i == 0:
            for k in params:
                torch.testing.assert_close(opt.opt.state[params[k]]["exp_avg"] / 0.1, ref["grad1"][k],
                                           rtol=1e-4, atol=1e-7)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    rms = np.median([float(g.norm()) / g.numel() ** 0.5 for g in ref["grad1"].values()])
    for k in params:
        moving = ref["grad1"][k].abs() >= checks.STILL_LEAF * rms
        torch.testing.assert_close(params[k].detach()[moving], ref["after"][k][moving], rtol=1e-4, atol=1e-6)


def test_the_reference_loads_nothing_of_the_program():
    script = ("import sys\n"
              f"sys.path.insert(0, {str(REPO)!r})\n"
              "import port_bench.reference.qsc\n"
              "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('qdml_tpu_torch', 'qdml_tpu', 'jax', 'flax'))\n"
              "print(bad)\n")
    got = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr[-2000:]
    assert got.stdout.strip() == "[]"


def _run(seed: int = 5, log=lambda m: None):
    out, lines = harness.run_cell(CELL, seed, 0.3, False, time.perf_counter(), device="cpu",
                                  extra=TINY, log=log)
    assert len(lines) == len(out["checks"]) == 3
    return out


def test_a_sound_run_is_correct():
    logged = []
    out = _run(log=logged.append)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["device"]["platform"] == "cpu"
    assert set(out["metrics"]) == {"train_samples_per_s", "setup_s"}
    # set-up names the classifier's spans and replays the window's calls before it
    spans = next(m for m in logged if m.startswith("program spans in set-up: "))
    assert "qsc_make_trainer/qsc_init" in spans and "qsc_make_trainer/optimizer_init" in spans
    assert any(m.startswith("set-up's settling calls") for m in logged)


def _frozen(step):
    """A classifier step that computes its loss and leaves the parameters
    and the optimizer's state as they were."""
    def frozen(model, opt, batch, *args, **kwargs):
        with torch.no_grad():
            loss = step.__globals__["classifier_loss"](model, batch)
        return {"loss": loss.detach()}
    return frozen


def _half_batch(loss_fn):
    """The loss over each cell's first half of the batch only."""
    def loss(model, batch, *args, **kwargs):
        b = batch["yp_img"].shape[2]
        half = {k: v[:, :, : b // 2] if torch.is_tensor(v) and v.dim() >= 3 else v for k, v in batch.items()}
        return loss_fn(model, half, *args, **kwargs)
    return loss


@pytest.mark.parametrize("fault", ["step_unchanged", "half_batch"])
def test_a_broken_classifier_step_is_not_correct(fault, monkeypatch):
    from qdml_tpu_torch.train import qsc

    if fault == "step_unchanged":
        monkeypatch.setattr(qsc, "classifier_train_step", _frozen(qsc.classifier_train_step))
    else:
        monkeypatch.setattr(qsc, "classifier_loss", _half_batch(qsc.classifier_loss))
    assert _run()["correct"] is False


@pytest.mark.parametrize("kind", ["half_batch", "step_unchanged"])
def test_the_planted_faults_fail_as_controls(kind):
    """The control path's faults, the reference put in the program's place,
    read past a limit."""
    drv = harness.driver_for(CELL, 7, 0.3, CPU, extra=TINY, log=lambda m: None)
    drv.make_inputs()
    ok, judged = checks.judge(drv.control(kind), checks.load_limits(CELL))
    assert not ok, judged


@pytest.mark.cuda
def test_the_tf32_control_is_not_correct(card):
    """The reference in TF32, the precision below the float32 the
    configuration states, put in the program's place at the cell's own
    size on one card, reads past a limit."""
    man = harness.manifest()
    drv = harness.driver_for(CELL, 4000000007, float(man["run_seconds"]), card, man=man)
    drv.make_inputs()
    ok, judged = checks.judge(drv.control("tf32"), checks.load_limits(CELL))
    assert not ok, judged
