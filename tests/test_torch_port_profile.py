"""``profile`` and ``utils/profiling.py`` on the CPU.

``python -m qdml_tpu_torch.cli profile --device=cpu`` traces 12 HDCE steps
after a warm-up step and writes ``summary.json`` and ``trace.json`` under
``--out``; on the CPU the device metrics (the card's memory and the
device-busy share) are not measured and stay None, never a CPU figure under
a device metric's name. ``StepTimer`` counts its timed steps and summarizes
their intervals as the JAX package's does.
"""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu_torch import cli  # noqa: E402
from qdml_tpu_torch.utils import profiling  # noqa: E402


def test_cli_profile_on_the_cpu_writes_its_summary(tmp_path, capsys):
    out = tmp_path / "trace"
    rc = cli.main([
        "profile", "--device=cpu", f"--out={out}", "--data.n_ant=16", "--data.n_sub=8", "--data.n_beam=4",
        "--model.features=4", "--train.batch_size=4",
    ])
    assert rc == 0
    summary = json.loads((out / "summary.json").read_text())
    assert set(summary) == {
        "backend", "card", "steps_traced", "rows_per_step", "samples_per_sec", "step_ms", "window_s",
        "device_busy_us", "device_busy_share", "memory", "trace_dir",
    }
    assert summary["backend"] == "cpu" and summary["steps_traced"] == 12 and summary["rows_per_step"] == 36
    assert summary["samples_per_sec"] > 0 and summary["step_ms"]["n"] == 10
    # the rate covers the timed steps alone, not the writing of the trace
    per_step_s = summary["rows_per_step"] / summary["samples_per_sec"]
    assert 0.5 < per_step_s / (summary["step_ms"]["mean_ms"] / 1e3) < 1.5
    assert summary["device_busy_share"] is None and summary["memory"] is None and summary["card"] is None
    assert (out / "trace.json").stat().st_size > 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary


def test_device_busy_is_the_union_of_device_activities():
    from torch.autograd import DeviceType
    from torch.autograd.profiler_util import FunctionEvent

    def evt(i, start, end, device=DeviceType.CUDA, annotation=False):
        return FunctionEvent(i, f"e{i}", 0, start, end, device_type=device, is_user_annotation=annotation)

    events = [
        evt(0, 0.0, 10.0),   # a kernel
        evt(1, 5.0, 12.0),   # one on another stream, overlapping it: counts from 10 to 12
        evt(2, 20.0, 25.0),  # a copy after an idle gap
        evt(3, 0.0, 30.0, annotation=True),  # Optimizer.step mirrored onto the device, over both
        evt(4, 40.0, 90.0, device=DeviceType.CPU),  # host work
    ]
    assert profiling.device_busy_us(events) == 17.0
    assert profiling.device_busy_us(events[3:]) == 0.0


def test_step_timer_counts_timed_steps():
    timer = profiling.StepTimer(warmup=2)
    assert timer.histogram() is None and timer.steps_per_sec() == 0.0
    for _ in range(7):
        timer.tick(torch.ones(3))
    hist = timer.histogram()
    assert hist["n"] == 5 and hist["p50_ms"] <= hist["p95_ms"] <= hist["max_ms"]
    assert timer.elapsed() == timer.elapsed()  # frozen after the first read
    assert timer.samples_per_sec(10) == pytest.approx(10 * 5 / timer.elapsed())
