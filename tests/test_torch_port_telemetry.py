"""The port's run manifests, sinks, spans and counters against the JAX package, on the CPU.

- ``run_manifest``: the JSON round trip, JAX's fields with a ``torch`` block
  where JAX's ``jax`` is null, and ``config_hash`` equal to JAX's for every
  shipped preset the two packages share (their ``asdict`` dumps equal);
- ``MetricsLogger(manifest=...)`` opens its stream with the manifest, as
  JAX's does; a non-primary rank's sink writes nothing;
- spans (nesting, the sink, ``profiler_trace``; JAX's fields and the port's
  own ``t0_ns``/``t1_ns`` on ``perf_counter_ns``'s clock; no record built
  without an active sink; the trainer set-up's spans), ``StepClock``'s
  ``counters`` records;
- JAX's zero-transfer pin (``tests/test_train.py:433-467``): a K-step epoch
  at ``probe_every=0`` makes no host transfer, at ``probe_every=1`` one a
  steady dispatch;
- the CLI: a run's metrics stream opens with its manifest, a divergence
  exits 4 with ``DIVERGED:``, and ``report`` runs before any config or
  device.
"""

import dataclasses
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.telemetry import span as jspan  # noqa: E402
from qdml_tpu.telemetry import config_hash as jconfig_hash  # noqa: E402
from qdml_tpu.telemetry import run_manifest as jrun_manifest  # noqa: E402
from qdml_tpu.utils.metrics import MetricsLogger as JMetricsLogger  # noqa: E402
from qdml_tpu_torch import cli  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.telemetry import (  # noqa: E402
    StepClock,
    Telemetry,
    config_hash,
    device_memory_snapshot,
    get_sink,
    profiler_trace,
    run_manifest,
    set_sink,
    span,
)
from qdml_tpu_torch.telemetry import core as tcore  # noqa: E402
from qdml_tpu_torch.telemetry import spans as tspans  # noqa: E402
from qdml_tpu_torch.train import dce as tdce  # noqa: E402
from qdml_tpu_torch.train import hdce as thdce  # noqa: E402
from qdml_tpu_torch.utils.metrics import MetricsLogger  # noqa: E402

DATA = dict(n_ant=16, n_sub=8, n_beam=4, data_len=40)


def _read(path):
    with open(path) as fh:
        return [json.loads(ln) for ln in fh if ln.strip()]


class _Spans:
    """A sink that keeps its records in a list."""

    active = True

    def __init__(self):
        self.records = []

    def write_raw(self, rec):
        self.records.append(rec)


def _tcfg(**over):
    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(**DATA),
        model=tconfig.ModelConfig(features=8),
        train=tconfig.TrainConfig(batch_size=8, n_epochs=1, print_freq=1000),
    )
    return tconfig.from_args([f"--{k}={v}" for k, v in over.items()], base=cfg)


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------


def test_manifest_round_trips_with_jaxs_fields_and_a_torch_block():
    cfg = _tcfg()
    man = run_manifest(cfg, argv=["train-hdce", "--x=1"])
    assert json.dumps(json.loads(json.dumps(man))) == json.dumps(man)
    jman = jrun_manifest(jconfig.ExperimentConfig(), argv=["x"], include_jax=False)
    assert set(jman) <= set(man) and set(man) - set(jman) == {"torch"}
    assert man["kind"] == "manifest" and man["jax"] is None and man["argv"] == ["train-hdce", "--x=1"]
    assert man["torch"]["version"] == torch.__version__ and man["torch"]["backend"] == "cpu"
    assert man["torch"]["process_index"] == 0 and man["torch"]["process_count"] == 1
    assert man["config_hash"] == config_hash(cfg) and man["config"] == dataclasses.asdict(cfg)
    assert man["git"] is None or len(man["git"]["sha"]) == 40
    assert man["knobs"].keys() == jman["knobs"].keys() and man["seeds"] == {"data": cfg.data.seed, "train": cfg.train.seed}
    assert run_manifest(include_torch=False)["torch"] is None


@pytest.mark.parametrize("name", sorted(jconfig.presets()))
def test_config_hash_equals_jaxs_for_every_shipped_preset(name):
    tcfg = tconfig.preset(name)
    jcfg = jconfig.presets()[name]
    # the packages' only differing default: each writes results to its own directory
    tcfg = dataclasses.replace(tcfg, eval=dataclasses.replace(tcfg.eval, results_dir=jcfg.eval.results_dir))
    assert json.dumps(dataclasses.asdict(tcfg), sort_keys=True, default=str) == json.dumps(
        dataclasses.asdict(jcfg), sort_keys=True, default=str)
    assert config_hash(tcfg) == jconfig_hash(jcfg)


def test_train_config_telemetry_fields_take_jaxs_defaults_and_flags():
    t, j = tconfig.TrainConfig(), jconfig.TrainConfig()
    for f in ("probe_every", "watchdog", "watchdog_grad_norm_max", "checkify"):
        assert getattr(t, f) == getattr(j, f), f
    cfg = tconfig.from_args(["--train.probe_every=0", "--train.watchdog=false",
                             "--train.watchdog_grad_norm_max=5", "--train.checkify=true"])
    assert (cfg.train.probe_every, cfg.train.watchdog, cfg.train.watchdog_grad_norm_max, cfg.train.checkify) == (
        0, False, 5.0, True)


def test_metrics_logger_opens_with_the_manifest_as_jaxs_does(tmp_path):
    man = run_manifest(_tcfg(), argv=["a"])
    log = MetricsLogger(str(tmp_path / "p.jsonl"), echo=False, manifest=man)
    log.log(step=1, loss=0.5)
    log.close()
    jlog = JMetricsLogger(str(tmp_path / "j.jsonl"), echo=False, manifest=jrun_manifest(argv=["a"], include_jax=False))
    jlog.log(step=1, loss=0.5)
    jlog.close()
    got, want = _read(tmp_path / "p.jsonl"), _read(tmp_path / "j.jsonl")
    assert [r.get("kind") for r in got] == [r.get("kind") for r in want] == ["manifest", None]
    assert got[0] == json.loads(json.dumps(man)) and got[1]["loss"] == want[1]["loss"] == 0.5


def test_a_non_primary_rank_writes_nothing(tmp_path, monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    assert tcore.is_primary() is False
    tele = Telemetry(str(tmp_path / "t.jsonl"), manifest={"kind": "manifest"})
    log = MetricsLogger(str(tmp_path / "m.jsonl"), echo=False, manifest={"kind": "manifest"})
    assert not tele.active and not log.active
    tele.emit("span", name="x")
    log.log(step=1, loss=1.0)
    assert not (tmp_path / "t.jsonl").exists() and not (tmp_path / "m.jsonl").exists()
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)
    assert tcore.is_primary() is True


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------


def test_spans_nest_into_the_sink_and_profiler_trace_writes_its_trace(tmp_path):
    tele = Telemetry(str(tmp_path / "s.jsonl"))
    set_sink(tele)
    try:
        with span("outer", epoch=3):
            with span("inner"):
                pass
        with profiler_trace(str(tmp_path / "trace")) as prof:
            with span("traced"):
                torch.randn(8, 8) @ torch.randn(8, 8)
    finally:
        set_sink(None)
        tele.close()
    assert get_sink() is None
    recs = _read(tmp_path / "s.jsonl")
    by = {r["name"]: r for r in recs}
    assert [r["name"] for r in recs][:2] == ["inner", "outer"]  # children close first
    assert by["inner"]["path"] == "outer/inner" and by["inner"]["depth"] == 1 and by["outer"]["epoch"] == 3
    assert by["torch_profiler_trace"]["logdir"] == str(tmp_path / "trace") and by["traced"]["dur_s"] >= 0
    assert (tmp_path / "trace" / "trace.json").exists()
    assert any(e.name == "traced" for e in prof.events())  # the span is a region of the trace


def test_span_records_carry_start_and_end_on_perf_counter_ns_inside_their_parent():
    sink = _Spans()
    wall, before = time.time(), time.perf_counter_ns()
    with span("outer", sink=sink, epoch=2):
        with span("inner", sink=sink):
            time.sleep(0.002)
    after = time.perf_counter_ns()
    inner, outer = sink.records
    for rec in (inner, outer):
        assert isinstance(rec["t0_ns"], int) and before <= rec["t0_ns"] <= rec["t1_ns"] <= after
        assert rec["dur_s"] == round((rec["t1_ns"] - rec["t0_ns"]) / 1e9, 6)
        assert wall - 0.001 <= rec["ts"] <= wall + (after - before) / 1e9 + 0.001  # the start's wall clock
    assert outer["t0_ns"] <= inner["t0_ns"] and inner["t1_ns"] <= outer["t1_ns"] and inner["dur_s"] >= 0.002
    assert (inner["path"], inner["depth"], outer["path"], outer["depth"]) == ("outer/inner", 1, "outer", 0)


def test_span_records_hold_jaxs_fields_and_the_two_clock_fields():
    """The port's deliberate difference: ``t0_ns`` and ``t1_ns`` beside
    every field JAX's record has (``process``: JAX's always, the port's
    under a ``torch.distributed`` world)."""
    got, want = _Spans(), _Spans()
    with span("a", sink=got, epoch=1):
        pass
    with jspan("a", sink=want, epoch=1):
        pass
    (g,), (w,) = got.records, want.records
    assert set(g) - set(w) == {"t0_ns", "t1_ns"} and set(w) - {"process"} <= set(g)
    assert {k: g[k] for k in ("kind", "name", "path", "depth", "epoch")} == {
        k: w[k] for k in ("kind", "name", "path", "depth", "epoch")}


def test_a_span_without_an_active_sink_builds_no_record(monkeypatch):
    def built(*a, **k):
        raise AssertionError("a span built a record with no active sink")

    monkeypatch.setattr(tspans, "record", built)
    assert get_sink() is None
    with span("no_sink"):
        with span("inactive", sink=Telemetry(None)):
            pass
    assert tspans._stack() == []


def test_tags_added_inside_a_span_land_in_its_record():
    sink = _Spans()
    with span("call", sink=sink, k=4) as tags:
        tags["phases"] = {"stage": (1, 2)}
    (rec,) = sink.records
    assert rec["k"] == 4 and rec["phases"] == {"stage": (1, 2)}


def test_a_sink_that_raises_leaves_the_span_stack_as_it_was():
    class Broken:
        active = True

        def write_raw(self, rec):
            raise OSError("closed")

    sink = _Spans()
    with pytest.raises(OSError):
        with span("outer", sink=Broken()):
            pass
    assert tspans._stack() == []
    with span("after", sink=sink):
        pass
    assert (sink.records[0]["path"], sink.records[0]["depth"]) == ("after", 0)


def test_make_trainer_writes_its_span_with_the_three_children():
    sink = _Spans()
    set_sink(sink)
    try:
        thdce.make_trainer(_tcfg(), "cpu", steps_per_epoch=4)
    finally:
        set_sink(None)
    children = ["hdce_init", "hdce_to_device", "optimizer_init"]
    assert [r["name"] for r in sink.records] == [*children, "hdce_make_trainer"]
    top = sink.records[-1]
    assert (top["path"], top["depth"]) == ("hdce_make_trainer", 0)
    for rec in sink.records[:-1]:
        assert (rec["path"], rec["depth"]) == (f"hdce_make_trainer/{rec['name']}", 1)
        assert top["t0_ns"] <= rec["t0_ns"] <= rec["t1_ns"] <= top["t1_ns"]
    starts = [r["t0_ns"] for r in sink.records[:-1]]
    assert starts == sorted(starts)


def test_step_clock_flushes_a_counters_record(tmp_path):
    tele = Telemetry(str(tmp_path / "c.jsonl"))
    clock = StepClock("unit", sink=tele)
    for i in range(4):
        with clock.step() as st:
            if i % 2:
                st.transfer()
    clock.epoch_end(epoch=0)
    tele.close()
    recs = _read(tmp_path / "c.jsonl")
    assert recs[0]["name"] == "compile_first_step" and recs[0]["path"] == "unit/compile_first_step"
    c = recs[1]
    assert c["kind"] == "counters" and c["name"] == "unit" and c["epoch"] == 0
    # built by span()'s record code: its clock fields, dur_s derived from them
    assert recs[0]["t0_ns"] <= recs[0]["t1_ns"] and recs[0]["dur_s"] == c["compile_s"]
    assert recs[0]["dur_s"] == round((recs[0]["t1_ns"] - recs[0]["t0_ns"]) / 1e9, 6)
    assert c["step"]["n"] == 3 and c["host_transfers"] == 2 and c["compile_s"] is not None
    assert c["memory"] is None and device_memory_snapshot() is None  # no card here
    assert {"autotune_measure", "autotune_table_write"} <= set(c["compile_cache"])


@pytest.mark.parametrize("probe_every,k", [(0, 2), (1, 2), (0, 1)])
def test_k_step_epoch_host_transfers_follow_the_probe_cadence(tmp_path, probe_every, k):
    """JAX's zero-transfer pin: a K-step epoch fetches nothing at
    probe_every=0 (the epoch's loss sum only), one bulk loss fetch a
    steady dispatch at probe_every=1."""
    cfg = _tcfg(**{"train.probe_every": probe_every, "train.scan_steps": k, "eval.results_dir": tmp_path})
    log = MetricsLogger(str(tmp_path / "t.jsonl"), echo=False)
    set_sink(log)
    try:
        tdce.train_dce(cfg, device="cpu", logger=log)
    finally:
        set_sink(None)
        log.close()
    counters = [r for r in _read(tmp_path / "t.jsonl") if r.get("kind") == "counters"]
    assert len(counters) == 1
    steady = counters[0]["step"]["n"]
    assert steady >= 1 and counters[0]["host_transfers"] == (steady if probe_every else 0)
    costs = [r for r in _read(tmp_path / "t.jsonl") if r.get("kind") == "cost"]
    assert len(costs) == 1 and costs[0]["name"] == "dce_train_scan" and costs[0]["scan_steps"] == k


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_cli_streams_open_with_the_manifest_and_divergence_exits_4(tmp_path, capsys):
    base = ["--device=cpu", "--data.n_ant=16", "--data.data_len=40", "--model.features=4",
            "--train.batch_size=8", "--train.n_epochs=1", "--quantum.n_qubits=4",
            "--quantum.impl=pallas_circuit", f"--train.workdir={tmp_path / 'w'}",
            f"--eval.results_dir={tmp_path / 'r'}"]
    assert cli.main(["train-dce", "--data.n_sub=8", "--data.n_beam=4", *base]) == 0
    recs = _read(next((tmp_path / "w").rglob("train-dce.metrics.jsonl")))
    assert recs[0]["kind"] == "manifest" and recs[0]["argv"][0] == "train-dce"
    assert {"numerics", "counters", "cost", "span"} <= {r.get("kind") for r in recs}
    assert get_sink() is None  # detached after the command
    rc = cli.main(["train-qsc", *base, "--quantum.use_quantumnat=true", "--quantum.noise_level=inf"])
    out = capsys.readouterr().out
    assert rc == 4 and "DIVERGED: qsc_train diverged" in out and "flightrec" in out
    assert get_sink() is None


def test_cli_report_runs_before_any_config_or_device(tmp_path, capsys, monkeypatch):
    import qdml_tpu_torch.utils.device as dev

    def no_device(*a, **k):
        raise AssertionError("report resolved a device")

    monkeypatch.setattr(dev, "resolve_device", no_device)
    bench = os.path.join(os.path.dirname(__file__), "..", "results", "bench_tpu_v5e_r5.json")
    assert cli.main(["report", f"--current={bench}", f"--baseline={bench}"]) == 0
    assert "telemetry report" in capsys.readouterr().out
    assert cli.main(["report", "--current=/nonexistent"]) == 2
