"""The host-side commands ``events``, ``plan`` and ``monitor`` of the port's
CLI, against one live port ``run_server`` (port 0, a small engine on the
CPU) and against the JAX package's commands, on the CPU:

- ``normalize_tail`` reads both tail shapes as JAX's does;
- the port's ``events_main`` and JAX's, against the same server, print the
  same envelopes, with the same filters, loss lines and exit codes;
- ``monitor`` attaches over the three read verbs, writes a manifest-headed
  stream that ``report`` gates with exit 0, runs the hands-off loop in
  dry-run with no give-up, and gives up typed (exit 3) on a dead address;
- ``events``, ``plan`` and ``monitor`` dispatch before the CLI parses a
  config or resolves a device, and the monitor's manifest carries no torch
  block (it never asks the card anything).
"""

from __future__ import annotations

import json
import threading
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu.telemetry import events as jevents  # noqa: E402
from qdml_tpu.telemetry import timeseries as jts  # noqa: E402
from qdml_tpu_torch import cli  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.serve import batching_autotune  # noqa: E402
from qdml_tpu_torch.telemetry import events as tevents  # noqa: E402
from qdml_tpu_torch.telemetry import timeseries as tts  # noqa: E402
from qdml_tpu_torch.telemetry.report import report_main  # noqa: E402

WAIT = 30.0


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    """A port ``run_server`` on port 0 with 16 requests served."""
    from qdml_tpu_torch.serve import server as tserver
    from qdml_tpu_torch.serve.client import ServeClient
    from qdml_tpu_torch.serve.engine import ServeEngine
    from qdml_tpu_torch.serve.loadgen import run_loadgen_socket
    from qdml_tpu_torch.telemetry import run_manifest
    from qdml_tpu_torch.train import hdce as thdce
    from qdml_tpu_torch.train import qsc as tqsc
    from qdml_tpu_torch.utils.metrics import MetricsLogger

    d = tmp_path_factory.mktemp("server")
    batching_autotune.set_table_path(str(d / "batching.json"))
    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16), model=tconfig.ModelConfig(features=8),
        serve=tconfig.ServeConfig(max_batch=8, buckets=(4, 8), max_wait_ms=1.0, max_queue=64, batching="bucket",
                                  port=0, replicas=1, workers=1, deadline_ms=500.0))
    hdce, _ = thdce.make_trainer(cfg, "cpu", 4)
    clf, _ = tqsc.make_trainer(cfg, False, "cpu", 4)
    eng = ServeEngine(cfg, hdce.state_dict(), clf.state_dict(), device="cpu")
    eng.warmup()
    ready = Future()
    t = threading.Thread(target=tserver.run_server, args=(cfg, eng), kwargs={"ready": ready}, daemon=True)
    t.start()
    handle = ready.result(timeout=WAIT)
    x = np.random.default_rng(3).standard_normal((32, 16, 8, 2)).astype(np.float32)
    with ServeClient("127.0.0.1", handle["port"], timeout_s=WAIT) as c:
        assert all(c.request(x[i], rid=f"r{i}")["ok"] for i in range(16))
    # a traffic window's stream: the report's baseline beside a monitor stream
    window = d / "window.jsonl"
    wlog = MetricsLogger(str(window), echo=False, manifest=run_manifest(cfg, include_torch=False))
    try:
        sm = run_loadgen_socket(cfg, ("127.0.0.1", handle["port"]), rate=400.0, n=32, clients=2, timeout_s=WAIT,
                                x=x, logger=wlog)
    finally:
        wlog.close()
    assert sm["completed"] == 32
    try:
        yield {"addr": f"127.0.0.1:{handle['port']}", "dir": d, "window": str(window)}
    finally:
        handle["stop"]()
        t.join(timeout=WAIT)
        batching_autotune.set_table_path(None)


@pytest.fixture
def bus():
    """A fresh process-global bus: what the server's events verb tails."""
    b = tevents.EventBus(capacity=4096)
    tevents.install_bus(b)
    yield b
    tevents.install_bus(None)


def _dead_addr() -> str:
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{sk.getsockname()[1]}"


# ---------------------------------------------------------------------------
# events
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reply", [
    {"start_seq": 5, "next_seq": 9, "dropped": 1, "lost": 0, "events": [{"seq": 9}]},
    {"fleet": True, "events": [], "dropped": 0, "lost": 2, "cursor": {"router": {"start_seq": 1, "seq": 4}}},
    {},
], ids=["single_bus", "router", "empty"])
def test_normalize_tail_matches_jax(reply):
    assert tevents.normalize_tail(reply) == jevents.normalize_tail(reply)


def _publish(b: tevents.EventBus) -> None:
    b.publish("replica_restarted", tier="serve", replica="serve-replica-0", rid="a1")
    b.publish("backend_ejected", tier="router", backend="h1")
    b.publish("drift_event", tier="control", scenario=2)
    b.publish("monitor_timeseries", tier="monitor", seq=1)
    b.publish("control_event", tier="control", action="adapted", swap_epoch=3)


def _events(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out.splitlines(), out.err


@pytest.mark.parametrize("flags", [
    [], ["--kinds=backend_ejected,drift_event"], ["--min-severity=warning"], ["--tiers=control"], ["--limit=2"],
], ids=["all", "kinds", "severity", "tiers", "limit"])
def test_events_main_prints_what_jaxs_prints(server, bus, capsys, flags):
    _publish(bus)
    argv = [f"--addr={server['addr']}", *flags]
    got, want = _events(tevents.events_main, argv, capsys), _events(jevents.events_main, argv, capsys)
    assert got == want and got[0] == 0
    envs = [json.loads(line) for line in got[1]]
    if not flags:
        assert [e["kind"] for e in envs] == ["replica_restarted", "backend_ejected", "drift_event",
                                             "monitor_timeseries", "control_event"]
        assert envs[0]["rid"] == "a1" and envs[4]["swap_epoch"] == 3 and envs[3]["severity"] == "debug"
    if flags == ["--min-severity=warning"]:
        assert {e["severity"] for e in envs} <= {"warning", "critical"} and len(envs) == 3


def test_events_main_reports_loss_as_jax(server, capsys):
    small = tevents.EventBus(capacity=2)
    tevents.install_bus(small)
    try:
        for i in range(5):
            small.publish("k", i=i)
        argv = [f"--addr={server['addr']}"]
        got, want = _events(tevents.events_main, argv, capsys), _events(jevents.events_main, argv, capsys)
    finally:
        tevents.install_bus(None)
    assert got == want
    assert json.loads(got[1][0]) == {"spine_loss": {"dropped": 3, "lost": 3}} and len(got[1]) == 3


def test_events_main_exit_codes_match_jax(capsys):
    for argv in ([], ["--addr=nohost"]):
        got = _events(tevents.events_main, argv, capsys)
        assert got == _events(jevents.events_main, argv, capsys) and got[0] == 2
    dead = [f"--addr={_dead_addr()}", "--interval=0.05"]
    rc_t, out_t, err_t = _events(tevents.events_main, dead, capsys)
    rc_j, out_j, err_j = _events(jevents.events_main, dead, capsys)
    assert rc_t == rc_j == 3 and out_t == out_j == [] and "spine_error" in err_t and "spine_error" in err_j


# ---------------------------------------------------------------------------
# monitor
# ---------------------------------------------------------------------------


def test_monitor_attaches_over_read_verbs_and_report_gates_its_stream(server, bus, tmp_path, capsys):
    out = tmp_path / "monitor.jsonl"
    bus.publish("replica_restarted", tier="serve", replica="serve-replica-0")
    rc = tts.monitor_main([f"--addr={server['addr']}", "--interval=0.2", "--duration=1.0", f"--out={out}"])
    summary = json.loads(capsys.readouterr().out)["monitor"]
    assert rc == 0 and summary["windows"] >= 3 and summary["scrape_errors"] == 0 and "event_drops" not in summary
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert recs[0]["kind"] == "manifest" and recs[0]["argv"][0] == "monitor"
    assert recs[0]["torch"] is None and recs[0]["jax"] is None
    assert [r["kind"] for r in recs].count("monitor_timeseries") == summary["windows"]
    assert recs[-1]["kind"] == "monitor_summary"
    rc = report_main([f"--current={server['window']},{out}", f"--baseline={server['window']}",
                      f"--out={tmp_path / 'r.md'}"])
    assert rc == 0 and "monitoring (flight deck)" in (tmp_path / "r.md").read_text()


def test_monitor_attach_dry_run_tails_the_spine_without_giving_up(server, bus, tmp_path, capsys):
    out = tmp_path / "attach.jsonl"
    bus.publish("backend_ejected", tier="router", backend="h1")
    rc = tts.monitor_main([f"--addr={server['addr']}", "--attach", "--dry-run", "--interval=0.2",
                           "--duration=1.0", f"--out={out}"])
    summary = json.loads(capsys.readouterr().out)["monitor"]
    assert rc == 0 and summary["event_drops"] == 0 and summary["spine"]["events"] >= 1
    hands = summary["handsoff"]
    assert hands["give_up"] is None and hands["ticks"] >= 3 and hands["reattaches"] == 0
    spine = [json.loads(line) for line in out.read_text().splitlines() if '"spine_event"' in line]
    assert any(r["ev"]["kind"] == "backend_ejected" for r in spine)
    rc = report_main([f"--current={server['window']},{out}", f"--baseline={server['window']}",
                      f"--json={tmp_path / 'r.json'}", f"--out={tmp_path / 'r.md'}"])
    gates = {g["metric"]: g["status"] for g in json.loads((tmp_path / "r.json").read_text())["gates"]
             if g.get("kind") == "monitor"}
    assert rc == 0 and gates["monitor.event_drops"] == "ok" and gates["monitor.handsoff"] == "ok"


def test_jaxs_monitor_reads_the_port_server_as_the_ports_does(server, bus, tmp_path, capsys):
    outs = {}
    for name, mod in (("port", tts), ("jax", jts)):
        out = tmp_path / f"{name}.jsonl"
        assert mod.monitor_main([f"--addr={server['addr']}", "--attach", "--dry-run", "--interval=0.25",
                                 "--duration=0.8", f"--out={out}"]) == 0
        outs[name] = json.loads(capsys.readouterr().out)["monitor"]
    for s in outs.values():
        s.pop("duration_s")
        s.pop("windows")
        s["handsoff"].pop("ticks")
        s.pop("spine")
    assert outs["port"] == outs["jax"]


def test_monitor_gives_up_typed_on_a_dead_address(tmp_path, capsys):
    rc = tts.monitor_main([f"--addr={_dead_addr()}", "--attach", "--dry-run", "--interval=0.05", "--duration=20",
                           "--max-reconnects=2", f"--out={tmp_path / 'm.jsonl'}"])
    summary = json.loads(capsys.readouterr().out)["monitor"]
    assert rc == 3 and summary["handsoff"]["give_up"]["reason"] == "reconnect_exhausted"
    assert tts.monitor_main([]) == 2 and tts.monitor_main(["--addr=nohost"]) == 2


# ---------------------------------------------------------------------------
# the CLI: host-side dispatch
# ---------------------------------------------------------------------------


@pytest.fixture
def no_config_no_device(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a host-side command parsed a config or resolved a device")

    monkeypatch.setattr(cli.cfg_mod, "from_args", refuse)
    monkeypatch.setattr(cli, "resolve_device", refuse)
    monkeypatch.setattr(torch.cuda, "init", refuse)


@pytest.mark.parametrize("cmd", ["events", "plan", "monitor"])
def test_the_commands_dispatch_before_config_and_device(no_config_no_device, capsys, cmd):
    assert cli.main([cmd]) == 2  # a usage error, from the command itself
    assert "needs --" in capsys.readouterr().out
    assert cmd not in cli.COMMANDS


def test_the_cli_plans_and_tails(server, bus, no_config_no_device, tmp_path, capsys):
    import glob
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    windows = sorted(glob.glob(str(root / "results" / "trace_dryrun" / "traced_t*.jsonl")))
    assert cli.main(["plan", f"--trace={','.join(windows)}", "--validate"]) == 0
    assert json.loads(capsys.readouterr().out)["plan_validation"]["ok"] is True
    bus.publish("replica_quarantined", tier="serve", replica="r1")
    assert cli.main(["events", f"--addr={server['addr']}"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["kind"] == "replica_quarantined"
    assert cli.main(["monitor", f"--addr={server['addr']}", "--interval=0.2", "--duration=0.5",
                     f"--out={tmp_path / 'm.jsonl'}"]) == 0
    assert json.loads(capsys.readouterr().out)["monitor"]["windows"] >= 2
