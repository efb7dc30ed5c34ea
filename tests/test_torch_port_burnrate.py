"""The port's burn-rate alerting and timeline (``telemetry/burnrate.py``)
against the JAX package's, on the CPU: the same fed sequences give the same
decisions step for step (fires, resolves, burns, peaks, open episodes), and
the same records render the same markdown, through the function and through
``monitor --render``."""

from __future__ import annotations

import random

import pytest

torch = pytest.importorskip("torch")

from qdml_tpu.telemetry import burnrate as jburn  # noqa: E402
from qdml_tpu.telemetry import timeseries as jts  # noqa: E402
from qdml_tpu_torch.telemetry import burnrate as tburn  # noqa: E402
from qdml_tpu_torch.telemetry import timeseries as tts  # noqa: E402


def test_burn_rate_matches_jax_and_zero_traffic_is_none():
    for errors, total, budget in [(0, 0, 0.01), (1, 0, 0.01), (5, 100, 0.01), (0, 50, 0.02), (3, 10, 0.0),
                                  (0, 10, 0.0), (-2, 10, 0.05), (7, None, 0.01)]:
        assert tburn.burn_rate(errors, total, budget) == jburn.burn_rate(errors, total, budget)
    assert tburn.burn_rate(0, 0, 0.01) is None


def _feed(mod, seed: int) -> list:
    """A random fed sequence of (t, errors, total) with quiet, bursty and
    zero-traffic stretches, evaluated every step."""
    rng = random.Random(seed)
    rule = mod.BurnRateRule("slo", budget=0.01, fast_s=2.0, slow_s=6.0, threshold=8.0, debounce=2)
    out, t = [], 0.0
    for step in range(300):
        t += rng.choice([0.4, 0.5, 1.0])
        phase = (step // 25) % 4
        total = 0 if phase == 3 and rng.random() < 0.7 else rng.randrange(20, 80)
        bad = rng.randrange(0, total + 1) // (1 if phase == 1 else 40) if total else 0
        rule.feed(t, bad, total)
        out.append((rule.evaluate(t), rule.burns(t), rule.firing))
    out.append((rule.peak_fast, rule.peak_slow, rule.fired_count, rule.resolved_count))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rule_decisions_match_jax_step_for_step(seed):
    got, want = _feed(tburn, seed), _feed(jburn, seed)
    assert got == want
    assert got[-1][2] >= 1 and got[-1][3] >= 1  # the sequence fires and resolves


def test_rule_rejects_a_slow_window_shorter_than_the_fast():
    for mod in (tburn, jburn):
        with pytest.raises(ValueError, match="slow window"):
            mod.BurnRateRule("x", 0.01, fast_s=5.0, slow_s=2.0, threshold=8.0)


@pytest.mark.parametrize("duration,interval,kw", [
    (30.0, 0.4, {}), (600.0, 1.0, {"slo_target": 0.999}), (5.0, 0.5, {"threshold": 3.0, "debounce": 1}),
    (60.0, 1.0, {"fast_s": 3.0, "slow_s": 9.0, "budgets": {"router": 0.05}}),
], ids=["dryrun", "long", "short", "explicit"])
def test_alerter_for_run_matches_jax(duration, interval, kw):
    t = tburn.BurnAlerter.for_run(duration_s=duration, interval_s=interval, **kw)
    j = jburn.BurnAlerter.for_run(duration_s=duration, interval_s=interval, **kw)
    assert t.rules.keys() == j.rules.keys()
    for k in t.rules:
        a, b = t.rules[k], j.rules[k]
        assert (a.budget, a.fast_s, a.slow_s, a.threshold, a.debounce) == (
            b.budget, b.fast_s, b.slow_s, b.threshold, b.debounce), k
    assert tburn.BurnAlerter.DEFAULT_BUDGETS == jburn.BurnAlerter.DEFAULT_BUDGETS


def _alerter_run(mod, seed: int) -> list:
    rng = random.Random(seed)
    al = mod.BurnAlerter.for_run(duration_s=30.0, interval_s=0.4, threshold=8.0, debounce=2)
    out, t = [], 0.0
    for step in range(120):
        t += 0.4
        fault = 40 <= step < 70
        for sig in ("slo", "shed", "breaker", "quarantine", "router", "stranded", "unknown"):
            total = rng.randrange(0, 60)
            bad = rng.randrange(0, total + 1) if fault and sig in ("slo", "router") else 0
            al.feed(t, sig, bad, total)
        out.append((al.evaluate(t, mark="fault" if fault else "quiet"), al.burns(t), al.firing()))
    out.append(al.peaks())
    return out


@pytest.mark.parametrize("seed", [0, 7])
def test_alerter_battery_matches_jax_step_for_step(seed):
    got = _alerter_run(tburn, seed)
    assert got == _alerter_run(jburn, seed)
    fired = [a for step in got[:-1] for a in step[0] if a["state"] == "firing"]
    assert fired and all(a["mark"] == "fault" for a in fired)
    assert {a["episode"] for a in fired} >= {"slo#1"}


def _records() -> list[dict]:
    return [
        {"kind": "manifest", "argv": ["monitor"], "ts": 1000.0},
        {"kind": "monitor_timeseries", "ts": 1001.0, "t_s": 1.0, "seq": 1, "mark": "baseline", "rps": 50.0,
         "slo": {"n": 50, "met": 50}, "queue_depth": 0, "replicas": 2, "backends_live": 2,
         "burn": {"slo": {"fast": 0.0, "slow": 0.0}}},
        {"kind": "monitor_event", "event": "backend_restart", "backend": "b1", "t_s": 1.6, "mark": "fault"},
        {"kind": "monitor_event", "event": "mark", "mark": "fault", "t_s": 1.5},
        {"kind": "counter_reset", "counter": "completed", "t_s": 1.7, "mark": "fault"},
        {"kind": "monitor_timeseries", "ts": 1002.0, "t_s": 2.0, "seq": 2, "mark": "fault", "rps": 20.0,
         "slo": {"n": 40, "met": 20}, "queue_depth": 7, "replicas": 2, "backends_live": 1,
         "burn": {"slo": {"fast": 50.0, "slow": 12.0}, "router": {"fast": 30.0, "slow": 9.0}}},
        {"kind": "monitor_alert", "signal": "router", "state": "firing", "t_s": 2.0, "mark": "fault",
         "fast_burn": 30.0, "slow_burn": 9.0, "threshold": 8.0, "budget": 0.02, "fast_s": 2.0, "slow_s": 6.0},
        {"kind": "monitor_alert", "signal": "router", "state": "resolved", "t_s": 3.0, "mark": "fault",
         "fast_burn": 1.0, "slow_burn": 2.0, "threshold": 8.0, "budget": 0.02, "fast_s": 2.0, "slow_s": 6.0},
        {"kind": "monitor_summary", "windows": 2, "duration_s": 2.0, "interval_s": 1.0, "scrape_errors": 0,
         "counter_resets": 1, "alerts": {"fired": 1, "resolved": 1, "by_mark": {"fault": 1, "": 0},
                                         "by_signal": {"router": 1}},
         "peak_burn": {"router": {"fast": 30.0, "slow": 9.0}},
         "planner": {"ok": True, "n_windows": 3, "max_p99_ratio": 1.4, "max_rps_err": 0.05}},
    ]


def _stack() -> list[dict]:
    return [
        {"kind": "counters", "name": "replica_restarted", "ts": 1001.7, "replica": "serve-replica-0"},
        {"kind": "counters", "name": "backend_ejected", "ts": 1001.9, "backend": "h1"},
        {"kind": "counters", "name": "control_event", "ts": 1001.95, "action": "adapted"},
        {"kind": "counters", "name": "drift_event", "ts": 1001.99, "scenario": 2},
        {"kind": "counters", "name": "loss", "ts": 1001.8},
    ]


@pytest.mark.parametrize("extra", [None, "stack"], ids=["alone", "with_stack_events"])
def test_render_timeline_matches_jax(extra):
    stack = _stack() if extra else None
    md = tburn.render_timeline(_records(), extra_events=stack)
    assert md == jburn.render_timeline(_records(), extra_events=stack)
    assert "**ALERT router**" in md and "router FIRING" in md and "capacity-planner validation: PASS" in md
    if extra:
        assert "replica_restarted(serve-replica-0)" in md and "backend_ejected(h1)" in md and "loss" not in md


def test_render_timeline_truncates_as_jax(tmp_path):
    recs = [{"kind": "monitor_timeseries", "ts": 1000.0 + i, "t_s": float(i), "seq": i, "mark": "m",
             "rps": 1.0, "queue_depth": 0, "replicas": 1} for i in range(12)]
    assert tburn.render_timeline(recs, max_rows=5) == jburn.render_timeline(recs, max_rows=5)
    assert "7 more windows truncated" in tburn.render_timeline(recs, max_rows=5)


def test_monitor_render_command_matches_jax(tmp_path, capsys):
    import json

    cur, ev = tmp_path / "monitor.jsonl", tmp_path / "stack.jsonl"
    cur.write_text("".join(json.dumps(r) + "\n" for r in _records()))
    ev.write_text("".join(json.dumps(r) + "\n" for r in _stack()))
    outs = []
    for mod in (tts, jts):
        out = tmp_path / f"{mod.__name__}.md"
        assert mod.monitor_main(["--render", f"--current={cur}", f"--events={ev}", f"--out={out}"]) == 0
        outs.append(out.read_text())
    assert outs[0] == outs[1] and "**ALERT router**" in outs[0]
    assert tts.monitor_main(["--render"]) == 2 == jts.monitor_main(["--render"])
    capsys.readouterr()
    assert tts.monitor_main(["--render", f"--current={cur}"]) == 0
    assert capsys.readouterr().out.startswith("# fleet flight deck")
