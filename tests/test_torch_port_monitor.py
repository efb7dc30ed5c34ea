"""The port's monitor (``telemetry/timeseries.py``) and hands-off attachment
(``telemetry/attach.py``) against the JAX package's, on the CPU, with no
socket: scripted pollers (the same health, metrics and events replies) and
a fake clock drive one scraper of each package, and every record either
writes (windows, derived events, counter resets, alerts, tailed spine
envelopes, the summary) and publishes on its package's event bus is
compared field for field. The attachment's policy ticks go through each
package's ``FleetAutoscaler`` and are compared the same way, and so are its
reconnect and give-up records, all but their times."""

from __future__ import annotations

import copy
import threading

import pytest

torch = pytest.importorskip("torch")

from qdml_tpu.control import fleet_scale as jfs  # noqa: E402
from qdml_tpu.telemetry import attach as jattach  # noqa: E402
from qdml_tpu.telemetry import burnrate as jburn  # noqa: E402
from qdml_tpu.telemetry import events as jevents  # noqa: E402
from qdml_tpu.telemetry import timeseries as jts  # noqa: E402
from qdml_tpu_torch.control import fleet_scale as tfs  # noqa: E402
from qdml_tpu_torch.control import loop as tloop  # noqa: E402
from qdml_tpu_torch.telemetry import attach as tattach  # noqa: E402
from qdml_tpu_torch.telemetry import burnrate as tburn  # noqa: E402
from qdml_tpu_torch.telemetry import events as tevents  # noqa: E402
from qdml_tpu_torch.telemetry import timeseries as tts  # noqa: E402

PORT = {"ts": tts, "burn": tburn, "events": tevents, "fs": tfs, "attach": tattach}
JAX = {"ts": jts, "burn": jburn, "events": jevents, "fs": jfs, "attach": jattach}
TIMES = ("ts", "late_s", "slots_skipped", "elapsed_s")


@pytest.fixture(autouse=True)
def _fresh_buses():
    for m in (tevents, jevents):
        m.install_bus(m.EventBus(capacity=4096))
    yield
    for m in (tevents, jevents):
        m.install_bus(None)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class _Sink:
    active = True

    def __init__(self):
        self.records = []

    def emit(self, kind, **payload):
        self.records.append({"kind": kind, **copy.deepcopy(payload)})


def _timeless(x):
    if isinstance(x, dict):
        return {k: _timeless(v) for k, v in x.items() if k not in TIMES}
    if isinstance(x, list):
        return [_timeless(v) for v in x]
    return x


class _Script:
    """One scripted endpoint: ``steps`` of (health, metrics, events to
    publish before the scrape, verbs that fail). The events verb tails a
    real bus of the package under test, so cursors and the loss ledger are
    each package's own."""

    def __init__(self, mods, steps, capacity=4096):
        self.mods = mods
        self.steps = steps
        self.i = 0
        self.bus = mods["events"].EventBus(capacity=capacity)
        self.calls: list[str] = []

    def advance(self):
        self.i += 1
        for kind, fields in self.steps[self.i - 1].get("publish", []):
            self.bus.publish(kind, **fields)

    def _step(self):
        return self.steps[min(self.i, len(self.steps)) - 1]

    def _maybe_fail(self, verb):
        if verb in self._step().get("fail", ()):
            raise ConnectionRefusedError(f"{verb} down")

    def health(self):
        self.calls.append("health")
        self._maybe_fail("health")
        return copy.deepcopy(self._step()["health"])

    def metrics(self):
        self.calls.append("metrics")
        self._maybe_fail("metrics")
        return copy.deepcopy(self._step()["metrics"])

    def events(self, cursor=None, limit=512):
        self.calls.append("events")
        self._maybe_fail("events")
        return self.bus.tail(cursor, limit=limit)


def _serve_steps() -> list[dict]:
    steps, completed, slo_n, slo_met, seq, up = [], 0, 0, 0, 111, 5.0
    for i in range(14):
        completed += 40
        slo_n += 30
        slo_met += 30 if not 5 <= i < 9 else 12
        up += 1.0
        health = {"warm": True, "replicas": 2, "queue_depth": i % 3, "quarantined": ["r1"] if i >= 7 else [],
                  "swap_epoch": 0 if i < 10 else 1, "uptime_s": up, "start_seq": seq}
        metrics = {"completed": completed, "shed": {"queue_full": i // 4}, "faults": {"worker": i // 6},
                   "restarts": 1 if i >= 8 else 0, "slo": {"n": slo_n, "met": slo_met},
                   "breaker": {"state": "open" if 6 <= i < 8 else "closed", "fast_fails": 3 * (i >= 6),
                               "admitted": completed}}
        step = {"health": health, "metrics": metrics,
                "publish": [("replica_restarted", {"replica": "serve-replica-1", "rid": f"r{i}"})] if i in (8, 9)
                else []}
        if i == 11:  # the process restarts: counters start over under a new epoch
            completed, slo_n, slo_met, seq, up = 10, 8, 8, 222, 0.5
            step["health"].update(start_seq=seq, uptime_s=up)
            step["metrics"].update(completed=completed, slo={"n": slo_n, "met": slo_met}, restarts=0)
        if i == 12:
            step["fail"] = ("events",)
        steps.append(step)
    return steps


def _router_steps() -> list[dict]:
    steps, fwd, failed, fov, ej, re_ = [], 0, 0, 0, 0, 0
    seqs = {"b0": 1, "b1": 2}
    for i in range(16):
        fwd += 50
        fault = 5 <= i < 11
        failed += 15 if fault else 0
        fov += 6 if fault else 0
        ej += 1 if i == 6 else 0
        re_ += 1 if i == 12 else 0
        if i == 13:
            seqs["b1"] = 99
        per = {b: {"poll_ok": not (fault and b == "b1"), "start_seq": s, "uptime_s": 9.0,
                   "breaker": {"state": "closed", "fast_fails": 0, "admitted": fwd // 2}} for b, s in seqs.items()}
        if i == 14:
            per["b2"] = {"poll_ok": True, "start_seq": 5, "state": "serving"}
        health = {"fleet": True, "backends": 2 + (i == 14), "backends_live": 1 if fault else 2,
                  "queue_depth": 3 if fault else 0, "replicas": 4, "swap_epoch": 0,
                  "router": {"forwarded": fwd, "failed_forwards": failed, "failovers": fov, "ejections": ej,
                             "readmissions": re_},
                  "per_backend": per}
        metrics = {"completed": fwd - failed, "shed": {}, "faults": {}, "restarts": 0,
                   "slo": {"n": fwd, "met": fwd - failed - fov}, "per_backend": per}
        steps.append({"health": health, "metrics": metrics,
                      "publish": [("backend_ejected", {"backend": "b1"})] if i == 6 else []})
    return steps


def _scrape(mods, steps, marks, tail=True, capacity=4096):
    clk, sink = _Clock(), _Sink()
    poller = _Script(mods, steps, capacity)
    alerter = mods["burn"].BurnAlerter.for_run(duration_s=12.0, interval_s=1.0, threshold=8.0, debounce=2)
    s = mods["ts"].MonitorScraper(poller, sink=sink, interval_s=1.0, alerter=alerter, clock=clk, tail_events=tail)
    recs = []
    for i in range(len(steps)):
        if i in marks:
            s.mark(marks[i])
        poller.advance()
        clk.t += 1.0
        recs.append(s.scrape_once())
    s.feed_external("stranded", 0, 100)
    summary = s.finish(extra={"expect": {"fired": ["fault"], "quiet": ["baseline"]}})
    bus = mods["events"].ensure_bus().tail(None, limit=100_000)["events"]
    return {"records": recs, "sink": sink.records, "summary": summary, "calls": sorted(set(poller.calls)),
            "bus": [(e["kind"], e["tier"], e["severity"], e.get("episode"), e["data"]) for e in bus],
            "cursor": s.events_cursor is not None, "errors": s.scrape_errors}


@pytest.mark.parametrize("script,marks,tail", [
    ("serve", {0: "baseline", 5: "fault", 10: "recovery"}, True),
    ("serve", {0: "baseline"}, False),
    ("router", {0: "baseline", 5: "fault", 11: "recovery"}, True),
    ("router", {}, False),
], ids=["serve_tailed", "serve_two_verbs", "router_tailed", "router_unmarked"])
def test_scraper_records_match_jax(script, marks, tail):
    steps = _serve_steps() if script == "serve" else _router_steps()
    got = _scrape(PORT, steps, marks, tail)
    want = _scrape(JAX, steps, marks, tail)
    assert _timeless(got) == _timeless(want)
    assert got["calls"] == (["events", "health", "metrics"] if tail else ["health", "metrics"])
    kinds = {r["kind"] for r in got["sink"]}
    assert {"monitor_timeseries", "monitor_event", "monitor_summary"} <= kinds
    if script == "router" and marks:
        assert got["summary"]["alerts"]["by_mark"].get("fault", 0) >= 1
        assert got["summary"]["alerts"]["by_mark"].get("baseline", 0) == 0
    if script == "serve" and tail:
        assert "counter_reset" in kinds and got["summary"]["event_drops"] == 0 and got["errors"] == 1
        # tailed envelopes are recorded, never published back (the echo guard)
        assert not any(k == "spine_event" for k, *_ in got["bus"])


def test_scraper_loss_ledger_matches_jax_on_a_lapped_ring():
    steps = _serve_steps()
    for st in steps[2:4]:
        st["publish"] = [("k", {"i": i}) for i in range(9)]
    got, want = _scrape(PORT, steps, {}, True, capacity=4), _scrape(JAX, steps, {}, True, capacity=4)
    assert _timeless(got) == _timeless(want)
    assert got["summary"]["event_drops"] > 0


def test_scraper_survives_a_dead_poller_as_jax():
    steps = [{"health": {}, "metrics": {}, "fail": ("health",)}] * 3
    got, want = _scrape(PORT, steps, {}, True), _scrape(JAX, steps, {}, True)
    assert _timeless(got) == _timeless(want)
    assert got["records"] == [None, None, None] and got["errors"] == 3


def test_counter_delta_has_one_home():
    assert tloop.counter_delta is tts.counter_delta
    for prev, cur in [(10, 15), (None, 7), (None, None), (3, 3), (100, 12), (5.5, 2.0)]:
        assert tts.counter_delta(prev, cur) == jts.counter_delta(prev, cur)
    d, r = tts.SnapshotDiff(), jts.SnapshotDiff()
    for name, v in [("a", 5), ("b", 3), ("a", 9), ("a", 2), ("b", 4)]:
        assert d.window(name, v) == r.window(name, v)
    ring = tts.Ring(3)
    for i in range(5):
        ring.add({"i": i})
    assert len(ring) == 3 and [x["i"] for x in ring] == [2, 3, 4] and ring.last() == {"i": 4}


# ---------------------------------------------------------------------------
# the attachment
# ---------------------------------------------------------------------------


class _FiringAlerter:
    def __init__(self):
        self.open = []

    def firing(self):
        return list(self.open)


def _ticks(mods, windows, alerts):
    sink, scaled = _Sink(), []
    auto = mods["fs"].FleetAutoscaler(lambda k: scaled.append(k) or {"ok": True, "actions": []}, min_backends=2,
                                      max_backends=3, queue_high=5.0, queue_low=1.0, debounce=2, cooldown_ticks=0,
                                      sink=sink)
    s = mods["ts"].MonitorScraper(_Script(mods, [{"health": {}, "metrics": {}}]), sink=sink, interval_s=1.0,
                                  clock=_Clock())
    s.alerter = _FiringAlerter()
    att = mods["attach"].MonitorAttachment(s, auto)
    out = []
    for rec, alert in zip(windows, alerts):
        s.alerter.open = alert
        out.append(att.tick(rec))
    return {"decisions": out, "summary": att.summary(), "sink": sink.records, "scaled": scaled}


def test_attachment_ticks_match_jax_and_stamp_the_episode():
    burn = [{"signal": "router", "episode": "router#1"}]
    windows = ([{"queue_depth": 20, "backends": 2}] * 2 + [{"queue_depth": 0, "backends": 3}] * 7
               + [{"queue_depth": 0, "backends": 2, "backends_live": 1}] * 3
               + [{"queue_depth": 0, "backends": 2, "backends_live": 2, "slo": {"attainment": 0.5}}] * 2)
    alerts = [burn] * 2 + [burn] * 5 + [[]] * 2 + [burn] * 3 + [[]] * 2
    got, want = _ticks(PORT, windows, alerts), _ticks(JAX, windows, alerts)
    assert _timeless(got) == _timeless(want)
    ups = [d for d in got["decisions"] if d and d["direction"] == "up"]
    assert ups and ups[0]["alert_episode"] == "router#1" and ups[0]["decision"] == "scale#1"
    assert got["scaled"][0] == 3 and got["summary"]["give_up"] is None


def test_attachment_dry_run_decides_without_acting():
    for mods in (PORT, JAX):
        scaled = []
        auto = mods["fs"].FleetAutoscaler(lambda k: scaled.append(k), min_backends=1, max_backends=3,
                                          queue_high=5.0, queue_low=1.0, debounce=1, cooldown_ticks=0,
                                          sink=_Sink(), dry_run=True)
        s = mods["ts"].MonitorScraper(_Script(mods, [{"health": {}, "metrics": {}}]), sink=_Sink(), clock=_Clock())
        att = mods["attach"].MonitorAttachment(s, auto)
        d = att.tick({"queue_depth": 50, "backends": 1})
        assert d["direction"] == "up" and d["dry_run"] is True and scaled == []


def _give_up(mods):
    sink = _Sink()
    auto = mods["fs"].FleetAutoscaler(lambda k: {"ok": True}, min_backends=1, max_backends=2, sink=sink)
    poller = _Script(mods, [{"health": {}, "metrics": {}, "fail": ("health",)}])
    poller.advance()
    s = mods["ts"].MonitorScraper(poller, sink=sink, interval_s=0.01, tail_events=True)
    att = mods["attach"].MonitorAttachment(s, auto, reconnect_backoff_s=0.002, reconnect_max_s=0.005,
                                           max_reconnects=3)
    ticks = att.run(5.0)
    return {"ticks": ticks, "give_up": att.give_up, "summary": att.summary(),
            "events": [r for r in sink.records if r["kind"] == "monitor_event"]}


def test_attachment_gives_up_typed_as_jax():
    got, want = _give_up(PORT), _give_up(JAX)
    strip = lambda d: _timeless({k: v for k, v in d.items()})  # noqa: E731
    for ev in got["events"] + want["events"]:
        ev.pop("t_s", None)
        ev.pop("error", None)
    assert strip(got) == strip(want)
    assert got["ticks"] == 0 and got["give_up"]["reason"] == "reconnect_exhausted"
    assert got["events"][-1]["event"] == "monitor_attach_giveup"


def test_attachment_reconnects_and_resumes_the_cursor():
    sink = _Sink()
    bus = tevents.EventBus()
    state = {"down": False}

    class _Flaky:
        def health(self):
            if state["down"]:
                raise ConnectionError("down")
            return {"warm": True, "replicas": 1, "queue_depth": 0, "quarantined": [], "swap_epoch": 0,
                    "uptime_s": 5.0, "start_seq": 1}

        def metrics(self):
            return {"completed": 0, "shed": {}, "faults": {}, "restarts": 0, "slo": {"n": 0, "met": 0},
                    "breaker": {"state": "closed", "fast_fails": 0, "admitted": 0}}

        def events(self, cursor=None, limit=512):
            return bus.tail(cursor, limit=limit)

    auto = tfs.FleetAutoscaler(lambda k: {"ok": True}, min_backends=1, max_backends=2, queue_high=1e9,
                               queue_low=-1.0, sink=sink)
    s = tts.MonitorScraper(_Flaky(), sink=sink, interval_s=0.01, tail_events=True)
    att = tattach.MonitorAttachment(s, auto, reconnect_backoff_s=0.01, reconnect_max_s=0.02, max_reconnects=50)
    bus.publish("k", i=0)
    stop = threading.Event()
    t = threading.Thread(target=att.run, args=(5.0, stop), daemon=True)
    t.start()
    import time

    time.sleep(0.15)
    state["down"] = True
    bus.publish("k", i=1)  # published during the outage
    time.sleep(0.15)
    state["down"] = False
    time.sleep(0.15)
    stop.set()
    t.join(timeout=5.0)
    assert not t.is_alive() and att.reattaches >= 1 and att.give_up is None
    assert [r for r in sink.records if r.get("event") == "monitor_reattach"][0]["after_attempts"] >= 1
    seen = [r["ev"]["data"]["i"] for r in sink.records if r["kind"] == "spine_event" and r["ev"]["kind"] == "k"]
    assert seen == [0, 1]
