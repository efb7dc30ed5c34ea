"""The port's elastic fleet against the JAX package's, on the CPU.

Held against ``qdml_tpu.fleet.lifecycle``, ``qdml_tpu.fleet.router``'s
membership and ``qdml_tpu.control.fleet_scale`` (mirroring
``tests/test_fleet_elastic.py``):

- ring add / remove / retire: bounded key movement, the exact hand-back,
  the typed and guarded draining state, a retry across a retirement
  answered by the router's dedup (backend exchanges stubbed);
- the lifecycle on injected spawn/verify fakes, as JAX's tests inject them:
  admission only after verification, quarantine of a cold standby and of
  one killed during admission, drain-then-retire of owned processes only,
  ``scale_to`` converging and stopping on a failed admission; the records
  and statuses equal to JAX's lifecycle on the same script;
- ``verify_warm`` against a protocol stub: the same facts and refusals as
  JAX's;
- ``FleetAutoscaler``'s decisions, events and state equal to JAX's on the
  same observation sequences, dry run and planner targets included; a
  target written by JAX's ``emit_target`` read by the port's
  ``load_planner_target``;
- the ``fleet`` verb's status and scaling forms through the port's front
  door, the port's and JAX's ``SocketPoller.fleet`` against it, and
  ``FleetPoller.fleet``;
- one test with real processes: ``cli serve --device=cpu`` children
  (``spawn_backend``, at most two), ``verify_warm``, ``cli route
  --fleet.elastic=true`` in front of them with traffic held against the
  engine, and ``cli fleet-scale``'s exit codes; and a child spawned
  without ``--device=cpu`` on a machine without a card makes
  ``spawn_backend`` raise.
"""

import asyncio
import json
import os
import signal
import socket as socket_mod
import subprocess
import sys
import threading
from concurrent.futures import Future
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

from qdml_tpu.control import fleet_scale as jfleet_scale  # noqa: E402
from qdml_tpu.control.loop import SocketPoller as JSocketPoller  # noqa: E402
from qdml_tpu.fleet import lifecycle as jlifecycle  # noqa: E402
from qdml_tpu.fleet import router as jrouter  # noqa: E402
from qdml_tpu.telemetry.capacity import emit_target  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch.control.fleet_scale import FleetAutoscaler, load_planner_target  # noqa: E402
from qdml_tpu_torch.control.loop import SocketPoller  # noqa: E402
from qdml_tpu_torch.fleet import lifecycle as tlifecycle  # noqa: E402
from qdml_tpu_torch.fleet import route_async, spawn_backend  # noqa: E402
from qdml_tpu_torch.fleet.lifecycle import AdmissionFailed, BackendLifecycle, verify_warm  # noqa: E402
from qdml_tpu_torch.fleet.poller import FleetPoller  # noqa: E402
from qdml_tpu_torch.fleet.router import Backend, FleetRouter  # noqa: E402
from qdml_tpu_torch.serve.client import ServeClient  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WAIT = 30.0
ZERO = {"measure": 0, "table_write": 0, "kernel_build": 0}


def _refused(self, msg, timeout_s=None, idempotent=True):
    raise ConnectionRefusedError("no backend listens here")


def _router(n: int, base_port: int = 45800, **kw) -> FleetRouter:
    """Router over n local addresses, never started: the membership
    machinery under test is pure (tests stub Backend.call)."""
    opts = dict(timeout_s=0.2, retries=0, poll_interval_s=30.0, dedup_ttl_s=30.0)
    opts.update(kw)
    return FleetRouter([("127.0.0.1", base_port + i) for i in range(n)], **opts)


def _primaries(router, keys) -> dict:
    return {k: router._candidates(k)[0].addr for k in keys}


# ---------------------------------------------------------------------------
# consistent-hash ring resize: bounded key movement
# ---------------------------------------------------------------------------


def test_ring_add_moves_only_new_hosts_share(monkeypatch):
    monkeypatch.setattr(Backend, "call", _refused)
    r = _router(4)
    keys = [f"req-{i}" for i in range(3000)]
    before = _primaries(r, keys)
    b = r.add_backend("127.0.0.1", 45990)
    after = _primaries(r, keys)
    moved = [k for k in keys if after[k] != before[k]]
    assert moved and all(after[k] == b.addr for k in moved)
    assert 0.05 < len(moved) / len(keys) < 0.45
    with pytest.raises(ValueError, match="already a fleet member"):
        r.add_backend("127.0.0.1", 45990)


def test_ring_remove_restores_prior_assignment_exactly(monkeypatch):
    monkeypatch.setattr(Backend, "call", _refused)
    r = _router(3)
    keys = [f"k-{i}" for i in range(2000)]
    before = _primaries(r, keys)
    b = r.add_backend("127.0.0.1", 45991)
    r.begin_retire(b)
    assert _primaries(r, keys) == before  # draining: off the ring at once
    assert r.health()["backends_draining"] == 1
    rec = r.finish_retire(b)
    assert rec == {"backend": b.host_id, "addr": b.addr, "inflight_at_removal": 0}
    assert _primaries(r, keys) == before and len(r.backends) == 3


def test_ring_retire_original_member_moves_only_its_keys():
    r = _router(4)
    keys = [f"id-{i}" for i in range(3000)]
    before = _primaries(r, keys)
    victim = r.backends[1]
    r.begin_retire(victim.addr)
    after = _primaries(r, keys)
    assert any(before[k] == victim.addr for k in keys)
    for k in keys:
        if before[k] == victim.addr:
            assert after[k] != victim.addr
        else:
            assert after[k] == before[k]


def test_draining_state_is_typed_and_guarded():
    r = _router(2)
    victim = r.backends[0]
    assert r.begin_retire(victim.addr) is victim and victim.draining
    assert r.begin_retire(victim.addr) is victim  # idempotent
    assert victim.poll_row()["state"] == "draining"
    assert FleetRouter.state_row(victim) == {"state": "draining"}
    assert victim not in r.live_backends()
    with pytest.raises(ValueError, match="last fleet member"):
        r.begin_retire(r.backends[1].addr)
    with pytest.raises(KeyError):
        r.begin_retire("nobody:1")


def _ok_call(calls):
    def fake_call(self, msg, timeout_s=None, idempotent=True):
        calls.append((self.addr, msg.get("op") or "infer", msg.get("id")))
        return {"id": msg.get("id"), "ok": True, "pred": 0, "h": [0.0]}

    return fake_call


def test_retry_before_resize_dedup_hits_after(monkeypatch):
    calls: list = []
    monkeypatch.setattr(Backend, "call", _ok_call(calls))
    r = _router(2)
    rep1 = r.request({"id": "rid-keep", "x": [1.0]})
    assert rep1["ok"]
    forwards = [c for c in calls if c[1] == "infer"]
    assert len(forwards) == 1
    rec = r.retire_backend(forwards[0][0], wait_s=1.0)
    assert rec["drained"] and rec["inflight_at_removal"] == 0 and len(r.backends) == 1
    assert r.request({"id": "rid-keep", "x": [1.0]}) == rep1
    assert len([c for c in calls if c[1] == "infer"]) == 1 and r.dedup.hits == 1


# ---------------------------------------------------------------------------
# the lifecycle on injected spawn/verify fakes
# ---------------------------------------------------------------------------


class _FakeProc:
    def __init__(self, host, port, host_id):
        self.host, self.port, self.host_id = host, port, host_id
        self.killed = self.terminated = False
        self._alive = True

    def alive(self):
        return self._alive

    def kill(self):
        self.killed = True
        self._alive = False

    def terminate(self, timeout_s: float = 10.0):
        self.terminated = True
        self._alive = False


def _fake_spawner(procs, base_port=46100):
    state = {"n": 0}

    def spawn(overrides, port=0, host="127.0.0.1", log_path=None, timeout_s=600.0, env=None, python=None):
        state["n"] += 1
        p = _FakeProc(host, base_port + state["n"], f"spawned-{state['n']}")
        procs.append(p)
        return p

    return spawn


def _lifecycle(router, procs, verify=None, cls=BackendLifecycle, **kw):
    return cls(router, spawn_fn=_fake_spawner(procs),
               verify_fn=verify or (lambda h, p, timeout_s=10.0: {"warm": True}), drain_wait_s=1.0, **kw)


def test_scale_up_admits_only_after_verification(monkeypatch):
    monkeypatch.setattr(Backend, "call", _ok_call([]))
    r = _router(1)
    procs: list = []
    verified: list = []

    def verify(host, port, timeout_s=10.0):
        assert all(b.port != port for b in r.backends)  # verify, then admit
        verified.append(port)
        return {"warm": True, "compile_cache_after_warmup": dict(ZERO)}

    lc = _lifecycle(r, procs, verify=verify)
    rec = lc.scale_up()
    assert rec["ok"] and rec["stage"] == "admitted" and verified == [procs[0].port]
    assert len(r.backends) == 2 and lc.fleet_size() == 2
    st = lc.status()
    assert st["lifecycle"][rec["addr"]]["state"] == "admitted" and rec["addr"] in st["owned"]


def test_cold_backend_is_quarantined_never_admitted(monkeypatch):
    monkeypatch.setattr(Backend, "call", _ok_call([]))
    r = _router(1)
    procs: list = []

    def verify(host, port, timeout_s=10.0):
        raise AdmissionFailed(f"{host}:{port} reports warm=False")

    lc = _lifecycle(r, procs, verify=verify)
    rec = lc.scale_up()
    assert not rec["ok"] and rec["stage"] == "quarantined" and "warm=False" in rec["reason"]
    assert len(r.backends) == 1 and procs[0].killed
    assert lc.status()["lifecycle"][rec["addr"]]["state"] == "quarantined"
    assert rec["addr"] not in lc.status()["owned"]


def test_kill_during_admission_quarantines_standby(monkeypatch):
    monkeypatch.setattr(Backend, "call", _ok_call([]))
    r = _router(2)
    procs: list = []

    def verify(host, port, timeout_s=10.0):
        procs[-1]._alive = False
        raise ConnectionResetError("peer vanished mid-verify")

    lc = _lifecycle(r, procs, verify=verify)
    rec = lc.scale_up()
    assert not rec["ok"] and rec["stage"] == "quarantined"
    assert len(r.backends) == 2 and not procs[0].killed  # already dead: no second kill


def test_spawn_failure_is_quarantined_before_a_process_exists(monkeypatch):
    monkeypatch.setattr(Backend, "call", _ok_call([]))
    r = _router(1)

    def spawn(overrides, **kw):
        raise RuntimeError("backend exited before announcing (rc=1)")

    lc = BackendLifecycle(r, spawn_fn=spawn)
    rec = lc.scale_up()
    assert rec == {"action": "scale_up", "ok": False, "stage": "spawn",
                   "reason": "spawn: RuntimeError: backend exited before announcing (rc=1)"}
    assert lc.status()["lifecycle"]["spawn-1"]["state"] == "quarantined" and len(r.backends) == 1


def test_scale_down_drains_and_terminates_only_owned(monkeypatch):
    monkeypatch.setattr(Backend, "call", _ok_call([]))
    r = _router(1)
    procs: list = []
    lc = _lifecycle(r, procs)
    lc.scale_up()
    rec = lc.scale_down()
    assert rec["ok"] and rec["stage"] == "retired" and rec["addr"] == f"{procs[0].host}:{procs[0].port}"
    assert rec["terminated"] and procs[0].terminated and rec["drained"]
    assert lc.fleet_size() == 1
    with pytest.raises(ValueError):
        lc.scale_down()


def test_scale_to_converges_and_aborts_on_failed_admission(monkeypatch):
    monkeypatch.setattr(Backend, "call", _ok_call([]))
    r = _router(1)
    procs: list = []
    gate = {"fail": False}

    def verify(host, port, timeout_s=10.0):
        if gate["fail"]:
            raise AdmissionFailed("cold standby")
        return {"warm": True}

    lc = _lifecycle(r, procs, verify=verify)
    rec = lc.scale_to(3)
    assert rec["ok"] and rec["backends"] == 3 and rec["backends_before"] == 1
    assert [a["stage"] for a in rec["actions"]] == ["admitted", "admitted"]
    gate["fail"] = True
    rec = lc.scale_to(5)
    assert not rec["ok"] and rec["backends"] == 3 and len(rec["actions"]) == 1
    assert rec["actions"][-1]["stage"] == "quarantined"
    gate["fail"] = False
    rec = lc.scale_to(1)
    assert rec["ok"] and rec["backends"] == 1 and all(p.terminated for p in procs[:2])
    with pytest.raises(ValueError):
        lc.scale_to(0)
    lc.close()


def _timeless(obj):
    """A record without its wall-clock fields (elapsed_s, spawn_s)."""
    if isinstance(obj, dict):
        return {k: _timeless(v) for k, v in obj.items() if k not in ("elapsed_s", "spawn_s")}
    if isinstance(obj, list):
        return [_timeless(v) for v in obj]
    return obj


def test_lifecycle_records_match_jax(monkeypatch):
    """The same script on both lifecycles (fakes injected alike): every
    record and every status equal, wall-clock fields aside."""
    monkeypatch.setattr(Backend, "call", _ok_call([]))
    monkeypatch.setattr(jrouter.Backend, "call", _ok_call([]))
    out = []
    for rmod, lmod in ((None, tlifecycle), (jrouter, jlifecycle)):
        r = _router(2) if rmod is None else rmod.FleetRouter(
            [("127.0.0.1", 45800 + i) for i in range(2)], timeout_s=0.2, retries=0, poll_interval_s=30.0)
        procs: list = []
        gate = {"n": 0}

        def verify(host, port, timeout_s=10.0, lmod=lmod, gate=gate):
            gate["n"] += 1
            if gate["n"] == 3:
                raise lmod.AdmissionFailed(f"{host}:{port} reports warm=False")
            if gate["n"] == 4:
                raise ConnectionResetError("peer vanished mid-verify")
            return {"warm": True, "host_id": f"h{port}"}

        lc = _lifecycle(r, procs, verify=verify, cls=lmod.BackendLifecycle)
        recs = [lc.scale_to(4), lc.status(), lc.scale_up(), lc.scale_up(), lc.status(), lc.scale_to(2),
                lc.status(), lc.scale_down(), lc.status()]
        out.append((_timeless(recs), [(p.killed, p.terminated) for p in procs]))
    assert out[0] == out[1]


# ---------------------------------------------------------------------------
# admission verification over the live verbs (protocol stub)
# ---------------------------------------------------------------------------


def _stub_server(replies: dict) -> int:
    """Serve-protocol stub: connections one after another, each answered
    from ``replies`` until it closes; closed after ``len(replies)`` of them."""
    srv = socket_mod.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    port = srv.getsockname()[1]

    def run():
        with srv:
            for _ in range(2):
                conn, _ = srv.accept()
                with conn:
                    fh = conn.makefile("rw", encoding="utf-8", newline="\n")
                    for line in fh:
                        msg = json.loads(line)
                        fh.write(json.dumps({"id": msg.get("id"), "ok": True, **replies[msg["op"]]}) + "\n")
                        fh.flush()

    threading.Thread(target=run, daemon=True).start()
    return port


@pytest.mark.parametrize("replies,match", [
    ({"health": {"health": {"warm": True, "host_id": "b-ok", "replicas": 1}},
      "metrics": {"metrics": {"compile_cache_after_warmup": dict(ZERO)}}}, None),
    ({"health": {"health": {"warm": False}}, "metrics": {"metrics": {}}}, "warm=False"),
    ({"health": {"health": {"warm": True}}, "metrics": {"metrics": {"compile_cache_after_warmup": {
        "measure": 0, "table_write": 1, "kernel_build": 0}}}}, "request-path compiles"),
    ({"health": {"health": {"warm": True}}, "metrics": {"metrics": {}}}, "no compile_cache"),
])
def test_verify_warm_matches_jax(replies, match):
    port = _stub_server(replies)
    outcomes = []
    for fn, exc in ((verify_warm, AdmissionFailed), (jlifecycle.verify_warm, jlifecycle.AdmissionFailed)):
        if match is None:
            outcomes.append(fn("127.0.0.1", port, timeout_s=5.0))
        else:
            with pytest.raises(exc, match=match) as info:
                fn("127.0.0.1", port, timeout_s=5.0)
            outcomes.append(str(info.value))
    assert outcomes[0] == outcomes[1]
    if match is None:
        assert outcomes[0] == {"warm": True, "host_id": "b-ok", "replicas": 1,
                               "compile_cache_after_warmup": ZERO}


# ---------------------------------------------------------------------------
# the fleet autoscaler, step for step against JAX's
# ---------------------------------------------------------------------------


def _scaler_pair(**kw):
    opts = dict(min_backends=1, max_backends=4, queue_high=10.0, queue_low=1.0, debounce=2, cooldown_ticks=2)
    opts.update(kw)
    calls: tuple[list, list] = ([], [])
    t = FleetAutoscaler(lambda n: calls[0].append(n) or {"ok": True, "backends": n}, **opts)
    j = jfleet_scale.FleetAutoscaler(lambda n: calls[1].append(n) or {"ok": True, "backends": n}, **opts)
    return t, j, calls


@pytest.mark.parametrize("seed,knobs", [
    (0, {}),
    (1, dict(dry_run=True, cooldown_ticks=0)),
    (2, dict(debounce=1, cooldown_ticks=1, max_backends=6)),
    (3, dict(min_backends=2, max_backends=3, debounce=3)),
])
def test_fleet_autoscaler_decisions_match_jax(seed, knobs):
    t, j, calls = _scaler_pair(**knobs)
    rng = np.random.default_rng(seed)
    backends = t.min_backends
    fired = {"up": 0, "down": 0}
    for i in range(240):
        if i % 60 == 30:  # a planner target pinned for a stretch, then cleared
            tgt = {"backends_needed": int(rng.integers(1, 8)), "assumptions_sha": f"sha-{i}"}
            t.set_planner_target(tgt)
            j.set_planner_target(tgt)
        elif i % 60 == 50:
            t.set_planner_target(None)
            j.set_planner_target(None)
        if rng.random() < 0.05:  # an operator's manual resize
            backends = int(rng.integers(1, 5))
        burn = bool(rng.random() < 0.15)
        obs = dict(
            queue_depth=float(rng.choice([0.0, 0.5, 5.0, 20.0, 60.0])),
            backends=backends,
            slo_attainment=[None, 1.0, 0.995, 0.9][int(rng.integers(4))],
            burn_alert=burn,
            alert_episode=f"ep-{i // 10}" if burn else None,
            backends_live=None if rng.random() < 0.3 else max(0, backends - int(rng.integers(0, 2))),
        )
        got, want = t.observe(**obs), j.observe(**obs)
        assert got == want, (i, obs)
        assert t.state() == j.state(), i
        if got is not None:
            fired[got["direction"]] += 1
            backends = got["backends"]
    assert calls[0] == calls[1]
    assert fired["up"] and fired["down"], fired
    if knobs.get("dry_run"):
        assert calls[0] == []


def test_fleet_autoscaler_validation_and_config_match_jax():
    for kw in (dict(min_backends=3, max_backends=2), dict(queue_high=1.0, queue_low=5.0), dict(min_backends=0)):
        with pytest.raises(ValueError) as got:
            FleetAutoscaler(lambda n: None, **kw)
        with pytest.raises(ValueError) as want:
            jfleet_scale.FleetAutoscaler(lambda n: None, **kw)
        assert str(got.value) == str(want.value)
    ctl = tconfig.from_args(["--control.min_backends=2", "--control.max_backends=5", "--control.fleet_queue_high=12",
                             "--control.fleet_queue_low=0.5", "--control.fleet_debounce=3",
                             "--control.fleet_cooldown_ticks=7", "--control.dry_run=true"]).control
    a = FleetAutoscaler.from_config(ctl, lambda n: None)
    assert (a.min_backends, a.max_backends, a.queue_high, a.queue_low, a.debounce, a.cooldown_ticks, a.dry_run) == (
        2, 5, 12.0, 0.5, 3, 7, True)
    assert FleetAutoscaler.from_config(ctl, lambda n: None, dry_run=False).dry_run is False
    assert jfleet_scale.SLO_FLOOR == FleetAutoscaler.__init__.__globals__["SLO_FLOOR"]


_PLAN_REC = {
    "trace": "w.jsonl",
    "target_rps": 100.0,
    "p99_target_ms": 50.0,
    "workers_per_backend": 1,
    "sweep": [{"backends": 1, "predicted_p99_ms": 80.0, "meets_target": False},
              {"backends": 2, "predicted_p99_ms": 30.0, "meets_target": True}],
    "backends_needed": 2,
}


def test_jax_emit_target_is_read_by_the_port(tmp_path):
    tgt = emit_target(_PLAN_REC)
    p = tmp_path / "target.json"
    for payload in ({"fleet_target": tgt}, tgt):
        p.write_text(json.dumps(payload))
        assert load_planner_target(str(p)) == jfleet_scale.load_planner_target(str(p)) == tgt
    t, j, calls = _scaler_pair(cooldown_ticks=0)
    t.set_planner_target(load_planner_target(str(p)))
    j.set_planner_target(jfleet_scale.load_planner_target(str(p)))
    got = t.observe(0.0, 1)
    assert got == j.observe(0.0, 1) and got["planner_sha"] == tgt["assumptions_sha"] and got["backends"] == 2
    assert t.observe(0.0, 2) is None  # converged
    p.write_text(json.dumps({"fleet_target": emit_target({**_PLAN_REC, "backends_needed": None})}))
    with pytest.raises(ValueError, match="no actionable backends_needed"):
        load_planner_target(str(p))


# ---------------------------------------------------------------------------
# the {"op": "fleet"} verb and the pollers
# ---------------------------------------------------------------------------


class _FakeLifecycle:
    """scale_to semantics without processes: converges up to max_ok."""

    def __init__(self, router, max_ok=3):
        self.router = router
        self.max_ok = max_ok

    def status(self):
        return {"backends": len(self.router.backends), "lifecycle": {}}

    def scale_to(self, n):
        got = min(int(n), self.max_ok)
        return {"backends_before": len(self.router.backends), "backends": got, "target": int(n),
                "ok": got == int(n), "actions": []}


@pytest.fixture()
def front(monkeypatch):
    """Two port front doors over stubbed routers: one without a lifecycle
    manager, one with a fake one."""
    monkeypatch.setattr(Backend, "call", _ok_call([]))
    aloop = asyncio.new_event_loop()
    t = threading.Thread(target=aloop.run_forever, daemon=True)
    t.start()
    ports = []
    for lc_factory in (lambda r: None, lambda r: _FakeLifecycle(r)):
        r = _router(2)
        ready: Future = Future()
        asyncio.run_coroutine_threadsafe(route_async(r, "127.0.0.1", 0, ready, lifecycle=lc_factory(r)), aloop)
        ports.append(ready.result(timeout=10.0))
    yield ports

    async def cancel_all():
        live = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
        for task in live:
            task.cancel()
        await asyncio.gather(*live, return_exceptions=True)

    asyncio.run_coroutine_threadsafe(cancel_all(), aloop).result(timeout=WAIT)
    aloop.call_soon_threadsafe(aloop.stop)
    t.join(timeout=5.0)
    assert not t.is_alive()
    aloop.close()


def test_fleet_verb_status_form_always_answers(front):
    plain, elastic = front
    with ServeClient("127.0.0.1", plain, timeout_s=5.0, retries=0) as c:
        rep = c.fleet()
        assert rep["ok"] and rep["fleet"]["elastic"] is False and rep["fleet"]["backends"] == 2
        assert set(rep["fleet"]["fleet"]) == {"127.0.0.1:45800", "127.0.0.1:45801"}
    with ServeClient("127.0.0.1", elastic, timeout_s=5.0, retries=0) as c:
        rep = c.fleet()
        assert rep["ok"] and rep["fleet"] == {"backends": 2, "lifecycle": {}, "elastic": True}


def test_fleet_verb_scaling_form_typed_replies(front):
    plain, elastic = front
    with ServeClient("127.0.0.1", plain, timeout_s=5.0, retries=0) as c:
        rep = c.fleet(backends=3)
        assert not rep["ok"] and rep["reason"] == (
            "fleet_scale_unavailable: router has no lifecycle manager (fleet.elastic)")
    with ServeClient("127.0.0.1", elastic, timeout_s=5.0, retries=0) as c:
        rep = c.fleet(backends=3)
        assert rep["ok"] and rep["fleet"]["backends"] == 3
        rep = c.fleet(backends=9)
        assert not rep["ok"] and rep["reason"] == "fleet_scale_failed: converged to 3 of 9 (see fleet.actions)"
        rep = c.call({"op": "fleet", "backends": "many"}, idempotent=False)
        assert not rep["ok"] and rep["reason"].startswith("bad_request")


@pytest.mark.parametrize("poller_cls", [SocketPoller, JSocketPoller], ids=["port", "jax"])
def test_socket_poller_speaks_fleet_verb(front, poller_cls):
    plain, elastic = front
    p = poller_cls("127.0.0.1", elastic, timeout_s=5.0)
    assert p.fleet()["elastic"] is True
    assert p.fleet(3)["backends"] == 3
    with pytest.raises(RuntimeError, match="fleet_scale_failed"):
        p.fleet(9)
    with pytest.raises(RuntimeError, match="fleet_scale_unavailable"):
        poller_cls("127.0.0.1", plain, timeout_s=5.0).fleet(3)


def test_fleet_poller_fleet_axis(monkeypatch):
    monkeypatch.setattr(Backend, "call", _ok_call([]))
    r = _router(2)
    bare = FleetPoller(r)
    assert bare.fleet() == {"backends": 2, "backends_draining": 0}
    with pytest.raises(RuntimeError, match="fleet_scale_unavailable"):
        bare.fleet(3)
    armed = FleetPoller(r, lifecycle=_FakeLifecycle(r))
    assert armed.fleet(3)["ok"] is True and armed.fleet() == {"backends": 2, "lifecycle": {}}


def test_lifecycle_from_config_wires_the_elastic_fields():
    from qdml_tpu_torch.fleet.frontend import lifecycle_from_config

    r = _router(1)
    assert lifecycle_from_config(tconfig.ExperimentConfig(), r) is None
    cfg = tconfig.from_args(["--fleet.elastic=true", "--fleet.spawn_overrides=--device=cpu, --serve.workers=2,",
                             "--fleet.spawn_timeout_s=30", "--fleet.drain_wait_s=4", "--fleet.dedup_grace_s=0.5"])
    lc = lifecycle_from_config(cfg, r)
    assert lc.spawn_overrides == ("--device=cpu", "--serve.workers=2")
    assert (lc.spawn_timeout_s, lc.drain_wait_s, lc.dedup_grace_s) == (30.0, 4.0, 0.5)
    assert lc.router is r


# ---------------------------------------------------------------------------
# real processes: `cli serve --device=cpu`, `cli route`, `cli fleet-scale`
# ---------------------------------------------------------------------------

TINY = ["--data.n_ant=16", "--model.features=8", "--serve.max_batch=8", "--serve.batching=bucket",
        "--quantum.impl=dense"]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A workdir of seeded tiny checkpoints (HDCE and a QSC at n=4, L=2) and
    one spawned ``cli serve --device=cpu`` on it."""
    from qdml_tpu_torch.models.qsc import build_classifier
    from qdml_tpu_torch.train.checkpoint import save_checkpoint
    from qdml_tpu_torch.train.hdce import build_hdce
    from qdml_tpu_torch.train.torch_interop import qsc_meta_from_state

    root = tmp_path_factory.mktemp("fleet_ws")
    cfg = tconfig.from_args([*TINY, "--quantum.n_qubits=4", "--quantum.n_layers=2", f"--train.workdir={root}"])
    wd = str(root / f"Pn_{cfg.data.pilot_num}" / cfg.name)
    gen = torch.Generator().manual_seed(11)
    save_checkpoint(wd, "hdce_best", {"params": build_hdce(cfg, "cpu", generator=gen).state_dict()}, {})
    qsc = build_classifier(cfg, True, "cpu", generator=gen).state_dict()
    save_checkpoint(wd, "qsc_best", {"params": qsc}, {"quantum": qsc_meta_from_state(qsc)})
    flags = ["--device=cpu", *TINY, f"--train.workdir={root}"]
    env = {"QDML_TORCH_SERVE_BATCHING_TABLE": str(root / "batching.json")}
    b = spawn_backend(flags, env=env, log_path=str(root / "backend0.log"), timeout_s=120.0)
    yield cfg, wd, flags, env, b
    b.terminate()


def _cli(*args, timeout=120):
    return subprocess.run([sys.executable, "-m", "qdml_tpu_torch.cli", *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=timeout)


def _route(args: list[str], env: dict):
    """``cli route`` as a process: (process, its banner)."""
    proc = subprocess.Popen([sys.executable, "-m", "qdml_tpu_torch.cli", "route", *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env={**os.environ, **env})
    lines: list[str] = []
    for line in proc.stdout:
        lines.append(line)
        if line.startswith('{"routing"'):
            return proc, json.loads(line)
    proc.wait(timeout=WAIT)
    raise AssertionError("route printed no banner:\n" + "".join(lines[-30:]))


def test_cpu_fleet_of_real_processes(served):
    from qdml_tpu_torch.serve.engine import ServeEngine

    cfg, wd, flags, env, b0 = served
    assert b0.alive() and b0.banner["compile_cache_after_warmup"] == ZERO
    assert set(b0.banner) >= {"serving", "host_id", "buckets", "replicas", "workers", "compile_cache_after_warmup"}
    facts = verify_warm(b0.host, b0.port, timeout_s=10.0)
    assert facts["warm"] and facts["host_id"] == b0.host_id and facts["compile_cache_after_warmup"] == ZERO
    overrides = ",".join(flags)  # no flag here holds a comma
    route, banner = _route([f"--fleet.backends=127.0.0.1:{b0.port}", "--fleet.port=0", "--fleet.elastic=true",
                            f"--fleet.spawn_overrides={overrides}", "--fleet.spawn_timeout_s=120",
                            "--fleet.poll_interval_s=0.2", *flags], env)
    try:
        assert set(banner) == {"routing", "router_id", "balance", "elastic", "backends", "backends_live"}
        assert banner["elastic"] is True and banner["backends_live"] == 1
        assert banner["backends"] == {b0.host_id: {"addr": f"127.0.0.1:{b0.port}", "state": "closed"}}
        addr = banner["routing"]
        port = int(addr.rsplit(":", 1)[1])
        x = np.random.default_rng(3).standard_normal((12, 16, 8, 2)).astype(np.float32)
        with ServeClient("127.0.0.1", port, timeout_s=30.0) as c:
            reps = [c.request(x[i], rid=f"p-{i}") for i in range(12)]
        assert all(r["ok"] for r in reps)
        twin = ServeEngine.from_workdir(cfg, wd, device="cpu")
        h_ref, pred_ref, _ = twin.offline_forward(x)
        with torch.inference_mode():
            logp = twin.live_vars()[1](torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
        top2 = np.sort(logp, axis=-1)[:, -2:]
        pred = np.array([r["pred"] for r in reps])
        sure = (top2[:, 1] - top2[:, 0]) > 1e-4
        np.testing.assert_array_equal(pred[sure], pred_ref[sure])
        same = pred == pred_ref
        assert same.sum() >= len(x) - 1
        np.testing.assert_allclose(np.asarray([r["h"] for r in reps], np.float32)[same], h_ref[same], rtol=0,
                                   atol=1e-4 * np.abs(h_ref).max() + 1e-5)
        # the status form, then a second backend spawned by the route's lifecycle and retired again
        st = _cli("fleet-scale", f"--addr={addr}")
        assert st.returncode == 0 and json.loads(st.stdout)["fleet"]["elastic"] is True
        grow = _cli("fleet-scale", f"--addr={addr}", "--backends=2", "--timeout-s=120")
        assert grow.returncode == 0, grow.stdout
        rec = json.loads(grow.stdout)["fleet"]
        assert rec["backends"] == 2 and rec["actions"][0]["stage"] == "admitted"
        assert rec["actions"][0]["verified"]["compile_cache_after_warmup"] == ZERO
        with ServeClient("127.0.0.1", port, timeout_s=30.0) as c:
            assert all(c.request(x[i], rid=f"q-{i}")["ok"] for i in range(12))
            per = c.metrics()["metrics"]["per_backend"]
            assert len(per) == 2 and all(v["compile_cache_after_warmup"] == ZERO for v in per.values())
        shrink = _cli("fleet-scale", f"--addr={addr}", "--backends=1", "--timeout-s=120")
        assert shrink.returncode == 0, shrink.stdout
        rec = json.loads(shrink.stdout)["fleet"]
        assert rec["backends"] == 1 and rec["actions"][0]["terminated"] is True and rec["actions"][0]["drained"]
        assert _cli("fleet-scale", "--addr=nowhere").returncode == 2
    finally:
        route.send_signal(signal.SIGINT)
        route.wait(timeout=WAIT)
    assert route.returncode == 0
    # a router without a lifecycle manager refuses the scaling form, typed
    plain, banner = _route([f"--fleet.backends=127.0.0.1:{b0.port}", "--fleet.port=0", *flags], env)
    try:
        rep = _cli("fleet-scale", f"--addr={banner['routing']}", "--backends=2")
        assert rep.returncode == 3 and json.loads(rep.stdout)["reason"].startswith("fleet_scale_unavailable")
    finally:
        plain.send_signal(signal.SIGINT)
        plain.wait(timeout=WAIT)
    assert _cli("fleet-scale", f"--addr={banner['routing']}", "--timeout-s=2").returncode == 3  # nobody listens
    assert b0.alive()  # the boot-time backend is not the lifecycle's to stop


def test_spawn_without_cpu_flag_raises_on_a_cardless_machine(served):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the child would serve on it")
    _, _, flags, env, _ = served
    with pytest.raises(RuntimeError, match="no CUDA device visible") as info:
        spawn_backend([f for f in flags if f != "--device=cpu"], env=env, timeout_s=120.0)
    assert "backend exited before announcing" in str(info.value)
