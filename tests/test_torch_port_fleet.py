"""The port's fleet router (``qdml_tpu_torch.fleet``) against the JAX package's, on the CPU.

Held against ``qdml_tpu.fleet`` (mirroring ``tests/test_fleet.py``):

- ``parse_backends`` on the same specs: the same addresses or the same
  exception;
- the consistent-hash ring: the same points and, for 1000 ids over the same
  backend lists, the same candidate order, also after one add and after one
  removal (backend exchanges stubbed: no socket is opened);
- ``BackendState`` and ``RouterDedup`` step for step on scripted sequences
  with an injected clock: every return, state and summary equal;
- least-queue picks, and the two trace helpers, equal on the same inputs;
- the router over two in-process port servers (``serve_async`` over one
  warmed tiny engine, ``device="cpu"``): answers equal to the engine's
  ``offline_forward`` (1e-4 max|h| + 1e-5 on rows routed alike), exact
  counter sums, dedup across ejection, the typed give-up, socket hardening,
  full and partial swap fan-out, ``FleetPoller``, the port's controller
  ticking over the aggregated fleet, ``scale_fleet`` on the deepest queue;
- JAX's ``ServeClient`` and ``SocketPoller`` against the port's front door
  get replies with the keys they get from JAX's router over JAX backends on
  the same weights, and answers within the same tolerance of them.
"""

import asyncio
import dataclasses
import json
import socket
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.control.loop import SocketPoller as JSocketPoller  # noqa: E402
from qdml_tpu.fleet import frontend as jfrontend  # noqa: E402
from qdml_tpu.fleet import router as jrouter  # noqa: E402
from qdml_tpu.serve.client import ServeClient as JServeClient  # noqa: E402
from qdml_tpu.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from qdml_tpu.serve.server import ServeLoop as JServeLoop  # noqa: E402
from qdml_tpu.serve.server import serve_async as jserve_async  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.control.loop import FleetController  # noqa: E402
from qdml_tpu_torch.control.loop import SocketPoller  # noqa: E402
from qdml_tpu_torch.fleet import (  # noqa: E402
    BackendState,
    FleetPoller,
    FleetRouter,
    RouterDedup,
    parse_backends,
    route_async,
)
from qdml_tpu_torch.fleet import frontend as tfrontend  # noqa: E402
from qdml_tpu_torch.fleet import router as trouter  # noqa: E402
from qdml_tpu_torch.serve.client import ServeClient  # noqa: E402
from qdml_tpu_torch.serve.engine import ServeEngine  # noqa: E402
from qdml_tpu_torch.serve.server import ServeLoop, serve_async  # noqa: E402

HW = (16, 8)
BUCKETS = (4, 8)
WAIT = 30.0  # seconds any future, join or read may take before the test fails
ZERO = {"measure": 0, "table_write": 0, "kernel_build": 0}


class FakeClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self):
        return self.t


def _refused(self, msg, timeout_s=None, idempotent=True):
    raise ConnectionRefusedError("no backend listens here")


# ---------------------------------------------------------------------------
# pure units: endpoint parsing, the ring, the state machines
# ---------------------------------------------------------------------------


def _outcome(fn, *args, **kw):
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # the comparison is of the exception's type
        return ("raise", type(e).__name__)


@pytest.mark.parametrize("spec", ["127.0.0.1:1, h2:8377", "", "missing-port", "h:x", "a:1,,b:2 ,", "[::1]:9"])
def test_parse_backends_matches_jax(spec):
    for default in (("local", 9), None):
        assert _outcome(parse_backends, spec, default=default) == _outcome(
            jrouter.parse_backends, spec, default=default
        ), (spec, default)


def _ring_pair(monkeypatch, n: int, **kw):
    """A port and a JAX router over the same n addresses, never started;
    backend exchanges refuse, so add_backend's identity poll opens no socket."""
    monkeypatch.setattr(trouter.Backend, "call", _refused)
    monkeypatch.setattr(jrouter.Backend, "call", _refused)
    addrs = [("127.0.0.1", 45800 + i) for i in range(n)]
    opts = dict(timeout_s=0.2, retries=0, poll_interval_s=30.0, **kw)
    return FleetRouter(addrs, **opts), jrouter.FleetRouter(addrs, **opts)


def _orders(router, ids) -> list[list[str]]:
    return [[b.addr for b in router._candidates(i)] for i in ids]


IDS = [f"req-{i}" for i in range(700)] + list(range(300))


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_ring_assignment_matches_jax(monkeypatch, n):
    t, j = _ring_pair(monkeypatch, n)
    assert trouter._RING_VNODES == jrouter._RING_VNODES
    assert all(trouter._hash_point(k) == jrouter._hash_point(k) for k in ("a", "127.0.0.1:1#0", "x" * 99))
    assert (t._ring, t._ring_idx) == (j._ring, j._ring_idx)
    before = _orders(t, IDS)
    assert before == _orders(j, IDS)
    # one add: the same arcs move, to the new host only
    bt, bj = t.add_backend("127.0.0.1", 45990), j.add_backend("127.0.0.1", 45990)
    assert bt.addr == bj.addr and (t._ring, t._ring_idx) == (j._ring, j._ring_idx)
    added = _orders(t, IDS)
    assert added == _orders(j, IDS)
    assert all(a[0] == b[0] or a[0] == bt.addr for a, b in zip(added, before))
    # one removal of an original member (drain, then out of the table)
    if n > 1:
        victim = t.backends[0].addr
        t.begin_retire(victim)
        j.begin_retire(victim)
        assert _orders(t, IDS) == _orders(j, IDS)
        assert t.finish_retire(victim)["addr"] == j.finish_retire(victim)["addr"] == victim
        assert (t._ring, t._ring_idx) == (j._ring, j._ring_idx)
        assert _orders(t, IDS) == _orders(j, IDS)
    # and the added host's removal hands its keys back exactly
    t.retire_backend(bt.addr, wait_s=0.1)
    j.retire_backend(bj.addr, wait_s=0.1)
    assert _orders(t, IDS) == _orders(j, IDS)


def _state_script(seed: int, steps: int = 200) -> list[tuple[str, float]]:
    rng = np.random.default_rng(seed)
    ops = rng.choice(["allow", "success", "failure"], size=steps, p=[0.3, 0.4, 0.3])
    return [(str(op), float(rng.exponential(0.4))) for op in ops]


@pytest.mark.parametrize("seed,knobs", [
    (0, dict(eject_failures=2, eject_s=1.0, readmit_probes=2)),
    (1, dict(eject_failures=3, eject_s=0.5, readmit_probes=1)),
    (2, dict(eject_failures=1, eject_s=2.0, readmit_probes=3)),
])
def test_backend_state_step_for_step(seed, knobs):
    tc, jc = FakeClock(), FakeClock()
    t = BackendState(clock=tc, **knobs)
    j = jrouter.BackendState(clock=jc, **knobs)
    kinds = set()
    for i, (op, dt) in enumerate(_state_script(seed)):
        tc.t += dt
        jc.t += dt
        if op == "allow":
            got, want = t.allow(), j.allow()
        elif op == "success":
            got, want = t.record_success(), j.record_success()
        else:
            got, want = t.record_failure(), j.record_failure()
        assert (got, t.state, t.live(), t.summary()) == (want, j.state, j.live(), j.summary()), i
        kinds.add(t.state)
    assert kinds == {"closed", "open", "half_open"}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_router_dedup_step_for_step(seed):
    rng = np.random.default_rng(seed)
    tc, jc = FakeClock(), FakeClock()
    t, j = RouterDedup(5.0, clock=tc), jrouter.RouterDedup(5.0, clock=jc)
    owned: list = []  # (rid, port entry, JAX entry) of the forwards begun fresh
    fresh_seen = reattached = 0
    for i in range(300):
        dt = float(rng.exponential(0.5))
        tc.t += dt
        jc.t += dt
        if owned and rng.random() < 0.45:
            rid, te, je = owned.pop(int(rng.integers(len(owned))))
            rep = [{"id": rid, "ok": True, "h": [float(i)]}, {"id": rid, "ok": False, "reason": "shed"}, None][
                int(rng.choice(3, p=[0.6, 0.25, 0.15]))]
            t.finish(rid, te, rep)
            j.finish(rid, je, rep)
        else:
            rid = f"r{int(rng.integers(12))}"
            (te, tf), (je, jf) = t.begin(rid), j.begin(rid)
            assert tf == jf, i
            if tf:
                owned.append((rid, te, je))
                fresh_seen += 1
            else:
                assert te["ev"].is_set() == je["ev"].is_set() and te["rep"] == je["rep"], i
                reattached += 1
        assert t.hits == j.hits and list(t._entries) == list(j._entries), i
    assert fresh_seen > 20 and reattached > 20


def test_least_queue_picks_match_jax(monkeypatch):
    t, j = _ring_pair(monkeypatch, 5, balance="least_queue")
    rng = np.random.default_rng(7)
    for _ in range(50):
        depths = rng.integers(0, 4, size=5)
        drain = rng.random(5) < 0.2
        for r in (t, j):
            for b, d, dr in zip(r.backends, depths, drain):
                b.queue_depth, b.draining = int(d), bool(dr)
        assert _orders(t, ["any"]) == _orders(j, ["any"])
        got = t._candidates("any")
        assert [b.queue_depth for b in got] == sorted(b.queue_depth for b in got)
    with pytest.raises(ValueError, match="hash|least_queue"):
        FleetRouter([("h", 1)], balance="round_robin")
    with pytest.raises(ValueError, match="at least one backend"):
        FleetRouter([])


def test_trace_helpers_match_jax():
    backend = {"id": "r1", "ok": True, "h": [1.0],
               "trace": {"id": "r1", "phases": [["batch_wait", 1.5], ["compute", 2.0]], "total_ms": 3.5,
                         "detail": {"bucket": 8}}}
    attempts = [{"backend": "b0", "wire_ms": 4.0, "exchange_ms": 4.0, "ok": False, "error": "TimeoutError"},
                {"backend": "b1", "wire_ms": 0.25, "exchange_ms": 3.75, "ok": True, "server_ms": 3.5}]
    for rep in (backend, {"id": "r1", "ok": False, "reason": "no_backend"}, "not a dict"):
        assert trouter._trace_prepend_router(rep, "r1", 0.0012, attempts) == jrouter._trace_prepend_router(
            rep, "r1", 0.0012, attempts)
        assert trouter._trace_dedup_reattach(rep, "r1", 0.004) == jrouter._trace_dedup_reattach(rep, "r1", 0.004)


def test_fleet_config_matches_jax_field_for_field():
    t, j = tconfig.FleetConfig(), jconfig.FleetConfig()
    assert [f.name for f in dataclasses.fields(t)] == [f.name for f in dataclasses.fields(j)]
    for f in dataclasses.fields(t):
        assert getattr(t, f.name) == getattr(j, f.name), f.name
        assert f.type == next(g.type for g in dataclasses.fields(j) if g.name == f.name), f.name
    assert tconfig.ExperimentConfig().fleet == t
    flags = ["--fleet.backends=127.0.0.1:1,127.0.0.1:2", "--fleet.balance=least_queue", "--fleet.eject_s=0.5",
             "--fleet.elastic=true", "--fleet.spawn_overrides=--device=cpu,--serve.workers=2",
             "--fleet.port=0", "--fleet.dedup_grace_s=1.5", "--fleet.readmit_probes=4"]
    got, want = tconfig.from_args(flags).fleet, jconfig.from_args(flags).fleet
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.elastic is True and got.port == 0 and got.balance == "least_queue"
    # router_from_config builds JAX's router from the same fields
    cfg, jcfg = tconfig.from_args(flags), jconfig.from_args(flags)
    tr, jr = tfrontend.router_from_config(cfg), jfrontend.router_from_config(jcfg)
    for attr in ("balance", "failover", "poll_interval_s", "trace_sample", "_dedup_wait_s", "_backend_opts"):
        assert getattr(tr, attr) == getattr(jr, attr), attr
    assert [b.addr for b in tr.backends] == [b.addr for b in jr.backends]
    assert tr.dedup.ttl_s == jr.dedup.ttl_s
    empty = tconfig.from_args(["--serve.port=9123"])
    assert [b.addr for b in tfrontend.router_from_config(empty).backends] == ["127.0.0.1:9123"]


# ---------------------------------------------------------------------------
# two live socket backends over one warmed port engine
# ---------------------------------------------------------------------------


def _tcfg(**serve_kw):
    serve = dict(max_batch=8, buckets=BUCKETS, max_wait_ms=1.0, max_queue=32, batching="bucket")
    serve.update(serve_kw)
    return tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16, data_len=64),
        model=tconfig.ModelConfig(features=8),
        quantum=tconfig.QuantumConfig(n_qubits=4, n_layers=2, impl="dense"),
        train=tconfig.TrainConfig(batch_size=16, n_epochs=1),
        serve=tconfig.ServeConfig(**serve),
    )


def _jcfg():
    j = jconfig.ExperimentConfig()
    return dataclasses.replace(
        j,
        data=dataclasses.replace(j.data, n_ant=16, data_len=64),
        model=dataclasses.replace(j.model, features=8),
        quantum=dataclasses.replace(j.quantum, n_qubits=4, n_layers=2, impl="dense"),
        train=dataclasses.replace(j.train, batch_size=16, n_epochs=1),
        serve=dataclasses.replace(j.serve, max_batch=8, buckets=BUCKETS, max_wait_ms=1.0, max_queue=32,
                                  batching="bucket"),
    )


def _randomize(tree, rng):
    def walk(t, name=""):
        if hasattr(t, "items"):
            return {k: walk(v, k) for k, v in t.items()}
        a = np.asarray(t)
        if name in ("var", "scale"):
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if name == "kernel":
            fan_in = np.prod(a.shape[-4:-1]) if a.ndim >= 4 else a.shape[-2]
            return (rng.standard_normal(a.shape) / np.sqrt(fan_in)).astype(np.float32)
        return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)

    return walk(tree)


@pytest.fixture(scope="module")
def weights():
    """Seeded Flax weights of the tiny config, and the port's state dicts of them."""
    jeng = JServeEngine(_jcfg(), {}, {}, quantum=True)
    rng = np.random.default_rng(0)
    hdce_vars = _randomize(jax.device_get(jeng.hdce.init(jax.random.PRNGKey(0), jnp.zeros((3, 1, *HW, 2)))), rng)
    clf_vars = {"params": _randomize(
        jax.device_get(jeng.clf.init(jax.random.PRNGKey(1), jnp.zeros((1, *HW, 2))))["params"], rng)}
    sds = interop.hdce_state_dict_from_flax(hdce_vars), interop.qsc_state_dict_from_flax(clf_vars["params"])
    return hdce_vars, clf_vars, sds


@pytest.fixture(scope="module")
def warmed(weights):
    _, _, (hdce_sd, clf_sd) = weights
    engine = ServeEngine(_tcfg(), hdce_sd, clf_sd, quantum=True, device="cpu")
    engine.warmup()
    x = np.random.default_rng(5).standard_normal((32, *HW, 2)).astype(np.float32)
    return engine, x


class _SwapCounter:
    """Per-backend swap_fn: counts calls, optionally fails typed (the
    corrupt-checkpoint shape); the fan-out semantics are under test."""

    def __init__(self, name: str, fail: bool = False):
        self.name = name
        self.fail = fail
        self.calls = 0

    def __call__(self, tags=None):
        self.calls += 1
        if self.fail:
            raise ValueError(f"checkpoint on {self.name} failed to restore")
        return {"epoch": self.calls, "tags": tags, "work": dict(ZERO)}


class _EventLoop:
    """An asyncio loop on a thread; :meth:`stop` cancels every task on it."""

    def __init__(self):
        import threading

        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()

    def start(self, coro_fn, *args, **kw) -> int:
        ready: Future = Future()
        asyncio.run_coroutine_threadsafe(coro_fn(*args, ready, **kw), self.loop)
        return ready.result(timeout=WAIT)

    def stop(self) -> None:
        async def cancel_all():
            tasks = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            asyncio.run_coroutine_threadsafe(cancel_all(), self.loop).result(timeout=WAIT)
        finally:
            self.loop.call_soon_threadsafe(self.loop.stop)
            self.thread.join(timeout=10.0)
            assert not self.thread.is_alive()
            self.loop.close()


def _backends(el: _EventLoop, loop_cls, serve_fn, engine, prefix: str):
    loops, ports, swaps = [], [], []
    for i in range(2):
        lp = loop_cls(engine, name=f"{prefix}-{i}-loop").start()
        swap = _SwapCounter(f"{prefix}-{i}")
        ports.append(el.start(serve_fn, lp, "127.0.0.1", 0, swap_fn=swap, conn_timeout_s=30.0, dedup_ttl_s=5.0,
                              host_id=f"{prefix}-{i}"))
        loops.append(lp)
        swaps.append(swap)
    return loops, ports, swaps


ROUTER_OPTS = dict(timeout_s=5.0, retries=0, eject_failures=2, eject_s=0.2, readmit_probes=1,
                   poll_interval_s=30.0, failover=2, dedup_ttl_s=5.0)  # the poll driven by hand


@pytest.fixture()
def fleet(warmed):
    """Two socket backends (a ServeLoop each over the shared warmed engine)
    and a started FleetRouter over both."""
    engine, x = warmed
    el = _EventLoop()
    loops, ports, swaps = _backends(el, ServeLoop, serve_async, engine, "backend")
    router = FleetRouter([("127.0.0.1", p) for p in ports], **ROUTER_OPTS).start()
    yield engine, x, router, loops, ports, swaps, el
    router.stop()
    el.stop()
    for lp in loops:
        lp.stop()


def _completed(loops) -> int:
    return sum(lp.merged_metrics().completed for lp in loops)


def _eject(backend) -> None:
    while backend.state.live():
        backend.state.record_failure()


def _close_to_engine(engine, x, reps) -> int:
    """Served ``h`` within 1e-4 max|h| + 1e-5 of the engine's offline forward
    on the rows routed alike; the routed scenario equal wherever the CPU's
    top-two margin exceeds 1e-4. Returns the rows routed alike."""
    h_ref, pred_ref, _ = engine.offline_forward(x)
    _, clf = engine.live_vars()
    with torch.inference_mode():
        logp = clf(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()).numpy()
    h = np.asarray([r["h"] for r in reps], np.float32)
    pred = np.array([r["pred"] for r in reps])
    top2 = np.sort(logp, axis=-1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > 1e-4
    np.testing.assert_array_equal(pred[sure], pred_ref[sure])
    same = pred == pred_ref
    np.testing.assert_allclose(h[same], h_ref[same], rtol=0, atol=1e-4 * np.abs(h_ref).max() + 1e-5)
    return int(same.sum())


def test_hash_affinity_stable_and_spreading(fleet):
    *_, router, _loops, _ports, _swaps, _ = fleet
    first = [router._candidates(f"rid-{i}")[0].addr for i in range(64)]
    assert first == [router._candidates(f"rid-{i}")[0].addr for i in range(64)]
    assert len(set(first)) == 2


def test_router_serves_and_aggregates(fleet):
    engine, x, router, loops, _ports, _swaps, _ = fleet
    before = _completed(loops)
    reps = [router.request({"id": f"agg-{i}", "x": x[i].tolist()}) for i in range(16)]
    assert all(r["ok"] for r in reps) and [r["id"] for r in reps] == [f"agg-{i}" for i in range(16)]
    assert _close_to_engine(engine, x[:16], reps) >= 15
    assert _completed(loops) == before + 16
    router.poll_once()
    assert {b.host_id for b in router.backends} == {"backend-0", "backend-1"}
    m = router.live_metrics()
    assert m["fleet"] is True and m["backends_polled"] == 2
    assert m["completed"] == _completed(loops)
    assert set(m["per_backend"]) == {"backend-0", "backend-1"}
    assert sum(v["completed"] for v in m["per_backend"].values()) == m["completed"]
    assert sum(v["n"] for v in (m["per_scenario"] or {}).values()) == m["completed"]
    # the request-path work ledger sums per key across hosts: all zero
    assert m["compile_cache_after_warmup"] == ZERO and engine.request_path_work() == ZERO
    assert m["replicas"] == 2 and m["swap_epoch"] == 0 and m["buckets"] == list(BUCKETS)
    rt = m["router"]
    assert rt["backends"] == 2 and rt["backends_live"] == 2
    assert rt["forwarded"] >= 16 and rt["wire_latency_ms"]["n"] >= 16
    assert rt["wire_latency_ms"]["sum_ms"] > 0


def test_router_health_is_cheap_and_identified(fleet):
    *_, router, _loops, ports, _swaps, _ = fleet
    router.poll_once()
    h = router.health()
    assert h["fleet"] is True and h["backends"] == 2 and h["backends_live"] == 2
    assert set(h["per_backend"]) == {"backend-0", "backend-1"}
    row = h["per_backend"]["backend-0"]
    assert row["state"] == "closed" and row["listen"] == f"127.0.0.1:{ports[0]}" and row["poll_ok"]


def test_dedup_holds_across_ejection_and_failover(fleet):
    """A same-id retry through the front door after its backend was ejected
    lands exactly one dispatch fleet-wide: the router's dedup re-attaches it."""
    engine, x, router, loops, _ports, _swaps, el = fleet
    front = el.start(route_async, router, "127.0.0.1", 0)
    with ServeClient("127.0.0.1", front, timeout_s=10.0, retries=1, backoff_s=0.01, seed=0) as client:
        rid = "fleet-dup-1"
        before = _completed(loops)
        rep1 = client.request(x[0], rid=rid)
        assert rep1["ok"] is True
        served_by = router._candidates(rid)[0]
        _eject(served_by)
        assert not served_by.state.live()
        rep2 = client.request(x[0], rid=rid)
        assert rep2["ok"] is True and rep2["h"] == rep1["h"] and rep2["pred"] == rep1["pred"]
        assert _completed(loops) == before + 1
        assert router.dedup.hits >= 1
        rep3 = client.request(x[1], rid="fleet-dup-2")  # routes around the ejected host
        assert rep3["ok"] is True and _completed(loops) == before + 2
        time.sleep(0.25)
        router.poll_once()
        assert served_by.state.live()
        assert router.router_summary()["readmissions"] >= 1


def test_ejected_fleet_gives_up_typed(fleet):
    *_, router, _loops, _ports, _swaps, _ = fleet
    for b in router.backends:
        _eject(b)
    rep = router.request({"id": "nobody-home", "x": [[0.0]]})
    assert rep == {"id": "nobody-home", "ok": False, "reason": "no_backend: all backends ejected"}
    assert router.router_summary()["no_backend"] == 1
    time.sleep(0.25)
    router.poll_once()  # healthy backends: probed back in
    assert len(router.live_backends()) == 2


def test_reaped_pooled_connections_are_replaced_not_failed(warmed):
    """A backend reaps a connection idle past ``serve.conn_timeout_s``, so
    the router's pooled clients to it come to hold closed sockets. Each is
    replaced before its next send: the healthy backend sees no transport
    failure, the router no failover, and nothing is ejected, even at
    ``eject_failures=1``."""
    engine, x = warmed
    el = _EventLoop()
    lp = ServeLoop(engine, name="reaping-loop").start()
    router = None
    try:
        port = el.start(serve_async, lp, "127.0.0.1", 0, swap_fn=_SwapCounter("reaping"), conn_timeout_s=0.3,
                        dedup_ttl_s=5.0, host_id="reaping")
        router = FleetRouter([("127.0.0.1", port)], **{**ROUTER_OPTS, "eject_failures": 1}).start()
        (b,) = router.backends
        clients = [b._borrow() for _ in range(4)]
        assert all(c.health()["ok"] for c in clients)
        for c in clients:
            b._restore(c)
        time.sleep(1.0)  # every pooled connection reaped
        reps = [router.request({"id": f"reaped-{i}", "x": x[i].tolist()}) for i in range(4)]
        assert all(r["ok"] for r in reps), reps
        summary = router.router_summary()
        assert summary["failovers"] == 0 and summary["ejections"] == 0 and summary["no_backend"] == 0
        assert sum(c.reconnects for c in clients) >= 1 and all(c.retries_used == 0 for c in clients)
    finally:
        if router is not None:
            router.stop()
        el.stop()
        lp.stop()


def test_front_socket_hardening(fleet):
    """Garbage gets a typed reply and the connection survives; a non-object
    line is a typed bad_request; an oversized line gets bad_request and the
    close; an idle connection is reaped with a typed idle_timeout."""
    _engine, x, router, _loops, _ports, _swaps, el = fleet
    front = el.start(route_async, router, "127.0.0.1", 0, conn_timeout_s=30.0, max_line_bytes=1 << 16)
    with socket.create_connection(("127.0.0.1", front), timeout=10.0) as sk:
        fh = sk.makefile("rw")
        sk.sendall(b"NOT JSON {{{\n")
        assert json.loads(fh.readline()) == {"ok": False, "reason": "bad_json"}
        fh.write(json.dumps({"id": "after-garbage", "x": x[0].tolist()}) + "\n")
        fh.flush()
        assert json.loads(fh.readline())["ok"] is True
        fh.write(json.dumps([1, 2, 3]) + "\n")
        fh.flush()
        rep = json.loads(fh.readline())
        assert rep["ok"] is False and rep["reason"].startswith("bad_request")
        fh.write(json.dumps({"op": "scale"}) + "\n")  # no replicas: typed
        fh.flush()
        assert json.loads(fh.readline())["reason"].startswith("bad_request")
        fh.write(json.dumps({"op": "events", "cursor": 5}) + "\n")
        fh.flush()
        assert json.loads(fh.readline())["reason"].startswith("bad_request")
    with socket.create_connection(("127.0.0.1", front), timeout=10.0) as sk:
        fh = sk.makefile("rw")
        sk.sendall(b'{"id": 1, "x": "' + b"a" * 70000 + b'"}\n')
        rep = json.loads(fh.readline())
        assert rep["ok"] is False and "max_line_bytes" in rep["reason"]
    idle = el.start(route_async, router, "127.0.0.1", 0, conn_timeout_s=0.2)
    with socket.create_connection(("127.0.0.1", idle), timeout=10.0) as sk:
        assert json.loads(sk.makefile("r").readline()) == {"ok": False, "reason": "idle_timeout"}


def test_swap_fanout_all_and_partial(fleet):
    *_, router, _loops, _ports, swaps, _ = fleet
    router.poll_once()
    rec = router.swap_fanout({"hdce": "hdce_last"})
    assert rec["ok"] is True and rec["partial"] is False
    assert rec["ok_count"] == 2 and rec["fanned_to"] == 2 and rec["skipped"] == []
    assert swaps[0].calls == 1 and swaps[1].calls == 1
    assert set(rec["backends"]) == {"backend-0", "backend-1"}
    assert all(r["ok"] and r["swap"]["tags"] == {"hdce": "hdce_last"} for r in rec["backends"].values())
    swaps[1].fail = True
    rec = router.swap_fanout(None)
    assert rec["ok"] is False and rec["partial"] is True and rec["ok_count"] == 1
    assert "swap_failed" in rec["backends"]["backend-1"]["reason"]
    swaps[1].fail = False
    _eject(router.backends[1])
    rec = router.swap_fanout(None)
    assert rec["ok"] is True and rec["partial"] is True
    assert rec["skipped"] == ["backend-1"] and rec["fanned_to"] == 1
    time.sleep(0.25)
    router.poll_once()
    assert router.backends[1].state.live()
    for b in router.backends:
        _eject(b)
    with pytest.raises(ConnectionError, match="no live backends"):
        router.swap_fanout(None)


def test_fleet_poller_swap_raises_on_live_failure(fleet):
    *_, router, _loops, _ports, swaps, _ = fleet
    poller = FleetPoller(router)
    swaps[0].fail = True
    with pytest.raises(RuntimeError, match="fleet swap partial"):
        poller.swap({"hdce": "hdce_last"})
    swaps[0].fail = False
    assert poller.swap({"hdce": "hdce_last"})["ok"] is True
    assert poller.metrics()["fleet"] is True and poller.health()["backends"] == 2
    ev = poller.events()
    assert ev["fleet"] is True and set(ev["cursor"]) == {"router", "backend-0", "backend-1"}
    assert any(e["kind"] == "router_swap" and e["source"] == "router" for e in ev["events"])
    assert poller.fleet() == {"backends": 2, "backends_draining": 0}
    assert isinstance(FleetPoller.remote("127.0.0.1", 1), SocketPoller)


def test_controller_ticks_over_aggregated_fleet(fleet, tmp_path):
    """The port's FleetController windows the router's summed counters as it
    windows one host's; drift on the parity feed -> a dry-run adapt."""
    _engine, x, router, _loops, _ports, _swaps, _ = fleet
    cfg = dataclasses.replace(
        _tcfg(), control=tconfig.ControlConfig(dry_run=True, min_window=4, autoscale=False)
    )
    ctrl = FleetController(cfg, str(tmp_path), FleetPoller(router), drift_step_hint=1, device="cpu")
    for i in range(10):
        assert router.request({"id": f"tick-a-{i}", "x": x[0].tolist()})["ok"]
    assert ctrl.tick()["tick"] == 1
    for i in range(10):
        assert router.request({"id": f"tick-b-{i}", "x": x[0].tolist()})["ok"]
    assert ctrl.tick()["tick"] == 2
    for v in [-12.0] * 6 + [-6.0] * 8:
        ctrl.observe_parity(0, v)
    assert any(e.get("action") == "adapt" for e in ctrl.tick()["events"])


def test_scale_fleet_targets_deepest_queue_host(fleet, monkeypatch):
    """The replica axis: grow the deepest-queue host, shrink the shallowest,
    never below 1 per host, on a local snapshot of the polled counts (the
    backend exchange stubbed at Backend.call, as JAX's test does)."""
    *_, router, _loops, _ports, _swaps, _ = fleet
    monkeypatch.setattr(router, "poll_once", lambda: None)
    b0, b1 = router.backends
    b0.replicas, b0.queue_depth = 1, 9
    b1.replicas, b1.queue_depth = 1, 0
    calls = []

    def fake_call(self, msg, **kw):
        calls.append((self.host_id, msg["replicas"]))
        return {"ok": True, "scale": {"replicas": msg["replicas"]}}

    monkeypatch.setattr(type(b0), "call", fake_call)
    rec = router.scale_fleet(4)
    assert rec["replicas_before"] == 2 and rec["replicas"] == 4
    assert calls == [(b0.host_id, 2), (b0.host_id, 3)]
    assert rec["actions"][-1] == {"backend": b0.host_id, "replicas": 3}
    assert b0.replicas == 1 and b1.replicas == 1
    calls.clear()
    b0.replicas = 3
    rec = router.scale_fleet(2)
    assert rec["replicas"] == 2 and calls == [(b0.host_id, 2), (b0.host_id, 1)]
    calls.clear()
    b0.replicas = 1
    assert router.scale_fleet(1) == {"replicas_before": 2, "replicas": 2, "actions": []}


def test_scale_verb_reaches_a_real_replica_pool(warmed):
    """``{"op": "scale"}`` through the front door resizes a backend's
    ReplicaPool (the ServeLoop backends above have no scale verb)."""
    from qdml_tpu_torch.serve.server import ReplicaPool

    engine, x = warmed
    el = _EventLoop()
    pool = ReplicaPool(engine, replicas=1).start()
    try:
        port = el.start(serve_async, pool, "127.0.0.1", 0, host_id="pool-0")
        router = FleetRouter([("127.0.0.1", port)], **ROUTER_OPTS).start()
        front = el.start(route_async, router, "127.0.0.1", 0)
        with ServeClient("127.0.0.1", front, timeout_s=10.0) as c:
            rep = c.scale(3)
            assert rep["ok"] and rep["scale"] == {"replicas_before": 1, "replicas": 3, "actions": [
                {"backend": "pool-0", "replicas": 2}, {"backend": "pool-0", "replicas": 3}]}
            assert pool.n_replicas == 3
            assert c.request(x[0], rid="after-scale")["ok"]
        router.stop()
    finally:
        el.stop()
        pool.stop()


# ---------------------------------------------------------------------------
# JAX's client and poller against the port's front door
# ---------------------------------------------------------------------------


def _exchanges(front: int, x) -> dict:
    """The same exchanges with JAX's client and SocketPoller against a front door."""
    out = {}
    with JServeClient("127.0.0.1", front, timeout_s=10.0, retries=1, seed=0) as c:
        out["infer"] = [c.request(x[i], rid=f"j-{i}") for i in range(12)]
        out["retry"] = c.request(x[0], rid="j-0")
        out["health"] = c.health()
        out["metrics"] = c.metrics()
        out["events"] = c.events(limit=64)
        out["swap"] = c.swap(tags={"hdce": "hdce_last"})
        out["fleet"] = c.fleet()
        out["fleet_scale"] = c.fleet(backends=3)
    p = JSocketPoller("127.0.0.1", front, timeout_s=10.0)
    out["poller"] = {"health": p.health(), "metrics": p.metrics(), "events": p.events(), "fleet": p.fleet()}
    with pytest.raises(RuntimeError, match="fleet_scale_unavailable"):
        p.fleet(2)
    return out


# maps keyed by host id, and the request-path ledger (the port counts
# measurements, table writes and kernel builds, JAX its compile cache): their
# types are compared, not their keys
OPAQUE = ("per_backend", "backends", "cursor", "fleet", "compile_cache_after_warmup")


def _keys(obj, depth=2):
    if not isinstance(obj, dict) or depth == 0:
        return type(obj).__name__
    return {k: type(v).__name__ if k in OPAQUE else _keys(v, depth - 1) for k, v in obj.items()}


def test_jax_client_and_poller_get_jax_routers_replies(weights, warmed):
    hdce_vars, clf_vars, _ = weights
    engine, x = warmed
    jeng = JServeEngine(_jcfg(), hdce_vars, clf_vars, quantum=True)
    jeng.warmup()
    el = _EventLoop()
    jloops = tloops = []
    try:
        jloops, jports, _ = _backends(el, JServeLoop, jserve_async, jeng, "jax")
        jr = jrouter.FleetRouter([("127.0.0.1", p) for p in jports], **ROUTER_OPTS).start()
        want = _exchanges(el.start(jfrontend.route_async, jr, "127.0.0.1", 0), x)
        tloops, tports, _ = _backends(el, ServeLoop, serve_async, engine, "port")
        tr = FleetRouter([("127.0.0.1", p) for p in tports], **ROUTER_OPTS).start()
        got = _exchanges(el.start(route_async, tr, "127.0.0.1", 0), x)
        jr.stop()
        tr.stop()
    finally:
        el.stop()
        for lp in [*jloops, *tloops]:
            lp.stop()
    for k in ("health", "metrics", "events", "swap", "fleet", "fleet_scale", "retry"):
        assert _keys(got[k]) == _keys(want[k]), k
    assert [_keys(r) for r in got["infer"]] == [_keys(r) for r in want["infer"]]
    assert _keys(got["poller"], 3) == _keys(want["poller"], 3)
    assert got["poller"]["metrics"]["compile_cache_after_warmup"] == ZERO
    assert got["fleet_scale"]["reason"] == want["fleet_scale"]["reason"]
    assert got["fleet"]["fleet"]["elastic"] is want["fleet"]["fleet"]["elastic"] is False
    assert set(got["metrics"]["metrics"]["per_backend"]) == {"port-0", "port-1"}
    assert got["retry"]["h"] == got["infer"][0]["h"] and got["swap"]["swap"]["ok_count"] == 2
    # the port's answers through its router against JAX's through JAX's
    h_j = np.asarray([r["h"] for r in want["infer"]], np.float32)
    pred_j = np.array([r["pred"] for r in want["infer"]])
    h_t = np.asarray([r["h"] for r in got["infer"]], np.float32)
    pred_t = np.array([r["pred"] for r in got["infer"]])
    same = pred_t == pred_j
    assert same.sum() >= len(same) - 1
    np.testing.assert_allclose(h_t[same], h_j[same], rtol=0, atol=1e-4 * np.abs(h_j).max() + 1e-5)
