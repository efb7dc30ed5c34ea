"""The port's fault tolerance and wire protocol against the JAX package's, on the CPU.

Held against ``qdml_tpu.serve``, on the same inputs and seeds: the circuit
breaker's transitions, ``RestartPolicy``'s backoff delays, ``FaultPlan``'s
schedules and the dedup window. Then the port's own pool and server: an
injected ``worker_exception`` resolves its batch's futures with the failure
and the supervisor restarts the replica; traffic, a hot-swap and an
injected crash together strand no future and do no request-path work;
``run_server`` answers the port's ``ServeClient`` (a retried id dispatches
once, ``health``, ``metrics``, ``events``, ``scale``, a ``swap`` to a second
tag whose weights the answers then follow); and JAX's ``ServeClient``,
unchanged, gets the same reply keys and types from the port's server as
from JAX's. Small size: features 8, n_ant 16, buckets (4, 8), the classical
classifier, the plain kernels. Every socket read, future and join has its
own timeout, servers bind port 0, threads are daemons stopped in a
``finally``.
"""

import asyncio
import dataclasses
import json
import random
import socket
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small shapes: leave the cores to the suite's other workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from qdml_tpu import config as jconfig  # noqa: E402
from qdml_tpu.serve import breaker as jbreaker  # noqa: E402
from qdml_tpu.serve import faults as jfaults  # noqa: E402
from qdml_tpu.serve import server as jserver  # noqa: E402
from qdml_tpu.serve.client import ServeClient as JServeClient  # noqa: E402
from qdml_tpu.serve.engine import ServeEngine as JServeEngine  # noqa: E402
from qdml_tpu_torch import config as tconfig  # noqa: E402
from qdml_tpu_torch import interop  # noqa: E402
from qdml_tpu_torch.serve import batching_autotune  # noqa: E402
from qdml_tpu_torch.serve import breaker as tbreaker  # noqa: E402
from qdml_tpu_torch.serve import faults as tfaults  # noqa: E402
from qdml_tpu_torch.serve import server as tserver  # noqa: E402
from qdml_tpu_torch.serve.client import ServeClient, ServeClientError  # noqa: E402
from qdml_tpu_torch.serve.engine import ServeEngine  # noqa: E402
from qdml_tpu_torch.serve.loadgen import run_loadgen_socket  # noqa: E402
from qdml_tpu_torch.serve.types import Overloaded, Prediction  # noqa: E402
from qdml_tpu_torch.telemetry import events  # noqa: E402
from qdml_tpu_torch.train.checkpoint import save_checkpoint  # noqa: E402

HW = (16, 8)
WAIT = 30.0  # seconds any future, read or join may take before the test fails
ZERO_WORK = {"measure": 0, "table_write": 0, "kernel_build": 0}


@pytest.fixture(autouse=True)
def _isolated_tables(tmp_path, monkeypatch):
    monkeypatch.setenv(batching_autotune.ENV_TABLE, str(tmp_path / "batching.json"))
    batching_autotune.invalidate_cache()
    yield
    batching_autotune.invalidate_cache()


# ---------------------------------------------------------------------------
# host logic, step for step against JAX's
# ---------------------------------------------------------------------------


def _breaker_trace(mod, seed: int) -> list:
    t = {"now": 0.0}
    br = mod.CircuitBreaker(max_queue=10, high_frac=0.8, low_frac=0.3, open_s=0.5, probes=2,
                            clock=lambda: t["now"])
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(400):
        t["now"] += float(rng.uniform(0, 0.1))
        depth = int(rng.integers(0, 11))
        out.append((br.allow(depth), br.state))
    out.append(br.summary())
    return out


def test_breaker_transitions_match_jax():
    for seed in range(4):
        got, want = _breaker_trace(tbreaker, seed), _breaker_trace(jbreaker, seed)
        assert got == want
        assert {s for _, s in got[:-1]} == {"closed", "open", "half_open"}
    with pytest.raises(ValueError, match="low_frac"):
        tbreaker.CircuitBreaker(max_queue=10, high_frac=0.2, low_frac=0.5)


def test_restart_policy_delays_match_jax():
    for seed in (0, 1, 2026):
        kw = dict(base_s=0.05, budget=3, jitter=0.5, max_s=2.0, reset_after_s=30.0)
        mine, theirs = tfaults.RestartPolicy(**kw), jfaults.RestartPolicy(**kw)
        r1, r2 = random.Random(seed), random.Random(seed)
        got = [mine.delay(k, r1) for k in range(8)]
        assert got == [theirs.delay(k, r2) for k in range(8)]
        assert got[7] >= 2.0 and all(d >= 0.05 * 2 ** k for k, d in enumerate(got[:5]))
        assert [mine.exhausted(k) for k in range(5)] == [theirs.exhausted(k) for k in range(5)]
        assert mine.stale(31.0) and not mine.stale(29.0)
    # the plan's seeded rng is the same stream as JAX's
    assert tfaults.FaultPlan(seed=9).rng.random() == jfaults.FaultPlan(seed=9).rng.random()


def _plan_trace(mod) -> list:
    plan = mod.FaultPlan([
        mod.FaultSpec("worker_exception", at=2, times=2),
        mod.FaultSpec("replica_crash", at=1, replica="serve-replica-1"),
        mod.FaultSpec("socket_drop", at=3, times=2),
    ], seed=4)
    out = []
    for step in range(6):
        for replica in ("serve-replica-0", "serve-replica-1"):
            for site in ("check_worker_loop", "check_worker_batch"):
                try:
                    getattr(plan, site)(replica)
                    out.append(None)
                except Exception as e:
                    out.append((type(e).__name__, e.kind, e.site, e.seq, str(e)))
    out.append([plan.client_fault_at("socket_drop", i) for i in range(7)])
    out.append(plan.fired)
    out.append(plan.describe())
    return out


def test_fault_plan_schedules_match_jax():
    got, want = _plan_trace(tfaults), _plan_trace(jfaults)
    assert got == want
    assert sum(1 for e in got[:-3] if e is not None) == 5
    assert tfaults.FAULT_CLASSES == jfaults.FAULT_CLASSES
    with pytest.raises(ValueError, match="unknown fault kind"):
        tfaults.FaultSpec("meteor")


def _dedup_trace(mod, shed_cls, pred_cls) -> list:
    t = {"now": 0.0}
    cache = mod.DedupCache(ttl_s=1.0, clock=lambda: t["now"])
    futures = []
    out = []

    def submit():
        f = Future()
        futures.append(f)
        return f

    for step, (rid, dt, resolve) in enumerate([
        ("a", 0.0, "pred"), ("a", 0.5, None), ("b", 0.0, "shed"), ("b", 0.1, None),
        ("c", 0.0, "error"), ("c", 0.1, None), ("a", 0.6, None), ("d", 0.0, None), ("d", 0.9, None),
    ]):
        t["now"] += dt
        fut, hit = cache.get_or_submit(rid, submit)
        out.append((rid, hit, futures.index(fut)))
        if resolve == "pred":
            fut.set_result(pred_cls(rid=rid, h=np.zeros(2), scenario=0, latency_s=0.0, bucket=1, batch_n=1))
        elif resolve == "shed":
            fut.set_result(shed_cls(rid, "breaker_open"))
        elif resolve == "error":
            fut.set_exception(RuntimeError("engine died"))
    out.append(cache.hits)
    return out


def test_dedup_window_matches_jax():
    from qdml_tpu.serve.types import Overloaded as JOverloaded
    from qdml_tpu.serve.types import Prediction as JPrediction

    got = _dedup_trace(tserver, Overloaded, Prediction)
    assert got == _dedup_trace(jserver, JOverloaded, JPrediction)
    # served ids are pinned for the TTL, sheds and failures are forgotten,
    # and an entry past the TTL dispatches anew
    assert got[1] == ("a", True, 0) and got[3] == ("b", False, 2) and got[5] == ("c", False, 4)
    assert got[6] == ("a", False, 5) and got[8] == ("d", True, 6) and got[-1] == 2


# ---------------------------------------------------------------------------
# the port's pool under faults
# ---------------------------------------------------------------------------


def _tcfg(**serve):
    cfg = tconfig.ExperimentConfig(
        data=tconfig.DataConfig(n_ant=16),
        model=tconfig.ModelConfig(features=8),
        serve=tconfig.ServeConfig(max_batch=8, buckets=(4, 8), max_wait_ms=1.0, max_queue=64,
                                  batching="bucket"),
    )
    return dataclasses.replace(cfg, serve=dataclasses.replace(cfg.serve, **serve))


def _jcfg(**serve):
    j = jconfig.ExperimentConfig()
    return dataclasses.replace(
        j,
        data=dataclasses.replace(j.data, n_ant=16),
        model=dataclasses.replace(j.model, features=8),
        serve=dataclasses.replace(j.serve, max_batch=8, buckets=(4, 8), max_wait_ms=1.0, max_queue=64,
                                  batching="bucket", **serve),
    )


def _flax(seed):
    jeng = JServeEngine(_jcfg(), {}, {}, quantum=False)
    rng = np.random.default_rng(seed)

    def rand(tree):
        if hasattr(tree, "items"):
            return {k: rand(v) for k, v in tree.items()}
        a = np.asarray(tree)
        return (0.2 * rng.standard_normal(a.shape) + (1.0 if a.ndim == 1 and a.size > 3 else 0.0)).astype(
            np.float32)

    hdce = rand(jax.device_get(jeng.hdce.init(jax.random.PRNGKey(seed), jnp.zeros((3, 1, *HW, 2)))))
    hdce["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, hdce["batch_stats"])
    clf = {"params": rand(jax.device_get(jeng.clf.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, *HW, 2))))[
        "params"])}
    return hdce, clf


def _port(hdce, clf):
    return interop.hdce_state_dict_from_flax(hdce), interop.sc_state_dict_from_flax(clf["params"])


@pytest.fixture(scope="module")
def weights():
    return _flax(0), _flax(7)


@pytest.fixture
def engine(weights):
    eng = ServeEngine(_tcfg(), *_port(*weights[0]), device="cpu")
    eng.warmup()
    return eng


def _x(n, seed=3):
    return np.random.default_rng(seed).standard_normal((n, *HW, 2)).astype(np.float32)


def _fast_supervision(pool, budget=3):
    pool._sup_interval_s = 0.01
    pool._policy = tfaults.RestartPolicy(base_s=0.002, budget=budget, max_s=0.05)
    return pool


def _wait_for(cond, timeout=WAIT):
    end = time.monotonic() + timeout
    while not cond() and time.monotonic() < end:
        time.sleep(0.01)
    return cond()


def test_worker_exception_resolves_its_batch_and_the_supervisor_restarts(engine):
    plan = tfaults.FaultPlan([tfaults.FaultSpec("worker_exception", at=0)])
    pool = _fast_supervision(tserver.ReplicaPool(engine, replicas=1, faults=plan)).start()
    bus = events.EventBus()
    events.install_bus(bus)
    try:
        with pytest.raises(tfaults.FaultInjected):
            pool.submit(_x(1)[0], rid=0).result(timeout=WAIT)
        assert _wait_for(lambda: pool._restart_total == 1)
        results = [f.result(timeout=WAIT) for f in [pool.submit(x, rid=i) for i, x in enumerate(_x(8))]]
        assert all(isinstance(r, Prediction) for r in results)
        merged = pool.merged_metrics()
        assert merged.faults == {"worker_exception": 1} and merged.restarts == 1
        health = pool.health()
        assert health["replicas_live"] == 1 and health["restarts"] == 1 and health["quarantined"] == []
        kinds = [e["kind"] for e in bus.tail(None)["events"]]
        assert kinds == ["replica_restarted"]
    finally:
        pool.stop()
        events.install_bus(None)
    assert plan.fired == [{"kind": "worker_exception", "site": "worker_batch", "seq": 0,
                           "replica": "serve-replica-0"}]
    assert engine.request_path_work() == ZERO_WORK


def test_traffic_swap_and_crash_strand_nothing_and_do_no_work(engine, weights):
    """Two replicas of two workers under traffic; a replica crash, a
    worker exception and a hot-swap land mid-stream. Every future resolves
    (served, shed typed, or with the injected failure), the swapped weights
    serve afterwards, and the request path does no work."""
    plan = tfaults.FaultPlan([
        tfaults.FaultSpec("replica_crash", at=3, replica="serve-replica-1"),
        tfaults.FaultSpec("worker_exception", at=5, replica="serve-replica-0"),
    ], seed=1)
    pool = _fast_supervision(tserver.ReplicaPool(engine, replicas=2, workers=2, faults=plan)).start()
    x = _x(120)
    futures, outcome = [], {"pred": 0, "shed": 0, "fault": 0}
    try:
        for i in range(120):
            futures.append(pool.submit(x[i], rid=i))
            if i == 60:
                rec = engine.swap_params(*_port(*weights[1]))
                assert rec["epoch"] == 1 and rec["work"] == ZERO_WORK
            if i % 10 == 0:
                time.sleep(0.005)
        for f in futures:
            try:
                r = f.result(timeout=WAIT)
                outcome["pred" if isinstance(r, Prediction) else "shed"] += 1
            except tfaults.FaultInjected:
                outcome["fault"] += 1
        assert _wait_for(lambda: pool._restart_total >= 2)
        after = [f.result(timeout=WAIT) for f in [pool.submit(v, rid=1000 + i) for i, v in enumerate(x[:8])]]
    finally:
        pool.stop()
    assert sum(outcome.values()) == 120 and outcome["fault"] >= 1 and outcome["pred"] >= 100
    fresh = ServeEngine(_tcfg(), *_port(*weights[1]), device="cpu")
    fresh.warmup()
    h_new = fresh.infer(x[:8])[0]
    np.testing.assert_array_equal(np.stack([r.h for r in after]), h_new)
    assert {f["kind"] for f in plan.fired} == {"replica_crash", "worker_exception"}
    assert engine.request_path_work() == ZERO_WORK
    assert pool.merged_metrics().completed == outcome["pred"] + 8


# ---------------------------------------------------------------------------
# the socket server
# ---------------------------------------------------------------------------


def _workdir(tmp_path, weights):
    wd = str(tmp_path / "wd")
    (h0, c0), (h1, c1) = (_port(*w) for w in weights)
    save_checkpoint(wd, "hdce_best", {"params": h0}, {})
    save_checkpoint(wd, "sc_best", {"params": c0}, {})
    save_checkpoint(wd, "hdce_v2", {"params": h1}, {})
    save_checkpoint(wd, "sc_v2", {"params": c1}, {})
    return wd


def test_run_server_round_trip_with_the_port_client(tmp_path, weights):
    wd = _workdir(tmp_path, weights)
    cfg = _tcfg(port=0, replicas=2, workers=2)
    eng = ServeEngine.from_workdir(cfg, wd, device="cpu")
    assert not eng.quantum
    eng.warmup()
    ready = Future()
    t = threading.Thread(target=tserver.run_server, args=(cfg, eng), kwargs={"workdir": wd, "ready": ready},
                         daemon=True)
    t.start()
    handle = ready.result(timeout=WAIT)
    x = _x(24)
    try:
        with ServeClient("127.0.0.1", handle["port"], timeout_s=WAIT, retries=2, backoff_s=0.01, seed=0) as c:
            replies = [c.request(x[i], rid=f"r{i}") for i in range(16)]
            assert all(r["ok"] and r["id"] == f"r{i}" for i, r in enumerate(replies))
            h0 = np.asarray([r["h"] for r in replies], np.float32)
            np.testing.assert_allclose(h0, eng.offline_forward(x[:16])[0], rtol=0, atol=1e-5)
            before = c.metrics()["metrics"]["completed"]
            again = c.request(x[0], rid="r0")  # a retried id: re-attached, not dispatched
            assert again["h"] == replies[0]["h"]
            assert c.metrics()["metrics"]["completed"] == before
            health = c.health()["health"]
            assert health["dedup_hits"] >= 1 and health["warm"] and health["replicas"] == 2
            assert health["host_id"] and health["listen"].endswith(f":{handle['port']}")
            assert c.call({"op": "scale", "replicas": 3})["scale"] == {"replicas_before": 2, "replicas": 3}
            swap = c.swap(tags={"hdce": "hdce_v2", "sc": "sc_v2"})
            assert swap["ok"] and swap["swap"]["epoch"] == 1 and swap["swap"]["work"] == ZERO_WORK
            assert swap["swap"]["tags"] == {"hdce": "hdce_v2", "sc": "sc_v2"}
            h1 = np.asarray([c.request(x[i], rid=f"s{i}")["h"] for i in range(16, 24)], np.float32)
            fresh = ServeEngine(cfg, *_port(*weights[1]), device="cpu")
            fresh.warmup()
            np.testing.assert_allclose(h1, fresh.offline_forward(x[16:24])[0], rtol=0, atol=1e-5)
            bad = c.swap(tags={"hdce": "nope"})
            assert bad["ok"] is False and bad["reason"].startswith("swap_failed")
            tail = c.events()
            assert tail["ok"] and "events" in tail["events"]
            assert c.counters()["give_ups"] == 0
        summary = run_loadgen_socket(cfg, ("127.0.0.1", handle["port"]), rate=2000.0, n=32, clients=4,
                                     timeout_s=WAIT, x=_x(32, seed=9))
        assert summary["completed"] == 32 and summary["stranded_futures"] == 0 and summary["give_ups"] == 0
        assert summary["compile_cache_after_warmup"] == ZERO_WORK
        assert summary["server_metrics"]["swap_epoch"] == 1
    finally:
        handle["stop"]()
        t.join(timeout=WAIT)
    assert not t.is_alive()
    dead = ServeClient("127.0.0.1", handle["port"], timeout_s=0.5, retries=1, backoff_s=0.01)
    with pytest.raises(ServeClientError):
        dead.request(x[0], rid="late")


def _serve_in_thread(loop_, **kw):
    aloop = asyncio.new_event_loop()
    t = threading.Thread(target=aloop.run_forever, daemon=True)
    t.start()
    ready = Future()
    mod = tserver if isinstance(loop_, (tserver.ReplicaPool, tserver.ServeLoop)) else jserver
    task = asyncio.run_coroutine_threadsafe(mod.serve_async(loop_, "127.0.0.1", 0, ready, **kw), aloop)
    port = ready.result(timeout=WAIT)

    async def cancel_all():  # the server and its connection handlers, awaited to the end
        tasks = [x for x in asyncio.all_tasks() if x is not asyncio.current_task()]
        for x in tasks:
            x.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)

    def stop():
        asyncio.run_coroutine_threadsafe(cancel_all(), aloop).result(timeout=WAIT)
        assert task.cancelled() or task.done()
        aloop.call_soon_threadsafe(aloop.stop)
        t.join(timeout=WAIT)
        aloop.close()

    return port, stop


def _shape(v):
    """A reply's structure: keys and value types, recursively (lists by
    their first element)."""
    if isinstance(v, dict):
        return {k: _shape(x) for k, x in v.items()}
    if isinstance(v, list):
        return ["list", _shape(v[0]) if v else None]
    if isinstance(v, bool) or v is None:
        return type(v).__name__
    return "number" if isinstance(v, (int, float)) else type(v).__name__


def _exchanges(port, x) -> dict:
    out = {}
    with JServeClient("127.0.0.1", port, timeout_s=WAIT, retries=0) as c:
        out["request"] = c.request(x[0], rid="w1", trace=True)
        # a deadline of 0 ms has passed on arrival (sent raw: the client
        # itself would give up on a spent budget before sending)
        out["shed"] = c.call({"id": "w2", "x": x[1].tolist(), "deadline_ms": 0})
        out["health"] = c.health()
        out["metrics"] = c.metrics()
        out["events"] = c.events(limit=4)
        out["scale"] = c.scale(1)
        out["swap"] = c.swap()
        out["bad_request"] = c.call({"id": "w3", "x": [[1.0]]})
    with socket.create_connection(("127.0.0.1", port), timeout=WAIT) as sk:
        sk.settimeout(WAIT)
        fh = sk.makefile("rw")
        fh.write("not json\n")
        fh.flush()
        out["bad_json"] = json.loads(fh.readline())
    return out


# keys whose presence depends on the engine's internals, not the protocol
_ENGINE_SIDE = {"cost", "compile_cache_after_warmup", "dispatch", "batching", "host_id", "listen",
                "start_seq", "uptime_s"}


def _strip(shape):
    if isinstance(shape, dict):
        return {k: _strip(v) for k, v in shape.items() if k not in _ENGINE_SIDE}
    return shape


def test_jax_client_gets_the_same_replies_from_the_port_server(weights):
    """Wire compatibility: the JAX package's ``ServeClient``, unchanged,
    against the port's server and against JAX's, with the same requests."""
    (hdce, clf), _ = weights
    x = _x(2)
    from qdml_tpu.telemetry import events as jevents

    teng = ServeEngine(_tcfg(trace_sample=0.0), *_port(hdce, clf), device="cpu")
    jeng = JServeEngine(_jcfg(), hdce, clf, quantum=False)
    replies = {}
    for name, eng, mod, bus in (("port", teng, tserver, events), ("jax", jeng, jserver, jevents)):
        bus.install_bus(bus.EventBus())  # both spines start empty
        eng.warmup()
        pool = mod.ReplicaPool(eng, replicas=1).start()
        port, stop = _serve_in_thread(pool, dedup_ttl_s=5.0)
        try:
            replies[name] = _exchanges(port, x)
        finally:
            stop()
            pool.stop()
            bus.install_bus(None)
    got, want = replies["port"], replies["jax"]
    assert set(got) == set(want)
    for verb in got:
        assert _strip(_shape(got[verb])) == _strip(_shape(want[verb])), verb
    # the values that carry meaning agree too
    assert got["request"]["ok"] and want["request"]["ok"]
    np.testing.assert_allclose(got["request"]["h"], want["request"]["h"], rtol=0,
                               atol=1e-4 * np.abs(want["request"]["h"]).max() + 1e-5)
    assert got["request"]["pred"] == want["request"]["pred"]
    assert [p[0] for p in got["request"]["trace"]["phases"]] == [p[0] for p in want["request"]["trace"]["phases"]]
    assert got["shed"] == want["shed"] == {"id": "w2", "ok": False, "reason": "deadline_at_submit"}
    assert got["bad_json"] == want["bad_json"] == {"ok": False, "reason": "bad_json"}
    assert got["swap"]["reason"] == want["swap"]["reason"]
    assert got["bad_request"]["reason"].startswith("bad_request") and got["bad_request"]["ok"] is False
    assert got["scale"]["scale"] == want["scale"]["scale"] == {"replicas_before": 1, "replicas": 1}
