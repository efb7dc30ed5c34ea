"""Serve loop, replica pool and the local socket front end (``qdml_tpu/serve/server.py``).

:class:`ServeLoop` is the in-process serving core: worker threads that drain
the micro-batcher; sheds resolve at once, ready batches go through the
engine's pinned forward, and every request's future resolves with a typed
:class:`~qdml_tpu_torch.serve.types.Prediction` or
:class:`~qdml_tpu_torch.serve.types.Overloaded`. :class:`ReplicaPool` runs N
of them over one shared batcher against one warmed engine (one warmup, one
set of race tables), with per-worker
:class:`~qdml_tpu_torch.serve.metrics.ServeMetrics` merged exactly.

Exit discipline: every worker of every replica registers with one
:class:`ExitCoordinator`. A crashed or stopped worker never sheds the shared
queue while a peer can still serve it; the last worker out pool-wide drains
it, so nothing strands. A batch that fails (an engine error, a kernel that
fails to launch, an injected fault) resolves every one of its futures with
the exception; nothing retries it on the plain versions.

Supervision: a supervisor thread restarts replicas whose workers died (and,
with ``serve.stall_timeout_s``, whose heartbeat is stale while work is
queued) after a jittered exponential backoff under a restart budget, and
quarantines a crash-looping slot while the peers serve on. A
:class:`~qdml_tpu_torch.serve.breaker.CircuitBreaker` (``serve.breaker``)
fronts ``submit``. Faults inject through an explicit
:class:`~qdml_tpu_torch.serve.faults.FaultPlan` (``faults=``; inert when
absent).

Threads and the card: every worker calls ``engine.infer`` on its thread's
current stream, which is the device's default stream unless a caller set
another, so the workers' batches queue on one stream; the reply's ``.cpu()``
waits for its own batch and releases the GIL meanwhile, which is where
several workers overlap host-side result handling with the card's work.

:func:`run_server` is an asyncio loop accepting newline-delimited JSON over a
local TCP socket, byte-compatible with the JAX package's:
``{"id", "x", [deadline_ms], [trace]}`` -> ``{"id", "ok": true, "pred",
"h", "latency_ms", "bucket", [trace]}`` or ``{"id", "ok": false,
"reason"}``, plus the verbs ``{"op": "metrics" | "health" | "swap" |
"scale" | "events"}``. Connections are hardened: an idle/read timeout
(``serve.conn_timeout_s``), a line limit (``serve.max_line_bytes``) and a
dedup window (``serve.dedup_ttl_s``) in which a retried id re-attaches to
its first dispatch.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import socket
import threading
import time
from concurrent.futures import Future
from typing import Callable

import numpy as np

from qdml_tpu_torch.config import ExperimentConfig
from qdml_tpu_torch.serve.batcher import MicroBatcher
from qdml_tpu_torch.serve.breaker import CircuitBreaker
from qdml_tpu_torch.serve.engine import ServeEngine
from qdml_tpu_torch.serve.faults import FaultInjected, FaultPlan, RestartPolicy
from qdml_tpu_torch.serve.metrics import ServeMetrics
from qdml_tpu_torch.serve.types import (
    BREAKER_OPEN,
    SHUTDOWN,
    Overloaded,
    Prediction,
    Request,
)
from qdml_tpu_torch.telemetry.events import ensure_bus
from qdml_tpu_torch.telemetry.events import publish as publish_event
from qdml_tpu_torch.telemetry.spans import get_sink
from qdml_tpu_torch.telemetry.tracing import TraceContext, trace_sampled
from qdml_tpu_torch.utils import lockdep


def _emit_event(name: str, **fields) -> None:
    """Structured fleet event (replica_restarted / replica_quarantined /
    supervisor_error) into the run's telemetry stream, if one is active —
    and onto the process-global event spine always (the ``{"op": "events"}``
    tail works sink or no sink)."""
    sink = get_sink()
    if sink is not None and getattr(sink, "active", False):
        sink.emit("counters", name=name, **fields)
    publish_event(name, tier="serve", **fields)


class ExitCoordinator:
    """Worker-liveness accounting shared by every loop draining one batcher.

    One instance per ServeLoop by default; a :class:`ReplicaPool` injects a
    single shared instance into all its replicas, so "am I the last worker
    out" (the drain trigger) and "is anyone still serving" (the submit
    liveness check) are pool-wide facts, not per-loop guesses.
    """

    def __init__(self):
        self._lock = lockdep.Lock("ExitCoordinator._lock")
        self._live = 0

    def enter(self, n: int) -> None:
        with self._lock:
            self._live += n

    def leave(self) -> bool:
        """Deregister one worker; True iff it was the last one pool-wide."""
        with self._lock:
            self._live -= 1
            return self._live <= 0

    def live(self) -> int:
        with self._lock:
            return self._live


class ServeLoop:
    """Worker thread(s) pumping batcher -> engine -> futures.

    ``workers`` (default ``cfg.serve.workers``) threads share the one
    batcher and engine; each records into its OWN :class:`ServeMetrics`
    (no cross-thread contention on the hot path) and
    :meth:`merged_metrics`/:meth:`live_metrics` aggregate them exactly via
    ``Histogram.merge``. ``self.metrics`` is worker 0's collector — the
    single-worker default is one thread and one collector.
    ``exit_coord`` shares worker-exit accounting across loops (the replica
    pool passes one coordinator to all replicas); ``name`` labels the
    threads. ``faults`` opts into the chaos hooks (None = inert, free);
    ``breaker`` fronts submit with the brownout state machine (the pool
    passes one breaker to all replicas so the front's decisions cover the
    shared queue).
    """

    def __init__(
        self,
        engine: ServeEngine,
        batcher: MicroBatcher | None = None,
        metrics: ServeMetrics | None = None,
        workers: int | None = None,
        exit_coord: ExitCoordinator | None = None,
        name: str = "serve-loop",
        faults: FaultPlan | None = None,
        breaker: CircuitBreaker | None = None,
        trace_sample: float | None = None,
    ):
        serve_cfg = engine.cfg.serve
        self.engine = engine
        self.name = name
        self.faults = faults
        # remember whether the batcher is loop-owned: start() syncs an owned
        # batcher's admission policy (coalesce vs continuous) from the warmed
        # engine's measured batching mode; an injected batcher is the
        # caller's to configure (the replica pool injects its shared one and
        # syncs it itself; fake-clock tests pin the policy they test)
        self._own_batcher = batcher is None
        self.batcher = batcher or MicroBatcher(
            max_batch=serve_cfg.max_batch,
            max_wait_s=serve_cfg.max_wait_ms / 1e3,
            max_queue=serve_cfg.max_queue,
            continuous=engine.continuous_admission,
        )
        self._breaker = breaker if breaker is not None else (
            CircuitBreaker(
                max_queue=self.batcher.max_queue,
                high_frac=serve_cfg.breaker_high_frac,
                low_frac=serve_cfg.breaker_low_frac,
                open_s=serve_cfg.breaker_open_s,
                probes=serve_cfg.breaker_probes,
            )
            if serve_cfg.breaker
            else None
        )
        self.metrics = metrics or ServeMetrics()
        self.workers = max(1, int(workers if workers is not None else serve_cfg.workers))
        self._worker_metrics = [self.metrics] + [
            ServeMetrics(
                sink=self.metrics._sink, log_requests=self.metrics.log_requests
            )
            for _ in range(self.workers - 1)
        ]
        self._default_deadline_s = (
            serve_cfg.deadline_ms / 1e3 if serve_cfg.deadline_ms > 0 else None
        )
        # Phase-trace sampling rate (telemetry/tracing.py): deterministic on
        # the request id, so a retried id stays traced across tiers. The
        # override parameter exists for harnesses that vary the rate against
        # ONE warmed engine (its forwards are identical either way —
        # tracing is host-side only).
        self._trace_sample = float(
            serve_cfg.trace_sample if trace_sample is None else trace_sample
        )
        self._stop = threading.Event()
        # wake rides on the BATCHER (its owner): pool replicas share the
        # queue, so a submit must reach whichever loop's worker is idle
        self._wake = self.batcher.wake
        self._threads: list[threading.Thread] = []
        self._exit = exit_coord or ExitCoordinator()
        self._started = False  # stays True after stop(): a finished loop rejects
        self._rid = 0
        # supervision signals (advisory, single-writer-newest-wins floats:
        # any worker stamps them; the supervisor/health verb only AGE them)
        self._heartbeat = 0.0          # newest worker pump iteration
        self._last_dispatch_ts = 0.0   # newest served batch
        # restart-visibility epoch: a
        # monitor differencing cumulative counters across polls must detect
        # a restart BETWEEN two scrapes — uptime_s alone can miss one when
        # the poll gap exceeds the new uptime, so start_seq stamps the
        # construction instant as an identity the restart resets
        self._monitor_t0 = time.monotonic()
        self._start_seq = int(time.time() * 1000)

    # -- client side --------------------------------------------------------

    def submit(
        self,
        x: np.ndarray,
        rid: int | str | None = None,
        deadline_ms: float | None = None,
        trace: bool | None = None,
    ) -> Future:
        """Enqueue one request; the returned future resolves with a
        Prediction or Overloaded (never raises for overload). A malformed
        payload raises ``ValueError`` HERE, synchronously — client errors
        must never reach the worker, where one bad shape would crash the
        batch it was coalesced into. ``trace`` forces (True) or suppresses
        (False) the phase trace; None (default) samples by the id hash at
        ``serve.trace_sample`` — 0 creates nothing, the overhead-free pin."""
        x = np.asarray(x, np.float32)
        expect = (*self.engine.cfg.image_hw, 2)
        if x.shape != expect:
            raise ValueError(f"request x has shape {x.shape}, expected {expect}")
        if rid is None:
            self._rid += 1
            rid = self._rid
        if self._started and self._exit.live() <= 0:
            # no worker anywhere in the pool can serve this: the queue would
            # grow with futures nobody will ever resolve (clients hung
            # forever behind a server that still accepts connections).
            # Submits before start() are fine — start() will drain them; a
            # crashed worker with live peers is fine too — the coordinator
            # counts pool-wide, and the peers drain the shared queue.
            fut: Future = Future()
            fut.set_result(Overloaded(rid, SHUTDOWN))
            return fut
        had_deadline = deadline_ms is not None or self._default_deadline_s is not None
        if self._breaker is not None and not self._breaker.allow(self.batcher.depth):
            # brownout: fast-fail BEFORE the queue — requests already queued
            # keep their place, and the retrying client gets an immediate
            # typed signal instead of a doomed queue wait
            res = Overloaded(rid, BREAKER_OPEN)
            self.metrics.observe_shed(res, had_deadline=had_deadline)
            fut = Future()
            fut.set_result(res)
            return fut
        now = self.batcher.clock()
        deadline_s = (
            deadline_ms / 1e3 if deadline_ms is not None else self._default_deadline_s
        )
        want_trace = (
            trace
            if trace is not None
            else self._trace_sample > 0.0 and trace_sampled(rid, self._trace_sample)
        )
        req = Request(
            rid=rid,
            x=x,
            deadline=None if deadline_s is None else now + deadline_s,
            future=Future(),
            trace=TraceContext(rid) if want_trace else None,
        )
        rejected = self.batcher.submit(req, now=now)
        if rejected is not None:
            self.metrics.observe_shed(rejected, had_deadline=req.deadline is not None)
            req.future.set_result(rejected)
        return req.future

    # -- worker side --------------------------------------------------------

    def start(self) -> "ServeLoop":
        if not self.engine._warm:
            self.engine.warmup()
        if self._own_batcher:
            # the "auto" batching race resolves at warmup, after the batcher
            # exists: sync the admission policy to the measured mode (ragged
            # -> continuous dispatch, bucket -> coalesce to bucket edges)
            self.batcher.continuous = self.engine.continuous_admission
        self._stop.clear()
        self._threads = [
            threading.Thread(
                target=self._run,
                args=(self._worker_metrics[i],),
                daemon=True,
                name=f"{self.name}-{i}",
            )
            for i in range(self.workers)
        ]
        self._started = True
        # register BEFORE the threads run: a submit racing start() must see
        # the pool as live (the coordinator is the liveness source of truth)
        self._exit.enter(len(self._threads))
        for t in self._threads:
            t.start()
        return self

    def stop(self, drain: bool = True) -> None:
        """Stop the workers; with ``drain`` (default) only after the queue
        has emptied, so every submitted future resolves. When pool PEERS
        share the batcher, draining is their job — a scaled-down replica
        must not block on a feed that live peers keep refilling (and they,
        or the pool-wide last-worker-out drain, resolve every future)."""
        if not self._threads:
            return
        if drain:
            while (
                self.batcher.depth > 0
                and 0 < self._exit.live() <= sum(t.is_alive() for t in self._threads)
            ):
                self._wake.set()
                time.sleep(0.001)
        self._stop.set()
        self._wake.set()
        for t in self._threads:
            t.join(timeout=10.0)
        self._threads = []

    def merged_metrics(self, sink=None) -> ServeMetrics:
        """All workers' collectors folded into one fresh ServeMetrics (exact
        quantile aggregation — ``Histogram.merge`` keeps raw samples).
        ``sink`` binds the aggregate's flush target (loadgen passes its
        logger's telemetry stream)."""
        agg = ServeMetrics(sink=sink, log_requests=False)
        for m in self._worker_metrics:
            agg.merge(m)
        return agg

    def live_metrics(self) -> dict:
        """The ``{"op": "metrics"}`` serve-verb payload: merged per-worker
        counters/histograms, current queue depth, bucket layout, swap epoch,
        and the request-path work since warmup — a running server is
        observable without restarting it. Safe to call any time (also after
        stop)."""
        return self.merged_metrics().snapshot(
            compile_cache=self.engine.request_path_work(),
            workers=self.workers,
            queue_depth_now=self.batcher.depth,
            buckets=list(self.engine.buckets),
            swap_epoch=self.engine.swap_epoch,
            dispatch=self.engine.dispatch_summary(),
            batching=self.engine.batching_summary(),
            breaker=None if self._breaker is None else self._breaker.summary(),
        )

    def health(self) -> dict:
        """The ``{"op": "health"}`` verb's per-loop view: is anything able to
        serve, and how stale is it. Cheap (no histogram merges — this is the
        1 Hz poll a front-door router or the fleet controller makes)."""
        now = time.monotonic()
        alive = sum(t.is_alive() for t in self._threads)
        return {
            "warm": bool(getattr(self.engine, "_warm", False)),
            "started": self._started,
            "workers": self.workers,
            "workers_alive": alive,
            "queue_depth": self.batcher.depth,
            "heartbeat_age_s": (
                None if not self._heartbeat else round(now - self._heartbeat, 4)
            ),
            "last_dispatch_age_s": (
                None
                if not self._last_dispatch_ts
                else round(now - self._last_dispatch_ts, 4)
            ),
            "swap_epoch": self.engine.swap_epoch,
            "uptime_s": round(now - self._monitor_t0, 3),
            "start_seq": self._start_seq,
            "breaker": None if self._breaker is None else self._breaker.summary(),
        }

    def _serve_one(self, metrics: ServeMetrics | None = None) -> bool:
        """Single batcher pump: resolve sheds, serve at most one batch.
        Returns True when any work happened (the loop's idle detector).
        ``metrics`` is the calling worker's collector (worker 0's when
        driven directly, e.g. by the fake-clock tests)."""
        metrics = metrics if metrics is not None else self.metrics
        depth = self.batcher.depth
        batch, shed = self.batcher.next_batch()
        for r, o in shed:
            # dequeue sheds are deadline expiries by construction
            metrics.observe_shed(o, had_deadline=True)
            if r.future is not None:
                r.future.set_result(o)
        if not batch:
            return bool(shed)
        # dequeue/dispatch trace boundary: stamped ONLY when the batch holds
        # a traced request (trace_sample=0 adds zero clock calls here — the
        # fake-clock tests and the overhead-free pin both count on it)
        traced = any(r.trace is not None for r in batch)
        t_dequeue = self.batcher.clock() if traced else None
        t0 = time.perf_counter()
        try:
            # stack INSIDE the guard: a shape-mismatched request failing the
            # stack must strand nobody, exactly like an engine failure
            x = np.stack([r.x for r in batch])
            if self.faults is not None:
                # worker_exception site: the batch is dequeued and its
                # futures are in hand — an injected raise here must resolve
                # every one of them with the failure, exactly like a real
                # engine error (that equivalence is what the chaos proves)
                self.faults.check_worker_batch(self.name)
            h, pred, conf, info = self.engine.infer(x, traced=traced)
        except BaseException as e:
            # a dying batch must not strand its clients: forward the failure
            # into every future, then let the loop's finally drain the rest
            for r in batch:
                if r.future is not None and not r.future.done():
                    r.future.set_exception(e)
            raise
        dur = time.perf_counter() - t0
        self._last_dispatch_ts = time.monotonic()
        now = self.batcher.clock()
        if traced:
            # batch_wait vs queue_wait split: the batch's
            # NEWEST member's enqueue time partitions each request's wait —
            # everything before it is coalescing (waiting for later arrivals
            # to batch with), everything after is the formed batch waiting
            # for a free engine. Both from the one batcher clock that also
            # stamps enqueue_ts and latency_s — never mixed with perf_counter.
            newest = max(r.enqueue_ts for r in batch)
            for r in batch:
                if r.trace is None:
                    continue
                r.trace.add_phase("batch_wait", newest - r.enqueue_ts)
                r.trace.add_phase("queue_wait", t_dequeue - newest)
                if info.compute_s is not None:
                    r.trace.add_phase("compute", info.compute_s)
                if info.fetch_s is not None:
                    r.trace.add_phase("fetch", info.fetch_s)
                # future-resolution boundary closes the trace: the total IS
                # the latency the reply reports, so phase sums reconcile
                # against the same number the latency histogram sees
                r.trace.total_s = now - r.enqueue_ts
        preds = []
        for i, r in enumerate(batch):
            p = Prediction(
                rid=r.rid,
                h=h[i],
                scenario=int(pred[i]),
                latency_s=now - r.enqueue_ts,
                bucket=info.bucket,
                batch_n=len(batch),
                deadline_met=None if r.deadline is None else now <= r.deadline,
                confidence=float(conf[i]),
                trace=r.trace,
            )
            preds.append(p)
        # metrics before resolution: a client awaiting the future must be able
        # to read a consistent histogram the moment its result arrives
        metrics.observe_batch(preds, info, depth, dur)
        for r, p in zip(batch, preds):
            if r.future is not None:
                r.future.set_result(p)
        return True

    def _run(self, metrics: ServeMetrics) -> None:
        try:
            while not self._stop.is_set():
                self._heartbeat = time.monotonic()
                if self.faults is not None and self.batcher.depth > 0:
                    # replica_crash site: BEFORE any dequeue and only when
                    # work is pending (so the schedule's `at` counts
                    # observed-work occasions) — an injected crash leaves the
                    # queue untouched, the killed-process shape supervision
                    # must recover from
                    self.faults.check_worker_loop(self.name)
                if not self._serve_one(metrics):
                    # idle: sleep until the oldest request ages out or a submit wakes us
                    self._wake.wait(timeout=max(self.batcher.wait_hint(), 1e-4))
                    self._wake.clear()
        except FaultInjected as e:
            # an injected chaos fault kills the worker — that IS the
            # experiment — quietly: the expected crash must not bury the
            # run's stderr under tracebacks (real failures re-raise below)
            metrics.observe_fault(e.kind)
        except BaseException as e:
            metrics.observe_fault(type(e).__name__)
            raise
        finally:
            # shutdown OR crash: resolve EVERYTHING still queued (no silent
            # hangs) — but only once no OTHER worker, in THIS loop or any
            # pool peer sharing the batcher, can still serve it. A single
            # crashed worker (or a stopped replica) must not shed a queue
            # its surviving peers are actively draining; the LAST worker out
            # pool-wide always drains, so nothing strands either way.
            last_out = self._exit.leave()
            while last_out:
                batch, shed = self.batcher.next_batch(now=float("inf"))
                if not batch and not shed:
                    break
                for r, o in shed:
                    metrics.observe_shed(o, had_deadline=True)
                    if r.future is not None:
                        r.future.set_result(o)
                for r in batch:
                    if r.future is not None:
                        r.future.set_result(
                            Overloaded(r.rid, SHUTDOWN)
                        )


class ReplicaPool:
    """N ServeLoops over one shared batcher, one engine, one warmup.

    The fleet unit of: every replica pumps the SAME
    :class:`MicroBatcher` feed through the SAME warmed engine (one set of
    pinned forwards, one set of race tables — warmup runs exactly once however
    many replicas serve), with per-replica/per-worker :class:`ServeMetrics`
    merged exactly via ``Histogram.merge`` on demand. One
    :class:`ExitCoordinator` spans the pool, so submit-liveness and
    last-worker-out draining are pool-wide facts. A checkpoint hot-swap on
    the shared engine (``engine.swap_params``) lands on every replica at
    once — each batch reads the live param tuple at dequeue.

    The pool is ELASTIC: :meth:`add_replica` / :meth:`remove_replica` /
    :meth:`scale_to` resize it under live traffic (the autoscaler's levers,
   ). Removal is drain-safe by construction: the departing
    replica's workers deregister from the SHARED coordinator, and because
    live peers remain, the last-worker-out drain never fires — the shared
    queue keeps being pumped by the survivors and no submitted future is
    ever shed by a scale-down. Replica 0 is the permanent submit front and
    is never removed. Removed replicas land in a retired list so their
    histograms stay in :meth:`merged_metrics` (a scale-down must not vanish
    the requests it already served).

    The pool is also SUPERVISED (``serve.supervise``): a
    supervisor thread restarts replicas whose workers died (thread liveness;
    plus heartbeat age under ``serve.stall_timeout_s``) with jittered
    exponential backoff, and quarantines a slot that exhausts
    ``serve.restart_budget`` — structured ``replica_restarted`` /
    ``replica_quarantined`` events, peers serving throughout, the
    zero-stranded-futures invariant intact across every restart (the crashed
    worker's own exit path resolves what it held; the restarted workers —
    or live peers — drain the shared queue).
    """

    def __init__(
        self,
        engine: ServeEngine,
        replicas: int | None = None,
        batcher: MicroBatcher | None = None,
        workers: int | None = None,
        sink=None,
        log_requests: bool = True,
        faults: FaultPlan | None = None,
        trace_sample: float | None = None,
    ):
        serve_cfg = engine.cfg.serve
        self.engine = engine
        n_replicas = max(
            1, int(replicas if replicas is not None else serve_cfg.replicas)
        )
        self._own_batcher = batcher is None
        self.batcher = batcher or MicroBatcher(
            max_batch=serve_cfg.max_batch,
            max_wait_s=serve_cfg.max_wait_ms / 1e3,
            max_queue=serve_cfg.max_queue,
            continuous=engine.continuous_admission,
        )
        self._exit = ExitCoordinator()
        self._sink = sink
        self._log_requests = log_requests
        self._workers_per = workers
        self._faults = faults
        self._trace_sample = trace_sample  # None = each loop reads cfg
        # ONE breaker fronts the pool: every replica's submit consults it,
        # and since submits funnel through replica 0 the state machine sees
        # every admission decision for the shared queue
        self.breaker = (
            CircuitBreaker(
                max_queue=self.batcher.max_queue,
                high_frac=serve_cfg.breaker_high_frac,
                low_frac=serve_cfg.breaker_low_frac,
                open_s=serve_cfg.breaker_open_s,
                probes=serve_cfg.breaker_probes,
            )
            if serve_cfg.breaker
            else None
        )
        self._pool_lock = lockdep.Lock("ReplicaPool._pool_lock")
        self._started = False
        self._next_id = n_replicas
        self._replicas = [
            self._make_replica(i) for i in range(n_replicas)
        ]
        # the permanent submit front: replica 0 validates/enqueues into the
        # shared feed without taking the pool lock per request (it is created
        # here and never removed — though supervision may REPLACE the object,
        # atomically repointing this reference)
        self._front = self._replicas[0]
        self._retired: list[ServeLoop] = []
        self._quarantined: list[ServeLoop] = []
        # supervision state: per-slot restart counts,
        # the jittered-backoff policy, and the seeded rng (the FaultPlan's
        # under chaos, so runs replay; fresh otherwise)
        self._supervise = bool(serve_cfg.supervise)
        self._sup_interval_s = float(serve_cfg.supervise_interval_s)
        self._stall_timeout_s = float(serve_cfg.stall_timeout_s)
        self._policy = RestartPolicy(
            base_s=serve_cfg.restart_backoff_s, budget=serve_cfg.restart_budget
        )
        self._rng = faults.rng if faults is not None else random.Random(0)
        self._restart_counts: dict[str, int] = {}
        self._restart_ts: dict[str, float] = {}
        self._restart_total = 0
        self._sup_stop = threading.Event()
        self._sup_thread: threading.Thread | None = None
        # restart-visibility epoch, pool-level (the pool survives replica
        # restarts; only a PROCESS restart resets these — exactly the event
        # the monitor's counter differencing must re-anchor on)
        self._monitor_t0 = time.monotonic()
        self._start_seq = int(time.time() * 1000)

    def _make_replica(self, i: int) -> ServeLoop:
        return self._new_loop(f"serve-replica-{i}")

    def _new_loop(self, name: str) -> ServeLoop:
        return ServeLoop(
            self.engine,
            batcher=self.batcher,
            metrics=ServeMetrics(sink=self._sink, log_requests=self._log_requests),
            workers=self._workers_per,
            exit_coord=self._exit,
            name=name,
            faults=self._faults,
            breaker=self.breaker,
            trace_sample=self._trace_sample,
        )

    @property
    def replicas(self) -> list[ServeLoop]:
        """Snapshot of the live replica list (copy — the pool can be resized
        by the autoscaler thread while a caller iterates)."""
        with self._pool_lock:
            return list(self._replicas)

    @property
    def n_replicas(self) -> int:
        with self._pool_lock:
            return len(self._replicas)

    @property
    def workers(self) -> int:
        """Total worker threads across the live pool."""
        return sum(r.workers for r in self.replicas)

    def start(self) -> "ReplicaPool":
        if not self.engine._warm:
            self.engine.warmup()  # ONE warmup, shared by every replica
        if self._own_batcher:
            # post-warmup sync, same as ServeLoop: the measured batching mode
            # decides whether the SHARED feed coalesces or admits continuously
            self.batcher.continuous = self.engine.continuous_admission
        for r in self.replicas:
            r.start()
        self._started = True
        if self._supervise and self._sup_thread is None:
            self._sup_stop.clear()
            self._sup_thread = threading.Thread(
                target=self._supervise_loop, daemon=True, name="serve-supervisor"
            )
            self._sup_thread.start()
        return self

    def stop(self, drain: bool = True) -> None:
        # supervisor first: it must not resurrect the replicas being stopped
        if self._sup_thread is not None:
            self._sup_stop.set()
            self._sup_thread.join(timeout=10.0)
            self._sup_thread = None
        if drain:
            while self.batcher.depth > 0 and self._exit.live() > 0:
                self.batcher.wake.set()
                time.sleep(0.001)
        self._started = False
        with self._pool_lock:
            loops = list(self._replicas) + list(self._quarantined)
        for r in loops:
            r.stop(drain=False)

    # -- supervision -----------------------------------

    def _supervise_loop(self) -> None:
        while not self._sup_stop.wait(self._sup_interval_s):
            try:
                self._check_replicas()
            except Exception as e:
                _emit_event(
                    "supervisor_error", error=f"{type(e).__name__}: {e}"
                )

    def _check_replicas(self) -> None:
        """One supervision sweep: restart (or quarantine) every replica whose
        workers died — or, with ``serve.stall_timeout_s``, whose newest
        heartbeat is stale while work is queued (a hung worker pins requests
        exactly like a crashed one). Deliberately SKIPS replicas that were
        stopped on purpose (``_stop`` set — scale-downs and shutdowns are not
        crashes)."""
        with self._pool_lock:
            snapshot = list(self._replicas)
        now = time.monotonic()
        for loop in snapshot:
            if not loop._started or loop._stop.is_set() or not loop._threads:
                continue
            dead = any(not t.is_alive() for t in loop._threads)
            # progress = the freshest of loop-top heartbeat and last served
            # batch: a worker deep in a LONG (but progressing) dispatch has
            # a stale heartbeat yet a recent dispatch stamp, and must not be
            # restarted as hung. stall_timeout_s must still exceed the
            # worst-case batch service time — (default 0
            # = disabled for exactly this reason).
            progress = max(loop._heartbeat, loop._last_dispatch_ts)
            stalled = (
                self._stall_timeout_s > 0
                and self.batcher.depth > 0
                and progress > 0
                and now - progress > self._stall_timeout_s
            )
            if dead or stalled:
                self._restart_replica(
                    loop, "worker_death" if dead else "worker_stall"
                )

    def _restart_replica(self, loop: ServeLoop, reason: str) -> None:
        slot = loop.name
        now = time.monotonic()
        n = self._restart_counts.get(slot, 0)
        # the budget counts crash LOOPS, not lifetime totals: sustained
        # healthy serving since the last restart forgets the slot's history
        # (a transient fault a day apart must never inch toward quarantine)
        last = self._restart_ts.get(slot)
        if n and last is not None and self._policy.stale(now - last):
            n = 0
            self._restart_counts[slot] = 0
        if self._policy.exhausted(n):
            # crash-looping slot: QUARANTINE — peers keep serving, the event
            # is structured, and the slot stays visible in health() so an
            # operator (or the fleet controller) can act on it
            with self._pool_lock:
                if loop not in self._replicas:
                    return  # scaled away between the sweep and now
                self._replicas.remove(loop)
                self._quarantined.append(loop)
                survivors = list(self._replicas)
            loop.stop(drain=False)
            if self._front is loop and survivors:
                self._front = survivors[0]
            _emit_event(
                "replica_quarantined", replica=slot, reason=reason, restarts=n
            )
            return
        # jittered exponential backoff BEFORE the restart: a crash-looping
        # replica must not hot-spin warm-start cycles (budget bounds the
        # total), and the jitter decorrelates a fleet restarting at once.
        # The wait rides the supervisor's stop event, so pool.stop() can
        # interrupt a long backoff instead of racing a sleeping sweep that
        # would restart a replica into an already-stopped pool
        delay = self._policy.delay(n, self._rng)
        if self._sup_stop.wait(delay):
            return  # the pool is stopping: abort the restart
        loop.stop(drain=False)
        fresh = self._new_loop(slot)
        with self._pool_lock:
            if loop not in self._replicas:
                return  # scaled away while backing off
            self._replicas[self._replicas.index(loop)] = fresh
            self._retired.append(loop)
        self._restart_counts[slot] = n + 1
        self._restart_ts[slot] = time.monotonic()
        self._restart_total += 1
        fresh.metrics.restarts += 1
        if self._front is loop:
            self._front = fresh
        fresh.start()
        _emit_event(
            "replica_restarted",
            replica=slot,
            reason=reason,
            restart=n + 1,
            backoff_s=round(delay, 4),
        )

    # -- elastic scaling (the autoscaler's levers) --------------------------

    def add_replica(self) -> ServeLoop:
        """Grow the pool by one replica under live traffic: the new loop
        shares the batcher, engine (already warmed — no new
        measurements) and exit coordinator, and starts serving the shared queue
        immediately."""
        with self._pool_lock:
            loop = self._make_replica(self._next_id)
            self._next_id += 1
            self._replicas.append(loop)
            started = self._started
        if started:
            loop.start()
        return loop

    def remove_replica(self) -> ServeLoop | None:
        """Shrink the pool by one replica (never below one; replica 0, the
        submit front, is never the victim). Drain-safe: ``stop(drain=False)``
        only stops THIS replica's workers — they deregister from the shared
        :class:`ExitCoordinator`, and because peers remain live the
        last-worker-out drain cannot fire, so every queued future is drained
        by the survivors (pinned in tests/test_control.py). Returns the
        removed loop (its metrics are retained in :meth:`merged_metrics`),
        or ``None`` when the pool is already at one replica."""
        with self._pool_lock:
            if len(self._replicas) <= 1:
                return None
            loop = self._replicas.pop()
            self._retired.append(loop)
        loop.stop(drain=False)
        return loop

    def scale_to(self, n: int) -> dict:
        """Resize to ``n`` replicas (clamped to >= 1); returns the action
        record the ``{"op": "scale"}`` verb replies with."""
        n = max(1, int(n))
        before = self.n_replicas
        while self.n_replicas < n:
            self.add_replica()
        while self.n_replicas > n:
            if self.remove_replica() is None:
                break
        return {"replicas_before": before, "replicas": self.n_replicas}

    def submit(
        self,
        x: np.ndarray,
        rid: int | str | None = None,
        deadline_ms: float | None = None,
        trace: bool | None = None,
    ) -> Future:
        """Validated enqueue into the SHARED feed (replica 0 fronts it; the
        liveness check is pool-wide through the coordinator, so work is
        accepted as long as ANY replica can serve it)."""
        return self._front.submit(x, rid=rid, deadline_ms=deadline_ms, trace=trace)

    def merged_metrics(self, sink=None) -> ServeMetrics:
        """Every replica's every worker folded into one collector — exact
        quantiles across the whole pool (``Histogram.merge``), retired
        (scaled-down) and quarantined replicas included: the requests they
        served happened."""
        agg = ServeMetrics(sink=sink, log_requests=False)
        with self._pool_lock:
            loops = (
                list(self._replicas) + list(self._retired) + list(self._quarantined)
            )
        for r in loops:
            for m in r._worker_metrics:
                agg.merge(m)
        return agg

    def live_metrics(self) -> dict:
        """Pool-wide ``{"op": "metrics"}`` payload: the merged counters plus
        replica topology and per-replica completion split (the fleet-balance
        view), the shared queue depth, the swap epoch and the routing
        dispatch block — everything the fleet controller's poll consumes."""
        replicas = self.replicas
        return self.merged_metrics().snapshot(
            compile_cache=self.engine.request_path_work(),
            workers=self.workers,
            replicas=len(replicas),
            # plain counter sums — a per-replica merged_metrics() here would
            # copy every raw histogram sample once per replica per poll
            replica_completed=[
                sum(m.completed for m in r._worker_metrics) for r in replicas
            ],
            queue_depth_now=self.batcher.depth,
            buckets=list(self.engine.buckets),
            swap_epoch=self.engine.swap_epoch,
            dispatch=self.engine.dispatch_summary(),
            batching=self.engine.batching_summary(),
            breaker=None if self.breaker is None else self.breaker.summary(),
        )

    def health(self) -> dict:
        """The ``{"op": "health"}`` verb: liveness/readiness without touching
        a histogram — warmup state, live vs quarantined replicas, queue
        depth, last-dispatch age, swap epoch, restart count, breaker state.
        This is what a front-door router's health check (and the fleet
        controller) polls at 1 Hz; :meth:`live_metrics` is the heavier
        counters view."""
        with self._pool_lock:
            replicas = list(self._replicas)
            quarantined = [q.name for q in self._quarantined]
        now = time.monotonic()
        live = sum(
            1
            for r in replicas
            if r._threads and all(t.is_alive() for t in r._threads)
        )
        last_ts = max((r._last_dispatch_ts for r in replicas), default=0.0)
        return {
            "warm": bool(getattr(self.engine, "_warm", False)),
            "replicas": len(replicas),
            "replicas_live": live,
            "quarantined": quarantined,
            "workers": sum(r.workers for r in replicas),
            "queue_depth": self.batcher.depth,
            "last_dispatch_age_s": (
                None if last_ts == 0.0 else round(now - last_ts, 4)
            ),
            "swap_epoch": self.engine.swap_epoch,
            "uptime_s": round(now - self._monitor_t0, 3),
            "start_seq": self._start_seq,
            "restarts": self._restart_total,
            "supervised": (
                self._sup_thread is not None and self._sup_thread.is_alive()
            ),
            "breaker": None if self.breaker is None else self.breaker.summary(),
        }


# ---------------------------------------------------------------------------
# Socket front-end (newline-delimited JSON over local TCP)
# ---------------------------------------------------------------------------


def _encode(res) -> dict:
    if isinstance(res, Prediction):
        out = {
            "id": res.rid,
            "ok": True,
            "pred": res.scenario,
            "h": np.asarray(res.h, np.float32).tolist(),
            "latency_ms": round(res.latency_s * 1e3, 3),
            "bucket": res.bucket,
        }
        if res.trace is not None:
            # the optional trace wire field: phase spans in
            # ms — a fleet router PREPENDS its own pick/wire spans to these
            out["trace"] = res.trace.to_wire()
        return out
    return {"id": res.rid, "ok": False, "reason": res.reason}


class DedupCache:
    """Server-side idempotent-request dedup: explicit request ids map to
    their in-flight (or recently completed) futures for ``ttl_s`` seconds,
    so a client RETRYING an id — after a dropped connection, a timeout, a
    jittered backoff — re-attaches to the original dispatch instead of
    running the request twice. The id
    is the idempotency key: reusing one within the TTL intentionally returns
    the original result. Thread-safe (futures resolve on worker threads
    while the event loop inserts)."""

    def __init__(self, ttl_s: float, clock: Callable[[], float] = time.monotonic):
        self.ttl_s = float(ttl_s)
        self.clock = clock
        self._lock = lockdep.Lock("DedupCache._lock")
        self._entries: dict = {}  # rid -> (future, inserted_at)
        self.hits = 0

    def get_or_submit(self, rid, submit: Callable[[], Future]) -> tuple[Future, bool]:
        """The cached future for ``rid`` (hit=True), or ``submit()``'s fresh
        one, recorded. Validation errors from ``submit`` propagate and cache
        nothing — a malformed retry must re-report, not pin the error."""
        now = self.clock()
        with self._lock:
            # amortized O(1) eviction: entries insert in time order (always
            # stamped with the current clock), so expired ones cluster at
            # the head of the insertion-ordered dict — pop until fresh. A
            # full-map rebuild here would be O(live entries) per request ON
            # THE EVENT LOOP (≈ rate · ttl entries), stalling every
            # connected client's reply path under sustained load.
            while self._entries:
                head = next(iter(self._entries))
                if now - self._entries[head][1] < self.ttl_s:
                    break
                del self._entries[head]
            ent = self._entries.get(rid)
            if ent is not None:
                self.hits += 1
                return ent[0], True
        fut = submit()
        with self._lock:
            self._entries[rid] = (fut, now)

        def _forget_unless_served(f, rid=rid):
            # only SERVED results stay pinned: a shed (breaker_open,
            # queue_full, deadline) never dispatched, and a failed dispatch
            # may succeed on retry — caching either would turn one brownout
            # rejection into a TTL-long outage for that id. (f is done here;
            # exception() inspects without re-raising into this callback.)
            keep = f.exception() is None and isinstance(f.result(), Prediction)
            if not keep:
                with self._lock:
                    cur = self._entries.get(rid)
                    if cur is not None and cur[0] is f:
                        del self._entries[rid]

        fut.add_done_callback(_forget_unless_served)
        return fut, False


async def _read_line(reader, timeout_s: float) -> bytes:
    """One framed line with the idle/read timeout applied (``timeout_s <= 0``
    waits forever). Always goes through ``wait_for``: a bare await here is
    how one dead peer pins a connection slot."""
    return await asyncio.wait_for(
        reader.readline(), timeout_s if timeout_s > 0 else None
    )


async def _handle(
    reader,
    writer,
    loop_,
    swap_fn: "Callable[..., dict] | None",
    conn_timeout_s: float = 0.0,
    dedup: DedupCache | None = None,
    ident: dict | None = None,
) -> None:
    try:
        while True:
            try:
                line = await _read_line(reader, conn_timeout_s)
            except asyncio.TimeoutError:
                # dead/stalled peer (or a slow-loris): reap the connection
                # with a typed reply — one silent client must never pin a
                # connection slot forever
                writer.write(b'{"ok": false, "reason": "idle_timeout"}\n')
                await writer.drain()
                break
            except (asyncio.LimitOverrunError, ValueError):
                # a line past serve.max_line_bytes: framing is lost mid-line,
                # so reply typed and CLOSE — resyncing would misparse the
                # oversized tail as fresh requests
                writer.write(
                    b'{"ok": false, "reason": '
                    b'"bad_request: line exceeds serve.max_line_bytes"}\n'
                )
                await writer.drain()
                break
            if not line:
                break
            try:
                msg = json.loads(line)
            except json.JSONDecodeError:
                # garbage or a partial line (a client that died mid-write):
                # typed reply, connection survives — the NEXT line is framed
                writer.write(b'{"ok": false, "reason": "bad_json"}\n')
                await writer.drain()
                continue
            if isinstance(msg, dict) and msg.get("op") == "health":
                # liveness/readiness verb: cheap by construction (no
                # histogram merge — see ReplicaPool.health), safe to poll at
                # 1 Hz from a router health check or the fleet controller
                reply = {"id": msg.get("id"), "ok": True, "health": loop_.health()}
                if dedup is not None:
                    reply["health"]["dedup_hits"] = dedup.hits
                if ident is not None:
                    # backend identity block: a front-door
                    # router keys its ejection bookkeeping and per-backend
                    # fleet rows on a STABLE host_id + listen address —
                    # anonymous replies cannot be attributed after a failover
                    reply["health"].update(ident)
                writer.write((json.dumps(reply) + "\n").encode())
                await writer.drain()
                continue
            if isinstance(msg, dict) and msg.get("op") == "metrics":
                # live observability verb: counters/histograms/request-path work of
                # the RUNNING server, no restart, no inference submitted. Off the
                # event loop: the merge copies+sorts every raw histogram sample,
                # which is O(requests served) on a long-lived server — it must
                # not stall every connected client's reply path while it runs.
                metrics_view = await asyncio.get_running_loop().run_in_executor(
                    None, loop_.live_metrics
                )
                if ident is not None:
                    metrics_view.update(ident)  # same identity block as health
                reply = {"id": msg.get("id"), "ok": True, "metrics": metrics_view}
                writer.write((json.dumps(reply) + "\n").encode())
                await writer.drain()
                continue
            if isinstance(msg, dict) and msg.get("op") == "events":
                # event-spine tail verb:
                # everything this process published since the caller's
                # cursor, with the explicit loss ledger. Cheap by
                # construction (bounded ring copy under one lock), so it
                # answers inline like health — the monitor's third verb.
                try:
                    cur = msg.get("cursor")
                    if cur is not None and not isinstance(cur, dict):
                        raise ValueError(
                            f"events cursor must be an object, got {cur!r}"
                        )
                    tail = ensure_bus().tail(
                        cur, limit=int(msg.get("limit") or 512)
                    )
                    reply = {"id": msg.get("id"), "ok": True, "events": tail}
                except (TypeError, ValueError) as e:
                    reply = {"id": msg.get("id"), "ok": False,
                             "reason": f"bad_request: {e}"}
                writer.write((json.dumps(reply) + "\n").encode())
                await writer.drain()
                continue
            if isinstance(msg, dict) and msg.get("op") == "swap":
                # zero-downtime deploy verb: re-restore the newest checkpoints
                # (or the EXPLICIT per-family "tags" the client pins — the
                # deployer's path, so a stale *_best can never shadow a freshly
                # fine-tuned *_last) and hot-swap them under live traffic
                # (engine.swap_params — no new warmup, in-flight batches keep
                # the old weights). Off the event loop: the checkpoint load and
                # the copy to the card are host work that must not stall connected clients'
                # reply paths.
                if swap_fn is None:
                    reply = {"id": msg.get("id"), "ok": False,
                             "reason": "swap_unavailable: server has no checkpoint workdir"}
                else:
                    try:
                        tags = msg.get("tags")
                        if tags is not None and not (
                            isinstance(tags, dict)
                            and all(
                                isinstance(k, str) and isinstance(v, str)
                                for k, v in tags.items()
                            )
                        ):
                            raise ValueError(f"swap tags must be a str->str map, got {tags!r}")
                        rec = await asyncio.get_running_loop().run_in_executor(
                            None, swap_fn, tags
                        )
                        reply = {"id": msg.get("id"), "ok": True, "swap": rec}
                    except (FileNotFoundError, ValueError, RuntimeError) as e:
                        # a missing/mismatched/CORRUPT checkpoint is a
                        # client-visible deploy failure (CheckpointRestoreError
                        # lands here too), not a reason to kill the server —
                        # the old params keep serving (swap validated first)
                        reply = {"id": msg.get("id"), "ok": False,
                                 "reason": f"swap_failed: {e}"}
                writer.write((json.dumps(reply) + "\n").encode())
                await writer.drain()
                continue
            if isinstance(msg, dict) and msg.get("op") == "scale":
                # replica autoscaling verb: resize the pool under live traffic
                # (drain-safe — ReplicaPool.remove_replica never sheds a queue
                # peers still drain). The fleet controller's remote lever.
                if not hasattr(loop_, "scale_to"):
                    reply = {"id": msg.get("id"), "ok": False,
                             "reason": "scale_unavailable: server is not a replica pool"}
                else:
                    try:
                        n = int(msg["replicas"])
                        rec = await asyncio.get_running_loop().run_in_executor(
                            None, loop_.scale_to, n
                        )
                        reply = {"id": msg.get("id"), "ok": True, "scale": rec}
                    except (KeyError, TypeError, ValueError) as e:
                        reply = {"id": msg.get("id"), "ok": False,
                                 "reason": f"bad_request: {e}"}
                writer.write((json.dumps(reply) + "\n").encode())
                await writer.drain()
                continue
            try:
                # every well-formed line gets a typed reply — a missing/ragged
                # "x", a non-object message, a bad deadline are client errors,
                # not reasons to drop the connection (or touch the worker).
                # Explicit ids are IDEMPOTENCY KEYS: a retried id within the
                # dedup TTL re-attaches to the original dispatch (never
                # double-dispatches) and gets the identical reply.
                rid = msg.get("id") if isinstance(msg, dict) else None

                def _submit(m=msg):
                    return loop_.submit(
                        np.asarray(m["x"], np.float32),
                        rid=m.get("id"),
                        deadline_ms=m.get("deadline_ms"),
                        # optional wire field: "trace": true forces a phase
                        # trace for THIS request (a router propagating its
                        # sampling decision downstream); absent = the
                        # server's own serve.trace_sample decides
                        trace=True if m.get("trace") else None,
                    )

                if dedup is not None and rid is not None:
                    fut, _ = dedup.get_or_submit(rid, _submit)
                else:
                    fut = _submit()
            except (KeyError, TypeError, ValueError) as e:
                rid = msg.get("id") if isinstance(msg, dict) else None
                writer.write(
                    (json.dumps({"id": rid, "ok": False, "reason": f"bad_request: {e}"}) + "\n").encode()
                )
                await writer.drain()
                continue
            try:
                res = await asyncio.wrap_future(fut)
            except Exception as e:
                writer.write(
                    (json.dumps({
                        "id": rid, "ok": False,
                        "reason": f"server_error: {type(e).__name__}: {e}",
                    }) + "\n").encode()
                )
                await writer.drain()
                continue
            writer.write((json.dumps(_encode(res)) + "\n").encode())
            await writer.drain()
    except (ConnectionResetError, BrokenPipeError):
        # the peer vanished mid-exchange (socket_drop chaos class, a killed
        # client): nothing to tell them, nothing stranded — any in-flight
        # future resolved above (or resolves server-side and is dropped),
        # and the dedup cache keeps the result for the retry
        pass
    finally:
        try:
            writer.close()
        except RuntimeError:
            pass  # event loop already closed: test/server teardown path


async def serve_async(
    loop_,
    host: str,
    port: int,
    ready: "asyncio.Future | None" = None,
    swap_fn: "Callable[..., dict] | None" = None,
    conn_timeout_s: float | None = None,
    max_line_bytes: int | None = None,
    dedup_ttl_s: float | None = None,
    host_id: str | None = None,
) -> None:
    """Accept connections until cancelled; resolves ``ready`` with the bound
    port (port=0 binds an ephemeral port — how the tests avoid collisions).
    ``loop_`` is a :class:`ServeLoop` or :class:`ReplicaPool` (both expose
    ``submit``/``live_metrics``/``health``; a pool additionally serves the
    ``{"op": "scale"}`` autoscaling verb); ``swap_fn(tags=None)`` arms the
    ``{"op": "swap"}`` verb. The hardening knobs (per-connection idle/read
    timeout, max line bytes, dedup TTL) default to the serving config's
    values (``serve.conn_timeout_s`` / ``max_line_bytes`` / ``dedup_ttl_s``);
    pass explicit values to override. ``host_id`` is the stable backend
    identity stamped (with the listen address) into every ``health`` and
    ``metrics`` reply — the fleet router's ejection bookkeeping and
    per-backend rows key on it; the default is unique per process AND per
    listening endpoint, so in-process multi-server tests never collide."""
    serve_cfg = loop_.engine.cfg.serve
    conn_timeout_s = (
        serve_cfg.conn_timeout_s if conn_timeout_s is None else conn_timeout_s
    )
    max_line_bytes = (
        serve_cfg.max_line_bytes if max_line_bytes is None else max_line_bytes
    )
    dedup_ttl_s = serve_cfg.dedup_ttl_s if dedup_ttl_s is None else dedup_ttl_s
    dedup = DedupCache(dedup_ttl_s) if dedup_ttl_s > 0 else None
    ident_box: dict = {}
    server = await asyncio.start_server(
        lambda r, w: _handle(
            r, w, loop_, swap_fn, conn_timeout_s=conn_timeout_s, dedup=dedup,
            ident=ident_box,
        ),
        host=host,
        port=port,
        limit=max_line_bytes,
    )
    bound = server.sockets[0].getsockname()[1]
    if host_id is None:
        host_id = f"{socket.gethostname()}-{os.getpid()}-p{bound}"
    ident_box.update({"host_id": host_id, "listen": f"{host}:{bound}"})
    if ready is not None and not ready.done():
        ready.set_result(bound)
    async with server:
        await server.serve_forever()


def run_server(
    cfg: ExperimentConfig,
    engine: ServeEngine,
    logger=None,
    workdir: str | None = None,
    ready: Future | None = None,
) -> None:
    """Blocking entry of ``serve``: warm, bind, announce, serve until
    interrupted; flush the serving counters on the way out. ``workdir`` arms
    the ``{"op": "swap"}`` hot-swap verb (the newest checkpoints, or the
    tags the request pins). The banner prints after the socket is bound,
    with the actual port (``--serve.port=0`` binds an ephemeral one) and the
    stable ``host_id``: how a spawner learns where its backend listens.

    ``ready`` (a ``concurrent.futures.Future``), when given, resolves after
    the banner with ``{"port", "stop"}``: ``stop()`` ends the server from any
    thread, through the event loop's ``call_soon_threadsafe``, and
    ``run_server`` then returns."""
    pool = ReplicaPool(engine, workers=cfg.serve.workers, sink=logger).start()
    host_id = f"{socket.gethostname()}-{os.getpid()}"
    swap_fn = (
        None
        if workdir is None
        else (lambda tags=None: engine.swap_from_workdir(workdir, tags=tags))
    )

    async def _serve_announced() -> None:
        aloop = asyncio.get_running_loop()
        bound: asyncio.Future = aloop.create_future()
        task = aloop.create_task(
            serve_async(
                pool, cfg.serve.host, cfg.serve.port, bound,
                swap_fn=swap_fn, host_id=host_id,
            )
        )
        # wait on BOTH: a bind failure must propagate, not hang on `bound`
        await asyncio.wait({task, bound}, return_when=asyncio.FIRST_COMPLETED)
        if task.done():
            return task.result()
        print(
            json.dumps(
                {
                    "serving": f"{cfg.serve.host}:{bound.result()}",
                    "host_id": host_id,
                    "buckets": list(engine.buckets),
                    "batching": engine.batching_summary(),
                    "replicas": pool.n_replicas,
                    "workers": pool.workers,
                    "supervised": cfg.serve.supervise,
                    "breaker": cfg.serve.breaker,
                    "mesh": engine.mesh_topology(),
                    "sharding": engine.bucket_sharding or None,
                    # post-warmup counters: anything non-zero here (or later)
                    # is a measurement, table write or kernel build the warmup missed
                    "compile_cache_after_warmup": engine.request_path_work(),
                    # per-bucket cost of the warmup forward
                    "cost": engine.bucket_cost,
                }
            ),
            flush=True,
        )
        if ready is not None:
            ready.set_result({
                "port": bound.result(),
                "stop": lambda: aloop.call_soon_threadsafe(task.cancel),
            })
        await task

    try:
        asyncio.run(_serve_announced())
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        pool.stop(drain=False)
        # merged across every replica's workers: the same aggregate the
        # metrics verb serves
        pool.merged_metrics(sink=logger).flush(
            compile_cache=engine.request_path_work(),
            workers=pool.workers,
            replicas=pool.n_replicas,
            breaker=None if pool.breaker is None else pool.breaker.summary(),
        )
