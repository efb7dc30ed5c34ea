"""Fleet router core (``qdml_tpu/fleet/router.py``): per-backend tables, ejection, balancing, verb fan-out.

One :class:`FleetRouter` fronts N backend ``serve`` processes ("hosts"). It
speaks nothing new on the wire: every forward is one
:class:`~qdml_tpu_torch.serve.client.ServeClient` exchange carrying the
client's retry/dedup/deadline contract, and every verb the router serves is
the backend verb fanned out or aggregated:

- **inference**: pick a backend (consistent hashing on the request id, or
  least queue depth over the health poll's cached view), forward, and fail
  over to the next live host on a transport failure. Retries of one id are
  deduped fleet-wide by the router (:class:`RouterDedup`): a retried id
  re-attaches to the in-flight or just-served forward even when its backend
  has since been ejected; the server-side dedup window holds only within
  one host.
- **ejection / re-admission**: per-backend :class:`BackendState` runs the
  breaker's state machine (``serve/breaker.py``'s states: closed -> open on
  ``eject_failures`` consecutive transport failures, open -> half-open
  after ``eject_s``, half-open closes after ``readmit_probes`` successful
  probes and re-opens on one failure). The health poll thread drives
  re-admission even with no traffic.
- **swap**: fans to every live backend at once, all-or-report-partial:
  each live backend's outcome by host_id, ejected hosts listed as skipped
  (they re-read the newest checkpoints when restarted), ``ok`` true iff
  every LIVE backend swapped.
- **scale**: a fleet-total replica target; the router differences it
  against the polled per-host counts and grows the deepest-queue host /
  shrinks the shallowest-queue host one replica at a time.
- **membership**: :meth:`FleetRouter.add_backend` splices a warmed host into
  the consistent-hash ring (the lifecycle manager, ``fleet/lifecycle.py``,
  verifies warm=true and zero request-path work first), and
  :meth:`FleetRouter.retire_backend` is drain-then-remove. Ring points are
  keyed on the stable backend address (md5, as JAX's), so a resize moves
  only the added/removed host's arcs and a ring over the same backend list
  assigns every id as JAX's does.
- **metrics / health**: counters (completed, sheds, SLO n/met,
  per-scenario counts and confidence sums, dispatch rows, the request-path
  work ledger) sum exactly across hosts; wire latency is the router's own
  per-backend histograms merged by the exact ``Histogram.merge``; each
  backend's own latency summary rides in the per-backend rows.

Thread model: the asyncio front door (``fleet/frontend.py``) runs
:meth:`FleetRouter.request` on executor threads; each backend keeps a small
borrow/return pool of ``ServeClient`` connections (one per in-flight
exchange). The ejection state machine, the dedup table, the ring and the
counters are the cross-thread state, each behind its own lock. Pure host
code: nothing here imports torch.
"""

from __future__ import annotations

import hashlib
import threading

import time
from bisect import bisect_right
from concurrent.futures import ThreadPoolExecutor
from typing import Callable

from qdml_tpu_torch.serve.breaker import CLOSED, HALF_OPEN, OPEN
from qdml_tpu_torch.serve.client import ServeClient, ServeClientError
from qdml_tpu_torch.telemetry.counters import Histogram
from qdml_tpu_torch.telemetry.events import ensure_bus
from qdml_tpu_torch.telemetry.events import publish as publish_event
from qdml_tpu_torch.telemetry.spans import get_sink
from qdml_tpu_torch.telemetry.tracing import trace_sampled
from qdml_tpu_torch.utils import lockdep

# transport-level failures that count against a backend's ejection state;
# a typed ok=false REPLY (bad_request, shed) is a healthy backend answering
_FORWARD_ERRORS = (ServeClientError, ConnectionError, TimeoutError, OSError)

_RING_VNODES = 64  # virtual nodes per backend on the consistent-hash ring


def _emit_event(name: str, **fields) -> None:
    """Structured fleet event (backend_ejected / backend_readmitted /
    fleet_lifecycle / router_swap) into the run's telemetry stream, if one
    is active — and onto the process-global event spine always, so the
    front door's ``{"op": "events"}`` tail sees the router tier's own
    events alongside the per-backend ones it aggregates."""
    sink = get_sink()
    if sink is not None and getattr(sink, "active", False):
        sink.emit("counters", name=name, **fields)
    publish_event(name, tier="router", **fields)


def _hash_point(key: str) -> int:
    return int.from_bytes(hashlib.md5(key.encode()).digest()[:8], "big")


def _ring_points(backends: list) -> tuple[list[int], list[int]]:
    """(sorted ring points, parallel backend-index list) over the non-
    draining members. Points are keyed on the stable address, so a host
    contributes the SAME points in every rebuild — membership changes move
    only the changed host's arcs (the bounded-key-movement property)."""
    points = sorted(
        (_hash_point(f"{b.addr}#{v}"), i)
        for i, b in enumerate(backends)
        if not b.draining
        for v in range(_RING_VNODES)
    )
    return [p for p, _ in points], [i for _, i in points]


def parse_backends(spec: str, default: tuple[str, int] | None = None) -> list[tuple[str, int]]:
    """``"host:port,host:port"`` -> address list (``fleet.backends``).
    Empty spec falls back to ``default`` (the single local serve endpoint)."""
    addrs: list[tuple[str, int]] = []
    for part in (p.strip() for p in spec.split(",") if p.strip()):
        host, _, port = part.rpartition(":")
        if not host or not port.isdigit():
            raise ValueError(f"bad backend endpoint {part!r}; expected host:port")
        addrs.append((host, int(port)))
    if not addrs:
        if default is None:
            raise ValueError("fleet.backends is empty and no default endpoint given")
        addrs = [default]
    return addrs


class BackendState:
    """Per-backend ejection state machine — the serve/breaker.py shape
    (closed/open/half-open, hysteresis via probes) keyed on transport
    failures instead of queue depth: ``eject_failures`` CONSECUTIVE failures
    open (eject) the backend, ``eject_s`` later it half-opens, and
    ``readmit_probes`` consecutive successful probes close (re-admit) it;
    one half-open failure re-opens. Clock injected for deterministic tests."""

    def __init__(
        self,
        eject_failures: int = 3,
        eject_s: float = 1.0,
        readmit_probes: int = 2,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.eject_failures = max(1, int(eject_failures))
        self.eject_s = float(eject_s)
        self.readmit_probes = max(1, int(readmit_probes))
        self.clock = clock
        self._lock = lockdep.Lock("BackendState._lock")
        self._state = CLOSED
        self._fails = 0        # consecutive failures while closed
        self._oks = 0          # consecutive half-open probe successes
        self._opened_at = 0.0
        self._ejections = 0
        self._readmissions = 0

    def allow(self, now: float | None = None) -> bool:
        """May this backend receive a request/probe now? Runs the open ->
        half-open transition (time-based), so polling allow() alone is
        enough to start re-admission probing."""
        now = self.clock() if now is None else now
        with self._lock:
            if self._state == OPEN:
                if now - self._opened_at < self.eject_s:
                    return False
                self._state = HALF_OPEN
                self._oks = 0
            return True  # closed and half-open both admit (probes bounded by caller traffic)

    def record_success(self) -> bool:
        """One successful exchange/probe; True iff this one RE-ADMITTED the
        backend (half-open -> closed edge)."""
        with self._lock:
            self._fails = 0
            if self._state == HALF_OPEN:
                self._oks += 1
                if self._oks >= self.readmit_probes:
                    self._state = CLOSED
                    self._readmissions += 1
                    return True
            return False

    def record_failure(self, now: float | None = None) -> bool:
        """One transport failure; True iff this one EJECTED the backend
        (closed/half-open -> open edge)."""
        now = self.clock() if now is None else now
        with self._lock:
            if self._state == HALF_OPEN:
                self._state = OPEN
                self._opened_at = now
                self._ejections += 1
                return True
            if self._state == CLOSED:
                self._fails += 1
                if self._fails >= self.eject_failures:
                    self._state = OPEN
                    self._opened_at = now
                    self._ejections += 1
                    return True
            else:  # already open: refresh the ejection clock
                self._opened_at = now
            return False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def live(self) -> bool:
        """Closed or half-open — the backend may receive traffic."""
        with self._lock:
            return self._state != OPEN

    def summary(self) -> dict:
        with self._lock:
            return {
                "state": self._state,
                "consecutive_failures": self._fails,
                "ejections": self._ejections,
                "readmissions": self._readmissions,
            }


class Backend:
    """One backend host: address, learned identity, ejection state, a small
    borrow/return pool of :class:`ServeClient` connections, the health
    poll's cached facts, and the router-side wire-latency histogram."""

    def __init__(
        self,
        host: str,
        port: int,
        timeout_s: float = 10.0,
        retries: int = 1,
        eject_failures: int = 3,
        eject_s: float = 1.0,
        readmit_probes: int = 2,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.host = host
        self.port = int(port)
        self.addr = f"{host}:{port}"
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self._seed = int(seed)
        self.state = BackendState(
            eject_failures=eject_failures, eject_s=eject_s,
            readmit_probes=readmit_probes, clock=clock,
        )
        # identity learned from the first health reply (serve stamps host_id
        # + listen into every health/metrics reply); the address stands in
        # until the backend has answered once
        self.host_id: str = self.addr
        self.listen: str | None = None
        # draining flag: set by the router's retirement path AFTER the
        # host's vnodes leave the ring; readers (poll rows, balancing,
        # fan-outs) see it as a typed "draining" state. A plain bool,
        # replaced atomically, never mutated in place
        self.draining: bool = False
        # health-poll cache (single-writer poll thread, newest-wins reads)
        self.queue_depth: int = 0
        self.replicas: int = 0
        self.swap_epoch: int = 0
        # restart-visibility epoch forwarded from the backend's health reply:
        # a monitor behind the router sees
        # per-backend restarts without polling each host itself
        self.uptime_s: float | None = None
        self.start_seq: int | None = None
        self.last_poll_ts: float = 0.0
        self.poll_ok: bool = False
        # router-side wire metrics, guarded by _mlock (request threads add
        # concurrently; Histogram is a plain list underneath)
        self._mlock = lockdep.Lock("Backend._mlock")
        self._latency = Histogram()
        self._forwarded = 0
        self._failed = 0
        # forwards currently on the wire to this host — the retirement
        # drain's "in-flight reaches zero" condition reads it
        self._inflight = 0
        # connection pool (LIFO: reuse the warmest socket first)
        self._clients: list[ServeClient] = []
        self._clients_lock = lockdep.Lock("Backend._clients_lock")
        self._made = 0

    # -- connection pool ----------------------------------------------------

    def _borrow(self) -> ServeClient:
        with self._clients_lock:
            if self._clients:
                return self._clients.pop()
            self._made += 1
            n = self._made
        return ServeClient(
            self.host, self.port, timeout_s=self.timeout_s,
            retries=self.retries, seed=self._seed * 997 + n,
        )

    def _restore(self, client: ServeClient) -> None:
        with self._clients_lock:
            self._clients.append(client)

    def close(self) -> None:
        with self._clients_lock:
            clients, self._clients = self._clients, []
        for c in clients:
            c.close_connection()

    # -- exchanges ----------------------------------------------------------

    def call(self, msg: dict, timeout_s: float | None = None,
             idempotent: bool = True) -> dict:
        """One request/reply exchange through the pool, with the router-side
        wire-latency and forward accounting. Transport failures propagate
        (the router's failover loop owns record_failure/record_success)."""
        client = self._borrow()
        with self._mlock:
            self._inflight += 1
        t0 = time.perf_counter()
        try:
            rep = client.call(
                msg, timeout_s=timeout_s,
                deadline_ms=msg.get("deadline_ms"), idempotent=idempotent,
            )
        except BaseException:
            with self._mlock:
                self._failed += 1
                self._inflight -= 1
            self._restore(client)
            raise
        with self._mlock:
            self._forwarded += 1
            self._inflight -= 1
            self._latency.add(time.perf_counter() - t0)
        self._restore(client)
        return rep

    def inflight(self) -> int:
        """Forwards currently on the wire to this host (the drain gate)."""
        with self._mlock:
            return self._inflight

    def wire_metrics(self) -> tuple[Histogram, int, int]:
        """(latency histogram copy, forwarded, failed) under the lock — the
        aggregation's exact-merge input."""
        with self._mlock:
            h = Histogram()
            h.merge(self._latency)
            return h, self._forwarded, self._failed

    def poll_row(self) -> dict:
        """The cheap per-backend health row (no backend round-trip — the
        poll thread's cached view)."""
        age = None if not self.last_poll_ts else round(
            time.monotonic() - self.last_poll_ts, 4
        )
        row = {
            "host_id": self.host_id,
            "addr": self.addr,
            "listen": self.listen,
            "queue_depth": self.queue_depth,
            "replicas": self.replicas,
            "swap_epoch": self.swap_epoch,
            "uptime_s": self.uptime_s,
            "start_seq": self.start_seq,
            "poll_ok": self.poll_ok,
            "poll_age_s": age,
            **self.state.summary(),
        }
        if self.draining:
            # the typed retirement state: off the ring, finishing in-flight
            # work; distinct from an ejection (involuntary, re-admits)
            row["state"] = "draining"
        return row


class RouterDedup:
    """Fleet-wide idempotent-id dedup: one entry per in-flight (or recently
    SERVED) request id, so a retried id re-attaches to the original forward
    — across router failover, not just within one backend's server-side
    window (the server's DedupCache discipline, lifted one tier). Entries
    insert in clock order, so TTL eviction pops from the head (amortized
    O(1), same argument as serve/server.DedupCache). Only ok replies stay
    pinned: a failed/shed forward is forgotten the moment it completes, so
    the client's next retry re-dispatches."""

    def __init__(self, ttl_s: float, clock: Callable[[], float] = time.monotonic):
        self.ttl_s = float(ttl_s)
        self.clock = clock
        self._lock = lockdep.Lock("RouterDedup._lock")
        self._entries: dict = {}  # rid -> {"ev": Event, "rep": dict|None, "ts": float}
        self.hits = 0

    def begin(self, rid) -> tuple[dict, bool]:
        """(entry, fresh): fresh=True means this caller owns the forward and
        must call :meth:`finish`; fresh=False means wait on ``entry["ev"]``
        and read ``entry["rep"]`` (the retry re-attachment path)."""
        now = self.clock()
        with self._lock:
            while self._entries:
                head = next(iter(self._entries))
                ent = self._entries[head]
                if now - ent["ts"] < self.ttl_s or not ent["ev"].is_set():
                    break  # fresh, or still in flight (never evict in-flight)
                del self._entries[head]
            ent = self._entries.get(rid)
            if ent is not None:
                self.hits += 1
                return ent, False
            ent = {"ev": threading.Event(), "rep": None, "ts": now}
            self._entries[rid] = ent
            return ent, True

    def finish(self, rid, entry: dict, rep: dict | None) -> None:
        """Resolve the entry for every waiter; pin it only when ``rep`` is a
        served ok reply."""
        entry["rep"] = rep
        entry["ev"].set()
        pin = isinstance(rep, dict) and rep.get("ok") is True
        if not pin:
            with self._lock:
                cur = self._entries.get(rid)
                if cur is entry:
                    del self._entries[rid]


def _trace_prepend_router(rep: dict, rid, pick_s: float | None,
                          attempts: list[dict]) -> dict:
    """Compose the reply's wire-format trace: router spans (balancing pick,
    one ``wire`` span per attempt — failed attempts included, so failover
    retries read as separate spans) PREPENDED to the backend's own phases.
    All router durations are router-clock measurements of router-owned
    intervals; the backend's phase durations pass through untouched. The
    successful attempt's wire span is NET — its exchange duration minus the
    backend's own reported serve total — so the phase list PARTITIONS the
    request's time instead of counting the backend twice; that subtraction
    is duration-minus-duration (clock-skew-free — what is never done is
    differencing the two hosts' timestamps). Failed attempts have no server
    total: their wire span is the full measured attempt."""
    if not isinstance(rep, dict):
        return rep
    rep = dict(rep)
    backend_tr = rep.get("trace") if isinstance(rep.get("trace"), dict) else {}
    phases: list = []
    if pick_s is not None:
        phases.append(["pick", round(pick_s * 1e3, 3)])
    phases += [["wire", a["wire_ms"]] for a in attempts]
    phases += list(backend_tr.get("phases") or [])
    detail = dict(backend_tr.get("detail") or {})
    detail["router"] = {
        "attempts": attempts,
        "failover_retries": sum(1 for a in attempts if not a.get("ok")),
    }
    tr: dict = {"id": rid, "phases": phases, "detail": detail}
    if isinstance(backend_tr.get("total_ms"), (int, float)):
        # the backend's enqueue->resolve total (ITS clock): kept verbatim —
        # the client-side reconciliation compares its OWN wall clock against
        # the phase-duration sum, never against this foreign timestamp base
        tr["total_ms"] = backend_tr["total_ms"]
    rep["trace"] = tr
    return rep


def _trace_dedup_reattach(rep: dict, rid, wait_s: float) -> dict:
    """Trace for a retry that re-attached to the original in-flight forward:
    one ``dedup_wait`` span (this retry dispatched NOTHING) prepended to the
    original reply's trace, plus the ``dedup_reattached`` detail flag."""
    if not isinstance(rep, dict):
        return rep
    rep = dict(rep)
    orig = rep.get("trace") if isinstance(rep.get("trace"), dict) else {}
    detail = dict(orig.get("detail") or {})
    detail["dedup_reattached"] = True
    tr = {
        "id": rid,
        "phases": [["dedup_wait", round(wait_s * 1e3, 3)]]
        + list(orig.get("phases") or []),
        "detail": detail,
    }
    if isinstance(orig.get("total_ms"), (int, float)):
        tr["total_ms"] = orig["total_ms"]
    rep["trace"] = tr
    return rep


class FleetRouter:
    """The front-door fan-out over per-host replica pools."""

    def __init__(
        self,
        backends: list[tuple[str, int]],
        balance: str = "hash",
        timeout_s: float = 10.0,
        retries: int = 1,
        eject_failures: int = 3,
        eject_s: float = 1.0,
        readmit_probes: int = 2,
        poll_interval_s: float = 0.5,
        failover: int = 2,
        dedup_ttl_s: float = 30.0,
        seed: int = 0,
        clock: Callable[[], float] = time.monotonic,
        trace_sample: float = 0.0,
    ):
        if balance not in ("hash", "least_queue"):
            raise ValueError(f"fleet.balance must be hash|least_queue, got {balance!r}")
        if not backends:
            raise ValueError("a fleet router needs at least one backend")
        self.balance = balance
        self.failover = max(0, int(failover))
        self.poll_interval_s = float(poll_interval_s)
        # Request-tracing sample rate (telemetry/tracing.py, same knob the
        # serve tier reads — serve.trace_sample): a sampled (or client-forced
        # "trace": true) request is forwarded with the trace bit set so the
        # backend decomposes its own latency, and the router PREPENDS its
        # tier's spans — balancing pick, one wire span PER ATTEMPT (failover
        # retries stay visible as separate spans), dedup re-attachment wait.
        # Every router span is measured on the router's own clock around its
        # own send->reply exchange; backend clocks are never read.
        self.trace_sample = float(trace_sample)
        # per-backend construction knobs, kept so an elastically ADDED host
        # gets the same contract as the boot-time set
        self._backend_opts = dict(
            timeout_s=timeout_s, retries=retries,
            eject_failures=eject_failures, eject_s=eject_s,
            readmit_probes=readmit_probes, clock=clock,
        )
        self._seed = int(seed)
        self.backends = [
            Backend(h, p, seed=seed + i, **self._backend_opts)
            for i, (h, p) in enumerate(backends)
        ]
        self._next_backend_seq = len(self.backends)
        self.dedup = RouterDedup(dedup_ttl_s) if dedup_ttl_s > 0 else None
        # a re-attached retry must outwait the WHOLE failover sweep the
        # original forward may legitimately still be walking — budgeting for
        # one backend's retries alone would time the waiter out (typed
        # router_timeout) on a request that then completes and pins
        self._dedup_wait_s = (self.failover + 1) * timeout_s * (retries + 1) + 5.0
        # consistent-hash ring: _RING_VNODES virtual points per backend,
        # keyed on the STABLE address (host_ids are learned later) — adding
        # or removing a host moves ONLY its own arcs (~1/N of the id space);
        # every surviving host's points are bit-identical across rebuilds.
        # Membership changes REPLACE ring + index + backend list together
        # under _ring_lock; the lists themselves are never mutated in place,
        # so a reader's snapshot is always internally consistent.
        self._ring_lock = lockdep.Lock("FleetRouter._ring_lock")
        self._ring, self._ring_idx = _ring_points(self.backends)
        self._failovers = 0
        self._no_backend = 0
        self._counter_lock = lockdep.Lock("FleetRouter._counter_lock")
        # traced requests' NET wire spans (exchange minus backend-reported
        # serve total; failed attempts at full duration) — raw samples live
        # HERE, so the fleet phase table's wire row has exact quantiles while
        # backend phases aggregate by exact (n, sum). Request executor
        # threads add concurrently: every touch holds _trace_lock.
        self._trace_lock = lockdep.Lock("FleetRouter._trace_lock")
        self._trace_wire = Histogram()
        self._poll_stop = threading.Event()
        self._poll_thread: threading.Thread | None = None
        # the router's own restart-visibility epoch (same contract as the
        # backends': a monitor scraping the front detects a router restart)
        self._monitor_t0 = time.monotonic()
        self._start_seq = int(time.time() * 1000)

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "FleetRouter":
        """Prime the backend table with one synchronous health sweep (learn
        host_ids, mark dead hosts before the first request), then start the
        poll thread."""
        self.poll_once()
        if self._poll_thread is None:
            self._poll_stop.clear()
            self._poll_thread = threading.Thread(
                target=self._poll_loop, daemon=True, name="fleet-router-poll"
            )
            self._poll_thread.start()
        return self

    def stop(self) -> None:
        if self._poll_thread is not None:
            self._poll_stop.set()
            self._poll_thread.join(timeout=10.0)
            self._poll_thread = None
        for b in self.backends:
            b.close()

    # -- health polling (ejection + re-admission + least-queue freshness) ----

    def _poll_loop(self) -> None:
        while not self._poll_stop.wait(self.poll_interval_s):
            try:
                self.poll_once()
            except Exception as e:  # lint: disable=broad-except(the poll thread is the re-admission engine: a transient poll failure must be reported and survived, not end health tracking for the whole fleet)
                _emit_event("router_poll_error", error=f"{type(e).__name__}: {e}")

    def poll_once(self) -> None:
        """One health sweep over every backend: refresh the cached queue
        depth/replica count/identity, and feed the ejection state machine —
        a dead host ejects without traffic, and an ejected host's successful
        probes re-admit it without traffic. Draining hosts stay in the sweep:
        the monitor keeps seeing their typed state until retirement."""
        for b in list(self.backends):
            self._poll_backend(b)

    def _poll_backend(self, b: Backend) -> None:
        if not b.state.allow():
            return  # still inside its eject window: no probe yet
        try:
            rep = b.call({"op": "health"}, timeout_s=min(b.timeout_s, 2.0))
            h = rep.get("health") or {}
        except _FORWARD_ERRORS as e:
            b.poll_ok = False
            if b.state.record_failure():
                _emit_event(
                    "backend_ejected", backend=b.host_id, addr=b.addr,
                    reason=f"health_poll: {type(e).__name__}",
                )
            return
        b.poll_ok = True
        b.last_poll_ts = time.monotonic()
        b.queue_depth = int(h.get("queue_depth") or 0)
        b.replicas = int(h.get("replicas") or h.get("workers") or 1)
        b.swap_epoch = int(h.get("swap_epoch") or 0)
        if h.get("uptime_s") is not None:
            b.uptime_s = float(h["uptime_s"])
        if h.get("start_seq") is not None:
            b.start_seq = int(h["start_seq"])
        if h.get("host_id"):
            b.host_id = str(h["host_id"])
        if h.get("listen"):
            b.listen = str(h["listen"])
        if b.state.record_success():
            _emit_event(
                "backend_readmitted", backend=b.host_id, addr=b.addr
            )

    # -- elastic membership -------------------------------------------------

    def add_backend(self, host: str, port: int) -> Backend:
        """Splice one backend into the fleet: ring resize moving only the
        NEW host's arcs. The caller owns the admission criteria — the
        lifecycle manager (fleet/lifecycle.py) health-verifies warm=true and
        zero request-path compiles BEFORE calling this; the router itself
        only refuses duplicates. Emits ``backend_admitted``."""
        addr = f"{host}:{int(port)}"
        if any(b.addr == addr for b in self.backends):
            raise ValueError(f"backend {addr} is already a fleet member")
        with self._ring_lock:
            b = Backend(
                host, int(port),
                seed=self._seed + self._next_backend_seq, **self._backend_opts,
            )
            self._next_backend_seq += 1
            self.backends = self.backends + [b]
            self._ring, self._ring_idx = _ring_points(self.backends)
        # learn identity (host_id/listen) immediately so membership events
        # and per-backend rows attribute to the stable id, not the address
        self._poll_backend(b)
        _emit_event("backend_admitted", backend=b.host_id, addr=b.addr)
        return b

    def _find_backend(self, key) -> Backend:
        for b in self.backends:
            if b is key or b.host_id == key or b.addr == key:
                return b
        raise KeyError(f"no fleet member {key!r}")

    def begin_retire(self, key) -> Backend:
        """Start drain-then-retire for one member (by Backend, host_id, or
        address): its vnodes leave the ring NOW — fresh requests stop
        hashing to it, surviving hosts keep every key they had — and the
        host reports the typed ``draining`` state until removal. Refuses to
        drain the last non-draining member."""
        b = self._find_backend(key)
        with self._ring_lock:
            if b.draining:
                return b
            remaining = [
                x for x in self.backends if not x.draining and x is not b
            ]
            if not remaining:
                raise ValueError(
                    f"cannot retire {b.host_id}: it is the last fleet member"
                )
            b.draining = True
            self._ring, self._ring_idx = _ring_points(self.backends)
        _emit_event("backend_draining", backend=b.host_id, addr=b.addr)
        return b

    def finish_retire(self, key) -> dict:
        """Remove a drained member from the table and close its connection
        pool. The router's dedup entries for replies it served stay pinned
        for the TTL — a retry issued across the retirement re-attaches at
        the ROUTER and never needs the departed host. Emits
        ``backend_retired``."""
        b = self._find_backend(key)
        with self._ring_lock:
            self.backends = [x for x in self.backends if x is not b]
            self._ring, self._ring_idx = _ring_points(self.backends)
        b.close()
        _emit_event("backend_retired", backend=b.host_id, addr=b.addr)
        return {"backend": b.host_id, "addr": b.addr,
                "inflight_at_removal": b.inflight()}

    def retire_backend(
        self, key, wait_s: float = 30.0, poll_s: float = 0.05
    ) -> dict:
        """The blocking drain-then-remove composition: stop admitting (ring
        resize), wait for the host's in-flight forwards to reach zero
        (bounded by ``wait_s``), then remove it. Returns the drain record;
        ``drained`` is False iff the wait timed out with forwards still on
        the wire (the record reports how many)."""
        b = self.begin_retire(key)
        deadline = time.monotonic() + float(wait_s)
        while b.inflight() > 0 and time.monotonic() < deadline:
            time.sleep(poll_s)
        stranded = b.inflight()
        rec = self.finish_retire(b)
        rec.update(drained=stranded == 0, inflight_at_removal=stranded)
        return rec

    # -- balancing ----------------------------------------------------------

    def _candidates(self, rid) -> list[Backend]:
        """Backend preference order for one request id: the hash ring walked
        from the id's point (stable id -> host affinity, so retries land
        where the server-side dedup window holds), or the live backends by
        ascending polled queue depth. Draining hosts are off the ring (and
        filtered from the queue-depth order): a retiring backend receives no
        fresh work while it finishes its in-flight forwards."""
        with self._ring_lock:
            ring, ring_idx, backends = self._ring, self._ring_idx, self.backends
        if self.balance == "least_queue":
            pool = [b for b in backends if not b.draining]
            pool.sort(key=lambda b: b.queue_depth)
            return pool
        if not ring:
            return []
        start = bisect_right(ring, _hash_point(str(rid)))
        members = len(ring) // _RING_VNODES
        order, seen = [], set()
        for k in range(len(ring)):
            i = ring_idx[(start + k) % len(ring)]
            if i not in seen:
                seen.add(i)
                order.append(i)
            if len(order) == members:
                break
        return [backends[i] for i in order]

    # -- the request path ---------------------------------------------------

    def request(self, msg: dict) -> dict:
        """Forward one inference request: fleet-wide dedup, balanced backend
        choice, bounded failover, typed give-up. Blocking (the asyncio
        front-end calls this on executor threads). Traced requests (client
        ``"trace": true`` or the router's own id-hash sample) get the trace
        bit forwarded downstream and the router's spans prepended to the
        backend's reply trace."""
        rid = msg.get("id")
        trace = bool(msg.get("trace")) or (
            rid is not None and trace_sampled(rid, self.trace_sample)
        )
        if trace and not msg.get("trace"):
            msg = {**msg, "trace": True}
        if self.dedup is not None and rid is not None:
            entry, fresh = self.dedup.begin(rid)
            if not fresh:
                # retry re-attachment: the original forward (possibly to a
                # backend that has SINCE been ejected) answers this retry —
                # exactly one dispatch fleet-wide per id
                t_wait = time.perf_counter() if trace else None
                if not entry["ev"].wait(self._dedup_wait_s):
                    return {"id": rid, "ok": False,
                            "reason": "router_timeout: original forward still in flight"}
                rep = dict(entry["rep"] or {"id": rid, "ok": False,
                                            "reason": "router_error: empty dedup entry"})
                if trace:
                    # the retry's own story: it waited on the ORIGINAL
                    # dispatch (zero new wire exchanges) — the span that
                    # makes "identical reply, one dispatch" attributable
                    rep = _trace_dedup_reattach(
                        rep, rid, time.perf_counter() - t_wait
                    )
                return rep
            try:
                rep = self._forward(msg, rid, trace=trace)
            except BaseException:
                self.dedup.finish(rid, entry, None)
                raise
            self.dedup.finish(rid, entry, rep)
            return rep
        return self._forward(msg, rid, trace=trace)

    def _forward(self, msg: dict, rid, trace: bool = False) -> dict:
        tried = 0
        last_err: Exception | None = None
        attempts: list[dict] = []
        t_pick = time.perf_counter() if trace else None
        candidates = self._candidates(rid)
        pick_s = (time.perf_counter() - t_pick) if trace else None
        for b in candidates:
            if tried > self.failover:
                break
            if not b.state.allow():
                continue
            tried += 1
            t_wire = time.perf_counter() if trace else None
            try:
                rep = b.call(msg)
            except _FORWARD_ERRORS as e:
                if trace:
                    # the failed attempt's wire span stays in the trace: a
                    # failover retry is exactly the tail event the
                    # decomposition exists to attribute
                    failed_ms = round((time.perf_counter() - t_wire) * 1e3, 3)
                    attempts.append({
                        "backend": b.host_id,
                        "wire_ms": failed_ms,
                        "exchange_ms": failed_ms,
                        "ok": False,
                        "error": type(e).__name__,
                    })
                    with self._trace_lock:
                        self._trace_wire.add(failed_ms / 1e3)
                last_err = e
                if b.state.record_failure():
                    _emit_event(
                        "backend_ejected", backend=b.host_id, addr=b.addr,
                        reason=f"forward: {type(e).__name__}",
                    )
                with self._counter_lock:
                    self._failovers += 1
                continue
            b.state.record_success()
            if trace:
                exchange_ms = round((time.perf_counter() - t_wire) * 1e3, 3)
                backend_tr = rep.get("trace") if isinstance(rep, dict) else None
                server_ms = (
                    backend_tr.get("total_ms")
                    if isinstance(backend_tr, dict)
                    and isinstance(backend_tr.get("total_ms"), (int, float))
                    else None
                )
                # NET wire: exchange minus the backend's own serve total —
                # duration-minus-duration (never a cross-host timestamp
                # difference), so the trace's phases partition the request's
                # time instead of counting the backend twice
                wire_ms = (
                    round(max(0.0, exchange_ms - server_ms), 3)
                    if server_ms is not None
                    else exchange_ms
                )
                attempt = {
                    "backend": b.host_id,
                    "wire_ms": wire_ms,
                    "exchange_ms": exchange_ms,
                    "ok": True,
                }
                if server_ms is not None:
                    attempt["server_ms"] = server_ms
                attempts.append(attempt)
                with self._trace_lock:
                    self._trace_wire.add(wire_ms / 1e3)
                rep = _trace_prepend_router(rep, rid, pick_s, attempts)
            return rep
        with self._counter_lock:
            self._no_backend += 1
        rep = {
            "id": rid, "ok": False,
            "reason": (
                "no_backend: "
                + (f"{tried} forward(s) failed "
                   f"({type(last_err).__name__}: {last_err})" if last_err
                   else "all backends ejected")
            ),
        }
        if trace and attempts:
            # a traced give-up still reports where its time went: every
            # failed attempt's wire span, no backend phases to append
            rep = _trace_prepend_router(rep, rid, pick_s, attempts)
        return rep

    # -- fan-out / aggregated verbs -----------------------------------------

    def live_backends(self) -> list[Backend]:
        """Members that may receive fresh work: not ejected, not draining
        (a retiring host still finishes in-flight forwards, but fan-outs
        and scaling must not hand it anything new)."""
        return [b for b in self.backends if b.state.live() and not b.draining]

    def swap_fanout(self, tags: dict | None = None) -> dict:
        """``{"op": "swap"}`` to every LIVE backend concurrently; all-or-
        report-partial: per-host outcomes keyed by host_id, ejected hosts
        reported as skipped, ``ok`` true iff every live backend swapped.
        Raises only when NO backend could be reached at all (the deployer's
        tick_failed path)."""
        live = self.live_backends()
        skipped = [b.host_id for b in self.backends if not b.state.live()]
        if not live:
            raise ConnectionError("swap fan-out: no live backends")
        msg: dict = {"op": "swap"}
        if tags is not None:
            msg["tags"] = tags

        def _one(b: Backend) -> tuple[str, dict]:
            try:
                # swaps are NOT idempotent-retried (serve/client.swap's
                # contract): one attempt, outcome reported
                rep = b.call(dict(msg), idempotent=False)
            except _FORWARD_ERRORS as e:
                if b.state.record_failure():
                    _emit_event(
                        "backend_ejected", backend=b.host_id, addr=b.addr,
                        reason=f"swap: {type(e).__name__}",
                    )
                return b.host_id, {"ok": False,
                                   "reason": f"unreachable: {type(e).__name__}: {e}"}
            b.state.record_success()
            out = {"ok": bool(rep.get("ok"))}
            if rep.get("ok"):
                out["swap"] = rep.get("swap")
            else:
                out["reason"] = rep.get("reason")
            return b.host_id, out

        with ThreadPoolExecutor(max_workers=max(1, len(live))) as ex:
            results = dict(ex.map(_one, live))
        ok_count = sum(1 for r in results.values() if r["ok"])
        rec = {
            "ok": ok_count == len(live),
            "partial": 0 < ok_count < len(live) or bool(skipped),
            "ok_count": ok_count,
            "fanned_to": len(live),
            "skipped": skipped,
            "backends": results,
        }
        _emit_event("router_swap", **{k: rec[k] for k in
                                      ("ok", "partial", "ok_count", "fanned_to")})
        return rec

    def scale_fleet(self, replicas: int) -> dict:
        """Fleet-level replica target: difference against the polled per-host
        counts and move one replica at a time — grow the deepest-queue live
        host, shrink the shallowest-queue one (never below 1/host). All
        arithmetic runs on a LOCAL snapshot of the per-host counts: the poll
        thread is the single writer of ``Backend.replicas``, and a health
        reply polled before a scale landing mid-loop would otherwise reset
        the count and desynchronize the absolute targets this sends."""
        self.poll_once()  # act on fresh counts, not a stale poll
        live = self.live_backends()
        if not live:
            raise ConnectionError("scale: no live backends")
        target = max(len(live), int(replicas))  # >= 1 replica per live host
        actions = []
        counts = {b: b.replicas for b in live}
        total = sum(counts.values())
        before = total

        def _set(b: Backend, n: int) -> None:
            rec = b.call({"op": "scale", "replicas": n}, idempotent=False)
            if not rec.get("ok"):
                raise RuntimeError(
                    f"scale on {b.host_id} failed: {rec.get('reason')}"
                )
            counts[b] = n
            actions.append({"backend": b.host_id, "replicas": n})

        while total < target:
            b = max(live, key=lambda x: (x.queue_depth, -counts[x]))
            _set(b, counts[b] + 1)
            total += 1
        while total > target:
            shrinkable = [b for b in live if counts[b] > 1]
            if not shrinkable:
                break
            b = min(shrinkable, key=lambda x: (x.queue_depth, counts[x]))
            _set(b, counts[b] - 1)
            total -= 1
        return {"replicas_before": before, "replicas": total, "actions": actions}

    def router_summary(self) -> dict:
        """The router's own counters + merged wire latency (exact across
        backends: the raw per-backend histograms live router-side)."""
        merged = Histogram()
        forwarded = failed = 0
        per_wire = {}
        for b in self.backends:
            h, f, x = b.wire_metrics()
            merged.merge(h)
            forwarded += f
            failed += x
            per_wire[b.host_id] = {"forwarded": f, "failed": x,
                                   "latency_ms": h.summary()}
        with self._counter_lock:
            failovers, no_backend = self._failovers, self._no_backend
        wire_summary = merged.summary()
        if wire_summary is not None:
            # (n, sum_ms) ride along so the wire phase row aggregates by the
            # same exact-sum rule as the backend phase blocks — here the raw
            # samples DO live router-side, so the quantiles are exact too
            wire_summary["sum_ms"] = round(merged.sum() * 1e3, 3)
        return {
            "balance": self.balance,
            "backends": len(self.backends),
            "backends_live": len(self.live_backends()),
            "forwarded": forwarded,
            "failed_forwards": failed,
            "failovers": failovers,
            "no_backend": no_backend,
            "dedup_hits": 0 if self.dedup is None else self.dedup.hits,
            "ejections": sum(b.state.summary()["ejections"] for b in self.backends),
            "readmissions": sum(
                b.state.summary()["readmissions"] for b in self.backends
            ),
            "wire_latency_ms": wire_summary,
            "per_backend_wire": per_wire,
        }

    def health(self) -> dict:
        """The front ``{"op": "health"}`` payload: cheap (cached poll facts
        only — no backend round-trips, the 1 Hz contract)."""
        rows = {b.host_id: b.poll_row() for b in self.backends}
        return {
            "fleet": True,
            "warm": True,
            "backends": len(self.backends),
            "backends_live": len(self.live_backends()),
            "backends_draining": sum(1 for b in self.backends if b.draining),
            "queue_depth": sum(b.queue_depth for b in self.backends),
            "replicas": sum(b.replicas for b in self.backends),
            "swap_epoch": min(
                (b.swap_epoch for b in self.backends), default=0
            ),
            "uptime_s": round(time.monotonic() - self._monitor_t0, 3),
            "start_seq": self._start_seq,
            "router": self.router_summary(),
            "per_backend": rows,
        }

    def live_events(self, cursor: dict | None = None, limit: int = 512) -> dict:
        """The front ``{"op": "events"}`` payload: the router process's own
        spine tail plus every live backend's, aggregated.

        ``cursor`` is the previous reply's ``cursor`` block passed back
        verbatim — per-source ``{"start_seq", "seq"}`` pairs keyed
        ``"router"`` / backend host_id, so each source's tail survives ITS
        OWN restarts independently (an epoch-mismatched pair restarts that
        source from its buffer head; the others are untouched). Events
        concatenate per source in seq order — per-backend ordering is
        preserved, cross-backend order is by source, not wall clock (the
        envelopes carry ``ts`` for a reader that wants a merged timeline).
        ``dropped``/``lost`` sum the per-source loss ledgers: loss anywhere
        in the fleet is visible at the front door."""
        cursor = cursor if isinstance(cursor, dict) else {}
        events: list[dict] = []
        cursors: dict[str, dict] = {}
        dropped = lost = 0

        def fold(source: str, tail: dict) -> None:
            nonlocal dropped, lost
            for e in tail.get("events") or []:
                events.append({**e, "source": source})
            cursors[source] = {"start_seq": tail.get("start_seq"),
                               "seq": tail.get("next_seq")}
            dropped += int(tail.get("dropped") or 0)
            lost += int(tail.get("lost") or 0)

        fold("router", ensure_bus().tail(cursor.get("router"), limit=limit))
        for b in self.backends:
            if not b.state.live():
                continue
            try:
                rep = b.call({
                    "op": "events", "cursor": cursor.get(b.host_id),
                    "limit": int(limit),
                })
                tail = rep.get("events") or {}
            except _FORWARD_ERRORS as e:
                if b.state.record_failure():
                    _emit_event(
                        "backend_ejected", backend=b.host_id, addr=b.addr,
                        reason=f"events: {type(e).__name__}",
                    )
                continue
            b.state.record_success()
            fold(b.host_id, tail)
        return {"fleet": True, "events": events, "cursor": cursors,
                "dropped": dropped, "lost": lost}

    def live_metrics(self) -> dict:
        """The front ``{"op": "metrics"}`` payload: every live backend's
        metrics verb polled and AGGREGATED — raw counter sums (exact; the
        fleet controller differences two polls into windows exactly as it
        does one host's), the router's own exactly-merged wire latency, and
        the full per-backend rows (the per-host view a blended blob would
        bury)."""
        per_backend: dict[str, dict] = {}
        agg = {
            "fleet": True,
            "completed": 0, "batches": 0, "restarts": 0,
            "shed": {}, "faults": {},
            "queue_depth_now": 0, "workers": 0, "replicas": 0,
            "slo": None, "per_scenario": None, "dispatch": None,
            "compile_cache_after_warmup": None,
            "rows": None,
            "buckets": None,
            "swap_epoch": None,
            "breaker": None,
        }
        slo_n = slo_met = 0
        slo_seen = False
        # per-phase (n, sum_ms) EXACT sums across backends: quantiles cannot
        # cross a process boundary exactly (the raw samples live in each
        # backend), but counts and sums add — so the fleet mean per phase is
        # exact, and the per-backend rows keep their own exact quantiles.
        # The router's own wire phase is appended below from ITS raw
        # histogram (router-side samples: exact quantiles AND sums).
        phase_sum: dict[str, dict] = {}
        trace_sampled_n = 0
        trace_seen = False
        per_scen: dict[str, dict] = {}
        disp_over = disp_routed = 0
        disp_mode: set[str] = set()
        disp_seen = False
        cache_sum: dict[str, int] = {}
        cache_seen = False
        rows_sum: dict[str, int] = {}
        rows_seen = False
        for b in self.backends:
            if not b.state.live():
                continue
            try:
                rep = b.call({"op": "metrics"})
                m = rep.get("metrics") or {}
            except _FORWARD_ERRORS as e:
                if b.state.record_failure():
                    _emit_event(
                        "backend_ejected", backend=b.host_id, addr=b.addr,
                        reason=f"metrics: {type(e).__name__}",
                    )
                continue
            b.state.record_success()
            per_backend[b.host_id] = {
                "listen": b.listen or m.get("listen"),
                "completed": m.get("completed"),
                "rps": m.get("rps"),
                "goodput_rps": m.get("goodput_rps"),
                "latency_ms": m.get("latency_ms"),
                "phases": m.get("phases"),
                "trace": m.get("trace"),
                "queue_depth_now": m.get("queue_depth_now"),
                "replicas": m.get("replicas", m.get("workers")),
                "workers": m.get("workers"),
                "swap_epoch": m.get("swap_epoch"),
                "slo": m.get("slo"),
                "per_scenario": m.get("per_scenario"),
                "compile_cache_after_warmup": m.get("compile_cache_after_warmup"),
                "breaker": m.get("breaker"),
                **self.state_row(b),
            }
            agg["completed"] += int(m.get("completed") or 0)
            agg["batches"] += int(m.get("batches") or 0)
            agg["restarts"] += int(m.get("restarts") or 0)
            for k, v in (m.get("shed") or {}).items():
                agg["shed"][k] = agg["shed"].get(k, 0) + v
            for k, v in (m.get("faults") or {}).items():
                agg["faults"][k] = agg["faults"].get(k, 0) + v
            agg["queue_depth_now"] += int(m.get("queue_depth_now") or 0)
            agg["workers"] += int(m.get("workers") or 0)
            agg["replicas"] += int(m.get("replicas") or 1)
            slo = m.get("slo")
            if isinstance(slo, dict):
                slo_seen = True
                slo_n += int(slo.get("n") or 0)
                slo_met += int(slo.get("met") or 0)
            for k, v in (m.get("per_scenario") or {}).items():
                row = per_scen.setdefault(k, {"n": 0, "conf_sum": 0.0})
                row["n"] += int(v.get("n") or 0)
                row["conf_sum"] += float(v.get("conf_sum") or 0.0)
            for name, blk in (m.get("phases") or {}).items():
                if not isinstance(blk, dict):
                    continue
                row = phase_sum.setdefault(name, {"n": 0, "sum_ms": 0.0})
                row["n"] += int(blk.get("n") or 0)
                row["sum_ms"] += float(blk.get("sum_ms") or 0.0)
            tcov = m.get("trace")
            if isinstance(tcov, dict):
                trace_seen = True
                trace_sampled_n += int(tcov.get("sampled") or 0)
            disp = m.get("dispatch")
            if isinstance(disp, dict):
                disp_seen = True
                disp_over += int(disp.get("overflow_rows") or 0)
                disp_routed += int(disp.get("routed_rows") or 0)
                if disp.get("mode"):
                    disp_mode.add(str(disp["mode"]))
            cache = m.get("compile_cache_after_warmup")
            if isinstance(cache, dict):
                cache_seen = True
                for k, v in cache.items():
                    cache_sum[k] = cache_sum.get(k, 0) + int(v or 0)
            rows = m.get("rows")
            if isinstance(rows, dict):
                rows_seen = True
                for k, v in rows.items():
                    rows_sum[k] = rows_sum.get(k, 0) + int(v or 0)
            if agg["buckets"] is None:
                agg["buckets"] = m.get("buckets")
            se = m.get("swap_epoch")
            if se is not None:
                agg["swap_epoch"] = (
                    se if agg["swap_epoch"] is None else min(agg["swap_epoch"], se)
                )
        if slo_seen and slo_n:
            agg["slo"] = {"n": slo_n, "met": slo_met,
                          "attainment": round(slo_met / slo_n, 4)}
        if per_scen:
            for k, row in per_scen.items():
                if row["n"]:
                    row["conf_sum"] = round(row["conf_sum"], 4)
                    row["conf_mean"] = round(row["conf_sum"] / row["n"], 4)
            agg["per_scenario"] = per_scen
        if disp_seen:
            agg["dispatch"] = {
                "mode": (disp_mode.pop() if len(disp_mode) == 1
                         else "mixed" if disp_mode else None),
                "overflow_rows": disp_over,
                "routed_rows": disp_routed,
                "overflow_rate": (
                    round(disp_over / disp_routed, 6) if disp_routed else 0.0
                ),
            }
        if cache_seen:
            # per-key SUM across hosts: all-zero iff EVERY live backend's
            # request path stayed compile-free since its own warmup
            agg["compile_cache_after_warmup"] = cache_sum
        if rows_seen:
            agg["rows"] = rows_sum
        agg["backends_polled"] = len(per_backend)
        rsum = self.router_summary()  # once: it copies+merges every
        # backend's latency histogram under its lock
        agg["latency_ms"] = rsum["wire_latency_ms"]
        # fleet phase decomposition: backend phases as exact (n, sum_ms,
        # mean_ms) sums; the router's OWN wire phase (net spans from traced
        # requests) appended with full exact quantiles — its raw samples
        # live here
        phases: dict[str, dict] = {}
        for name, row in phase_sum.items():
            entry = {"n": row["n"], "sum_ms": round(row["sum_ms"], 3)}
            if row["n"]:
                entry["mean_ms"] = round(row["sum_ms"] / row["n"], 3)
            phases[name] = entry
        with self._trace_lock:
            wire_summary = self._trace_wire.summary()
            if wire_summary is not None:
                wire_summary["sum_ms"] = round(self._trace_wire.sum() * 1e3, 3)
        if wire_summary is not None:
            phases["wire"] = wire_summary
        agg["phases"] = phases or None
        if trace_seen:
            agg["trace"] = {
                "sampled": trace_sampled_n,
                "completed": agg["completed"],
                "fraction": (
                    round(trace_sampled_n / agg["completed"], 4)
                    if agg["completed"]
                    else None
                ),
            }
        agg["router"] = rsum
        agg["per_backend"] = per_backend
        return agg

    @staticmethod
    def state_row(b: Backend) -> dict:
        return {"state": "draining" if b.draining else b.state.state}
