"""The event spine (``qdml_tpu/telemetry/events.py:115-252``): one envelope, one ring, explicit loss.

Supervision and fault events (``replica_restarted``, ``replica_quarantined``,
``supervisor_error``) are published onto one process-global
:class:`EventBus`; the server's ``{"op": "events"}`` verb tails it. Each
envelope carries ``seq`` (monotone per process), ``ts``, ``tier``,
``kind``, ``severity`` (from the kind unless the publisher says),
correlation keys hoisted from the payload (``rid``, ``swap_epoch``, ...)
and ``data``, the payload itself. The ring is bounded; an eviction counts
in ``dropped``, and every tail carries the cursor-relative ``lost`` count,
so a reader can tell whether it saw everything. A cursor from another bus
(another ``start_seq`` epoch) reads from the ring's head.

``events`` (:func:`events_main`, ``qdml_tpu/telemetry/events.py:254-341``)
tails a running ``serve`` or ``route`` endpoint's spine from the shell over
the port's :class:`~qdml_tpu_torch.serve.client.ServeClient`; it is
host-side (no device, no config).
"""

from __future__ import annotations

import threading

from qdml_tpu_torch.utils import lockdep
import time
from collections import deque

DEFAULT_CAPACITY = 4096
DEFAULT_TAIL_LIMIT = 512

# strictly-increasing epoch allocator: two buses born within the same
# wall-clock millisecond (a fast in-process restart, or tests) must still
# get DISTINCT start_seq epochs, or a stale cursor would silently "match"
# the replacement ring and skip its first events
_epoch_lock = lockdep.Lock("events:_epoch_lock")
_last_epoch = 0


def _new_epoch() -> int:
    global _last_epoch
    with _epoch_lock:
        e = int(time.time() * 1000)
        if e <= _last_epoch:
            e = _last_epoch + 1
        _last_epoch = e
        return e

SEVERITIES = ("debug", "info", "warning", "critical")

# kind -> severity vocabulary (the JAX package's). Anything
# unlisted is "info"; monitor_alert is state-dependent (firing pages).
_CRITICAL = frozenset({
    "replica_quarantined",
    "supervisor_error",
    "backend_ejected",
    "spawn_failed",
    "monitor_attach_giveup",
})
_WARNING = frozenset({
    "replica_restarted",
    "router_poll_error",
    "drift_event",
    "counter_reset",
    "late_scrape",
    "monitor_reattach",
    "worker_crash",
})
_DEBUG = frozenset({"monitor_timeseries"})

# envelope correlation keys <- payload field aliases, first present wins.
# The payload stays intact under "data"; hoisting just makes the keys
# greppable/joinable without knowing each record's shape.
_CORRELATION = (
    ("rid", ("rid", "request_id")),
    ("swap_epoch", ("swap_epoch",)),
    ("episode", ("episode", "alert_episode")),
    ("decision", ("decision", "decision_id")),
    ("planner_sha", ("planner_sha", "assumptions_sha")),
)


def classify(kind: str, fields: dict | None = None) -> str:
    """Default severity for ``kind`` (publisher override always wins)."""
    if kind == "monitor_alert":
        return "critical" if (fields or {}).get("state") == "firing" else "info"
    if kind in _CRITICAL:
        return "critical"
    if kind in _WARNING:
        return "warning"
    if kind in _DEBUG:
        return "debug"
    return "info"


class EventBus:
    """Bounded in-process event ring with cursor tails and explicit drops.

    ``capacity`` bounds memory on a long-lived server; ``clock`` injects a
    fake wall clock for tests. All ring/cursor state (``_ring``, ``_seq``,
    ``_dropped``) is touched only under ``_lock``: publishers are request
    workers and supervisors, tails come from the asyncio verb handlers.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY, clock=time.time):
        self.capacity = max(1, int(capacity))
        self._clock = clock
        # restart-visibility epoch, same contract as ServeLoop/FleetRouter
        # start_seq: a cursor from before a process restart mismatches and
        # the tail restarts from the head instead of skipping new events
        self.start_seq = _new_epoch()
        self._lock = lockdep.Lock("EventBus._lock")
        self._ring: deque = deque()
        self._seq = 0
        self._dropped = 0

    # -- publishing ----------------------------------------------------------

    def publish(
        self, kind: str, tier: str = "host", severity: str | None = None,
        **fields,
    ) -> dict:
        """Append one envelope; returns it. Eviction on a full ring counts
        in ``dropped`` — loss is observable, never silent."""
        sev = severity if severity is not None else classify(kind, fields)
        env = {
            "ts": round(float(self._clock()), 6),
            "tier": tier,
            "kind": kind,
            "severity": sev,
        }
        for key, aliases in _CORRELATION:
            for a in aliases:
                if fields.get(a) is not None:
                    env[key] = fields[a]
                    break
        env["data"] = fields
        with self._lock:
            self._seq += 1
            env["seq"] = self._seq
            if len(self._ring) >= self.capacity:
                self._ring.popleft()
                self._dropped += 1
            self._ring.append(env)
        return env

    # -- tailing -------------------------------------------------------------

    def tail(self, cursor: dict | None = None, limit: int = DEFAULT_TAIL_LIMIT) -> dict:
        """Events after ``cursor`` (``{"start_seq": ..., "seq": ...}``; None
        or an epoch-mismatched cursor reads from the buffer head). The reply
        is the next cursor plus the loss ledger::

            {"start_seq": epoch, "next_seq": resume-from seq,
             "dropped": cumulative evictions, "lost": evicted past THIS
             cursor (0 = the reader saw every event), "events": [...]}

        Resume by passing ``{"start_seq": reply["start_seq"], "seq":
        reply["next_seq"]}`` back — same cursor, no gaps, no duplicates.
        """
        limit = max(1, int(limit))
        since = 0
        if isinstance(cursor, dict):
            try:
                if int(cursor.get("start_seq") or 0) == self.start_seq:
                    since = max(0, int(cursor.get("seq") or 0))
            except (TypeError, ValueError):
                since = 0
        with self._lock:
            oldest = self._ring[0]["seq"] if self._ring else self._seq + 1
            events = []
            for e in self._ring:
                if e["seq"] > since:
                    events.append(e)
                    if len(events) >= limit:
                        break
            dropped = self._dropped
        return {
            "start_seq": self.start_seq,
            "next_seq": events[-1]["seq"] if events else max(since, oldest - 1),
            "dropped": dropped,
            "lost": max(0, oldest - 1 - since),
            "events": events,
        }

    def snapshot(self) -> dict:
        """Ledger facts without the events (health/summary blocks)."""
        with self._lock:
            return {
                "start_seq": self.start_seq,
                "seq": self._seq,
                "dropped": self._dropped,
                "size": len(self._ring),
                "capacity": self.capacity,
            }


# -- process-global bus (mirrors spans.set_sink / get_sink) ------------------

_bus: EventBus | None = None
_bus_guard = lockdep.Lock("events:_bus_guard")


def install_bus(bus: EventBus | None) -> None:
    """Install (or with None, detach) the process-global bus. Tests install
    a fresh bus to isolate their cursors; servers just use ``ensure_bus``."""
    global _bus
    _bus = bus


def get_bus() -> EventBus | None:
    return _bus


def ensure_bus(capacity: int = DEFAULT_CAPACITY) -> EventBus:
    """The process-global bus, created on first use (double-checked: two
    racing first publishers must not each install a bus and split the
    stream)."""
    global _bus
    if _bus is None:
        with _bus_guard:
            if _bus is None:
                _bus = EventBus(capacity)
    return _bus


def publish(kind: str, tier: str = "host", severity: str | None = None, **fields) -> dict:
    """Publish onto the process-global bus (creating it on first use).
    The one-liner every emitter choke point calls alongside its JSONL
    write — the sink is the durable record, the bus is the live tail."""
    return ensure_bus().publish(kind, tier=tier, severity=severity, **fields)


def normalize_tail(reply: dict) -> tuple[list[dict], dict, int, int]:
    """``(events, next_cursor, dropped, lost)`` from either tail shape:
    a single bus (``{"start_seq", "next_seq", ...}``) or a router
    aggregation (``{"cursor": {source: ...}, ...}``). The next cursor is
    whatever the endpoint wants passed back verbatim."""
    events = reply.get("events") or []
    if "cursor" in reply:
        cursor = reply["cursor"]
    else:
        cursor = {"start_seq": reply.get("start_seq"),
                  "seq": reply.get("next_seq")}
    return (events, cursor,
            int(reply.get("dropped") or 0), int(reply.get("lost") or 0))


# ---------------------------------------------------------------------------
# CLI: events
# ---------------------------------------------------------------------------


def events_main(argv: list[str]) -> int:
    """``events --addr=HOST:PORT [--follow] [--interval=1.0]
    [--limit=512] [--min-severity=debug] [--kinds=a,b] [--tiers=x,y]``:
    tail a running serve/route endpoint's event spine as JSONL on stdout.
    One tail and exit by default; ``--follow`` keeps polling the cursor
    (Ctrl-C to stop). A nonzero loss ledger prints a ``spine_loss`` line.
    Exit 0, 3 when the endpoint cannot be read, 2 on usage errors.
    Host-side only: no device, no config."""
    import json as _json
    import sys as _sys

    def _arg(name: str, default):
        return next(
            (a.split("=", 1)[1] for a in argv if a.startswith(f"--{name}=")),
            default,
        )

    addr = _arg("addr", None)
    if not addr or ":" not in addr:
        print("events needs --addr=HOST:PORT (a serve or route endpoint)")
        return 2
    host, port = addr.rsplit(":", 1)
    follow = any(a == "--follow" for a in argv)
    interval = float(_arg("interval", "1.0"))
    limit = int(_arg("limit", str(DEFAULT_TAIL_LIMIT)))
    min_sev = SEVERITIES.index(str(_arg("min-severity", "debug")))
    kinds = {k for k in str(_arg("kinds", "")).split(",") if k}
    tiers = {t for t in str(_arg("tiers", "")).split(",") if t}

    from qdml_tpu_torch.serve.client import ServeClient, ServeClientError

    client = ServeClient(host, int(port), timeout_s=max(5.0, interval * 4))
    cursor = None
    last_dropped = last_lost = 0
    try:
        while True:
            try:
                rep = client.events(cursor, limit=limit)
            except ServeClientError as e:
                print(_json.dumps({"spine_error": str(e)}), file=_sys.stderr)
                return 3
            if not rep.get("ok"):
                print(_json.dumps({"spine_error": rep.get("reason")}),
                      file=_sys.stderr)
                return 3
            events, cursor, dropped, lost = normalize_tail(
                rep.get("events") or {}
            )
            if dropped > last_dropped or lost > last_lost:
                print(_json.dumps({"spine_loss": {"dropped": dropped,
                                                  "lost": lost}}))
                last_dropped, last_lost = dropped, lost
            for e in events:
                if SEVERITIES.index(e.get("severity", "info")) < min_sev:
                    continue
                if kinds and e.get("kind") not in kinds:
                    continue
                if tiers and e.get("tier") not in tiers:
                    continue
                print(_json.dumps(e), flush=follow)
            if not follow:
                break
            time.sleep(interval)
    except KeyboardInterrupt:
        pass
    finally:
        client.close_connection()
    return 0
