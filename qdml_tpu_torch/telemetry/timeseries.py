"""Continuous fleet monitoring: the time-series scraper behind ``monitor``
(a copy of ``qdml_tpu/telemetry/timeseries.py``).

The monitor watches a live serve or route address:

- **scrape discipline**: only the cheap observability verbs, ever:
  ``{"op": "health"}``, ``{"op": "metrics"}`` (exact merged counters) and,
  with event tailing on, ``{"op": "events"}`` (the cursor tail over the
  event spine, :mod:`~qdml_tpu_torch.telemetry.events`). It never sends an
  inference request, so an attached monitor leaves the request path alone;
- **windowing**: cumulative counters are differenced between consecutive
  scrapes into fixed-width windows through :func:`counter_delta`, the one
  reset-safe helper (the control loop imports it from here). A restarted
  backend's counters start over; naive subtraction would give a negative
  rate that pages on recovery. ``counter_delta`` clamps the window and
  flags it, and the scraper emits a ``counter_reset`` record;
- **restart attribution**: the health verb's ``start_seq`` construction
  epoch names which backend restarted between scrapes (``uptime_s`` alone
  misses a restart older than the poll gap);
- **bounded state**: in-memory history lives in fixed-size rings
  (:class:`Ring`). The full stream appends to a manifest-headed JSONL
  (kinds ``monitor_timeseries``, ``monitor_event``, ``counter_reset``,
  ``monitor_alert``, ``spine_event``, ``monitor_summary``).

Burn-rate evaluation lives in :mod:`~qdml_tpu_torch.telemetry.burnrate`,
the hands-off attachment in :mod:`~qdml_tpu_torch.telemetry.attach`.
Records, windows and alerts are the JAX package's over the same replies.
Host-side only: ``monitor`` dispatches before the CLI parses a config or
resolves a device, and opens no context on the card.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque

from qdml_tpu_torch.telemetry.events import publish as publish_event


def counter_delta(prev, cur) -> tuple[float, bool]:
    """Reset-safe cumulative-counter differencing: ``(delta, reset)``.

    The sanctioned way to turn two snapshots of a monotonic counter into a
    window. When ``cur < prev`` the source restarted (process death, pool
    re-spawn, an aggregation that lost a member mid-poll): the honest
    window is unknowable, so the delta clamps to ``cur`` (everything the
    reborn counter has seen) and ``reset=True`` tells the caller to emit a
    structured ``counter_reset`` instead of feeding detectors a negative
    rate. ``None`` snapshots count as 0 (a backend that has not reported
    yet)."""
    p = float(prev or 0)
    c = float(cur or 0)
    if c < p:
        return c, True
    return c - p, False


class SnapshotDiff:
    """Named cumulative counters differenced across polls (reset-safe).

    One instance per monitored stream; :meth:`window` returns this poll's
    delta for one named counter and records the new snapshot. Resets are
    per-name: one backend's restart must not poison every other counter's
    window."""

    def __init__(self):
        self._prev: dict[str, float] = {}

    def window(self, name: str, cur) -> tuple[float, bool]:
        delta, reset = counter_delta(self._prev.get(name), cur)
        self._prev[name] = float(cur or 0)
        return delta, reset


class Ring:
    """Fixed-capacity record history (newest-wins, O(1) append).

    The monitor's only in-memory state: render/evaluate reads walk the
    ring, the JSONL stream keeps the full history on disk."""

    def __init__(self, cap: int = 512):
        self._q: deque = deque(maxlen=int(cap))

    def add(self, rec: dict) -> None:
        self._q.append(rec)

    def __len__(self) -> int:
        return len(self._q)

    def __iter__(self):
        return iter(list(self._q))

    def last(self) -> dict | None:
        return self._q[-1] if self._q else None


def _num(x) -> float:
    """A counter that may arrive as an int, a float, or a per-kind dict
    (the fleet aggregation's ``shed``/``faults`` blocks sum per kind)."""
    if isinstance(x, dict):
        return float(sum(v or 0 for v in x.values()))
    return float(x or 0)


def _breaker_totals(m: dict, h: dict) -> dict:
    """Fast-fail/admission counters + state, from whichever view carries
    them: the single-host snapshot's top-level ``breaker`` block, or the
    fleet aggregation's per-backend rows."""
    blk = m.get("breaker") or h.get("breaker")
    if isinstance(blk, dict):
        return {
            "fast_fails": _num(blk.get("fast_fails")),
            "admitted": _num(blk.get("admitted")),
            "states": {"_": str(blk.get("state"))},
        }
    out = {"fast_fails": 0.0, "admitted": 0.0, "states": {}}
    for bid, row in (m.get("per_backend") or {}).items():
        b = (row or {}).get("breaker")
        if isinstance(b, dict):
            out["fast_fails"] += _num(b.get("fast_fails"))
            out["admitted"] += _num(b.get("admitted"))
            out["states"][str(bid)] = str(b.get("state"))
    return out


class MonitorScraper:
    """The continuous scrape loop over one poller (SocketPoller at a serve
    or router address, FleetPoller in-process, or any object with
    ``health()``/``metrics()``).

    Each :meth:`scrape_once`:

    1. polls ``health`` + ``metrics`` (the ONLY verbs it ever sends);
    2. differences every cumulative counter into this window
       (:class:`SnapshotDiff`), emitting ``counter_reset`` records for any
       that went backwards;
    3. derives ``monitor_event`` records from snapshot changes — backend
       restart (``start_seq`` changed / ``uptime_s`` went down),
       quarantine-set growth, breaker transitions, swap-epoch bumps,
       router ejection/re-admission deltas;
    4. feeds the windowed error/total pairs into the burn-rate alerter
       (telemetry/burnrate.py) and emits any ``monitor_alert``
       transitions;
    5. appends one ``monitor_timeseries`` record.

    ``mark(tag)`` labels subsequent windows (a harness tags its baseline
    / fault / recovery segments, and the alert-expectation report gate is
    judged per tag). ``feed_external`` lets a harness wire client-side
    ledgers (stranded futures live in the loadgen, not the server) into
    the same alerter.
    """

    #: burn signals derived from server-side counters every scrape
    SIGNALS = ("slo", "shed", "breaker", "quarantine", "router")

    def __init__(
        self,
        poller,
        sink=None,
        interval_s: float = 1.0,
        alerter=None,
        ring: int = 512,
        clock=time.monotonic,
        tail_events: bool = False,
    ):
        self.poller = poller
        self.sink = sink
        self.interval_s = float(interval_s)
        self.alerter = alerter
        self.clock = clock
        self.ring = Ring(ring)
        self.events = Ring(ring)
        self.alerts = Ring(ring)
        self.diff = SnapshotDiff()
        self.seq = 0
        self.scrape_errors = 0
        self.resets_total = 0
        self._t0: float | None = None
        self._last_t: float | None = None
        self._mark = ""
        self._marks: list[str] = []
        self._prev_backends: dict[str, dict] = {}
        self._prev_breaker_states: dict[str, str] = {}
        self._prev_swap_epoch: int | None = None
        self._prev_quarantined = 0
        # event-spine tail state (telemetry/events.py): the cursor is the
        # poller's verbatim reply cursor — per-source ``(start_seq, seq)``
        # pairs from a router, one pair from a single host — so resume after
        # a reconnect (or a backend restart) has no gaps and no duplicates.
        # The loss ledger is the report's always-armed zero-loss gate:
        # event_drops tracks the endpoints' cumulative ring evictions,
        # events_lost the evictions that lapped THIS cursor specifically.
        self.tail_events = bool(tail_events)
        self.events_cursor: dict | None = None
        self.events_seen = 0
        self.event_drops = 0
        self.events_lost = 0

    # -- emission ------------------------------------------------------------

    def _emit(self, kind: str, **payload) -> dict:
        if self.sink is not None and getattr(self.sink, "active", True):
            self.sink.emit(kind, **payload)
        if kind != "spine_event":
            # monitor records join the event spine too — but a tailed
            # envelope must NOT be re-published: a monitor co-resident with
            # its router would echo the spine into itself forever
            publish_event(kind, tier="monitor", **payload)
        return payload

    def mark(self, tag: str) -> None:
        """Label windows scraped from now on (a harness's segments; the
        per-segment alert-expectation gate keys on these)."""
        self._mark = str(tag)
        if self._mark and self._mark not in self._marks:
            self._marks.append(self._mark)
        self._emit("monitor_event", event="mark", mark=self._mark,
                   t_s=self._rel(self.clock()))

    def _rel(self, t: float) -> float:
        if self._t0 is None:
            self._t0 = t
        return round(t - self._t0, 4)

    # -- derived events ------------------------------------------------------

    def _backend_rows(self, h: dict) -> dict[str, dict]:
        per = h.get("per_backend")
        if isinstance(per, dict):
            return {str(k): (v or {}) for k, v in per.items()}
        return {str(h.get("host_id") or "local"): h}

    def _derive_events(self, h: dict, t_s: float) -> list[dict]:
        evs: list[dict] = []
        rows = self._backend_rows(h)
        # membership deltas (elastic fleet): a backend id
        # appearing after the first scrape was admitted, one disappearing
        # was retired — the timeline then correlates scale events with burn
        # trajectories. The first scrape seeds silently (the boot-time set
        # is not an admission), and per-backend diff state is dropped on
        # retirement so a later same-id re-admission diffs fresh.
        if self._prev_backends:
            for bid in rows.keys() - self._prev_backends.keys():
                evs.append({"event": "backend_admitted", "backend": bid,
                            "state": rows[bid].get("state")})
            for bid in self._prev_backends.keys() - rows.keys():
                evs.append({"event": "backend_retired", "backend": bid})
                del self._prev_backends[bid]
        for bid, row in rows.items():
            prev = self._prev_backends.get(bid)
            seq, up = row.get("start_seq"), row.get("uptime_s")
            if prev is not None:
                p_seq, p_up = prev.get("start_seq"), prev.get("uptime_s")
                restarted = (
                    seq is not None and p_seq is not None and seq != p_seq
                ) or (
                    seq is None and up is not None and p_up is not None
                    and up < p_up
                )
                if restarted:
                    evs.append({"event": "backend_restart", "backend": bid,
                                "start_seq": seq, "uptime_s": up})
                if row.get("poll_ok") is False and prev.get("poll_ok") is True:
                    evs.append({"event": "backend_unreachable", "backend": bid})
            self._prev_backends[bid] = {
                "start_seq": seq, "uptime_s": up,
                "poll_ok": row.get("poll_ok"),
            }
        q = h.get("quarantined")
        qn = len(q) if isinstance(q, (list, tuple)) else int(q or 0)
        if qn > self._prev_quarantined:
            evs.append({"event": "quarantine",
                        "delta": qn - self._prev_quarantined, "now": qn})
        self._prev_quarantined = qn
        swap = h.get("swap_epoch")
        if swap is not None and self._prev_swap_epoch is not None \
                and swap != self._prev_swap_epoch:
            evs.append({"event": "swap_epoch", "from": self._prev_swap_epoch,
                        "to": swap})
        if swap is not None:
            self._prev_swap_epoch = int(swap)
        return evs

    def _breaker_events(self, states: dict[str, str]) -> list[dict]:
        evs = []
        for bid, st in states.items():
            p = self._prev_breaker_states.get(bid)
            if p is not None and st != p and st != "None":
                evs.append({"event": "breaker_transition", "backend": bid,
                            "from": p, "to": st})
            self._prev_breaker_states[bid] = st
        return evs

    # -- the scrape ----------------------------------------------------------

    def scrape_once(self) -> dict | None:
        """One window: poll, difference, derive, alert, emit. Returns the
        ``monitor_timeseries`` payload (None on a failed poll — the scrape
        survives a restarting endpoint and reports it)."""
        t = self.clock()
        t_s = self._rel(t)
        try:
            h = self.poller.health()
            m = self.poller.metrics()
        except Exception as e:  # lint: disable=broad-except(a monitor must survive its target restarting mid-scrape: the failed poll is itself the observation, reported as a scrape_error event)
            self.scrape_errors += 1
            ev = {"event": "scrape_error", "t_s": t_s,
                  "error": f"{type(e).__name__}: {e}"}
            self.events.add(ev)
            self._emit("monitor_event", **ev)
            return None
        dt = None if self._last_t is None else round(t - self._last_t, 4)
        self._last_t = t

        resets: list[str] = []

        def win(name: str, cur) -> float:
            d, reset = self.diff.window(name, cur)
            if reset:
                resets.append(name)
            return d

        d_completed = win("completed", m.get("completed"))
        d_shed = win("shed", _num(m.get("shed")))
        d_restarts = win("restarts", m.get("restarts"))
        d_faults = win("faults", _num(m.get("faults")))
        slo = m.get("slo") or {}
        d_slo_n = win("slo_n", slo.get("n"))
        d_slo_met = win("slo_met", slo.get("met"))
        brk = _breaker_totals(m, h)
        d_ff = win("breaker_fast_fails", brk["fast_fails"])
        d_adm = win("breaker_admitted", brk["admitted"])
        router = h.get("router") or {}
        d_fwd = win("router_forwarded", router.get("forwarded"))
        d_rfail = win("router_failed", router.get("failed_forwards"))
        d_fov = win("router_failovers", router.get("failovers"))
        d_eject = win("router_ejections", router.get("ejections"))
        d_readmit = win("router_readmissions", router.get("readmissions"))

        for name in resets:
            self.resets_total += 1
            self._emit("counter_reset", counter=name, t_s=t_s,
                       mark=self._mark)

        evs = self._derive_events(h, t_s)
        evs.extend(self._breaker_events(brk["states"]))
        if d_restarts > 0:
            evs.append({"event": "replica_restart", "delta": d_restarts})
        if d_eject > 0:
            evs.append({"event": "backend_ejected", "delta": d_eject})
        if d_readmit > 0:
            evs.append({"event": "backend_readmitted", "delta": d_readmit})
        for ev in evs:
            ev.setdefault("t_s", t_s)
            ev.setdefault("mark", self._mark)
            self.events.add(ev)
            self._emit("monitor_event", **ev)

        replicas = int(h.get("replicas") or h.get("workers") or 1)
        quarantine_errs = (
            sum(e.get("delta", 1) for e in evs
                if e["event"] in ("quarantine", "replica_restart",
                                  "backend_restart"))
        )
        burn = {}
        fired: list[dict] = []
        if self.alerter is not None and dt is not None:
            self.alerter.feed(t_s, "slo", d_slo_n - d_slo_met, d_slo_n)
            self.alerter.feed(t_s, "shed", d_shed, d_completed + d_shed)
            self.alerter.feed(t_s, "breaker", d_ff, d_adm + d_ff)
            self.alerter.feed(t_s, "quarantine", quarantine_errs,
                              max(1, replicas))
            if router:
                self.alerter.feed(t_s, "router", d_rfail + d_fov, d_fwd)
            fired = self.alerter.evaluate(t_s, mark=self._mark)
            for a in fired:
                self.alerts.add(a)
                self._emit("monitor_alert", **a)
            burn = self.alerter.burns(t_s)

        self.seq += 1
        rec = {
            "seq": self.seq,
            "t_s": t_s,
            "dt_s": dt,
            "mark": self._mark,
            "completed": d_completed,
            "rps": None if not dt else round(d_completed / dt, 3),
            "shed": d_shed,
            "faults": d_faults,
            "restarts": d_restarts,
            "slo": (
                None if d_slo_n <= 0
                else {"n": d_slo_n, "met": d_slo_met,
                      "attainment": round(d_slo_met / d_slo_n, 4)}
            ),
            "breaker": {"fast_fails": d_ff, "admitted": d_adm,
                        "states": brk["states"]},
            "router": (
                None if not router
                else {"forwarded": d_fwd, "failed": d_rfail,
                      "failovers": d_fov, "ejections": d_eject,
                      "readmissions": d_readmit}
            ),
            "queue_depth": int(h.get("queue_depth") or 0),
            "replicas": replicas,
            "backends": h.get("backends"),
            "backends_live": h.get("backends_live"),
            "swap_epoch": h.get("swap_epoch"),
            "resets": resets or None,
            "burn": burn or None,
            "alerts": [a["signal"] for a in fired] or None,
        }
        if self.tail_events:
            spine = self.scrape_events()
            rec["spine"] = {
                "events": len(spine),
                "event_drops": self.event_drops,
                "events_lost": self.events_lost,
            }
        self.ring.add(rec)
        self._emit("monitor_timeseries", **rec)
        return rec

    def scrape_events(self) -> list[dict]:
        """Tail the endpoint's event spine from the last seen cursor — the
        third and last sanctioned scrape verb (``{"op": "events"}``). Each
        received envelope re-emits into the monitor stream as a
        ``spine_event`` record (nested under ``ev`` — envelopes carry their
        own ``kind``/``ts``), and the reply's loss ledger folds into
        ``event_drops``/``events_lost``. A poller without an ``events``
        verb downgrades to the two-verb scrape silently."""
        if not hasattr(self.poller, "events"):
            return []
        try:
            t = self.poller.events(self.events_cursor)
        except Exception as e:  # lint: disable=broad-except(the events tail must survive its target restarting mid-scrape exactly like health/metrics: the failed poll is the observation, and the kept cursor resumes the tail)
            self.scrape_errors += 1
            ev = {"event": "scrape_error", "verb": "events",
                  "t_s": self._rel(self.clock()),
                  "error": f"{type(e).__name__}: {e}"}
            self.events.add(ev)
            self._emit("monitor_event", **ev)
            return []
        evs = t.get("events") or []
        if "cursor" in t:
            # aggregated router reply: per-source cursors, passed back
            # verbatim next poll (each survives its own backend's restarts
            # through the start_seq epoch)
            self.events_cursor = t["cursor"]
        else:
            self.events_cursor = {"start_seq": t.get("start_seq"),
                                  "seq": t.get("next_seq")}
        self.event_drops = max(self.event_drops, int(t.get("dropped") or 0))
        self.events_lost += int(t.get("lost") or 0)
        self.events_seen += len(evs)
        for e in evs:
            self._emit("spine_event", ev=e)
        return evs

    def feed_external(self, signal: str, errors: float, total: float) -> None:
        """Client-side ledgers (stranded futures, give-ups) into the same
        alerter: the server cannot observe a client that hung forever, so
        harnesses that hold the loadgen summary wire it here."""
        if self.alerter is not None:
            t_s = self._rel(self.clock())
            self.alerter.feed(t_s, signal, errors, total)
            for a in self.alerter.evaluate(t_s, mark=self._mark):
                self.alerts.add(a)
                self._emit("monitor_alert", **a)

    def run(self, duration_s: float, stop: threading.Event | None = None) -> int:
        """Scrape every ``interval_s`` for ``duration_s`` (or until
        ``stop``); returns the number of windows taken.

        Scrapes anchor to an ABSOLUTE monotonic grid (``next_t +=
        interval``): the old sleep-after-each-scrape schedule accumulated
        every scrape's latency as skew, so a week-long attachment drifted
        its window boundaries by hours. A scrape that overruns its slot
        emits an honest ``late_scrape`` event (how late, how many slots it
        blew through) and realigns to the next FUTURE slot — no burst of
        catch-up scrapes, and no silent pretense the cadence held."""
        stop = stop or threading.Event()
        start = self.clock()
        end = start + float(duration_s)
        next_t = start
        while self.clock() < end and not stop.is_set():
            self.scrape_once()
            next_t += self.interval_s
            now = self.clock()
            if now > next_t:
                ev = {"event": "late_scrape", "t_s": self._rel(now),
                      "late_s": round(now - next_t, 4),
                      "slots_skipped": int((now - next_t) // self.interval_s),
                      "mark": self._mark}
                self.events.add(ev)
                self._emit("monitor_event", **ev)
                while next_t <= now:
                    next_t += self.interval_s
            elif stop.wait(next_t - now):
                break
        return self.seq

    def summary(self, extra: dict | None = None) -> dict:
        """The ``monitor_summary`` payload (emitted by :meth:`finish`):
        window/alert/reset totals, per-mark alert counts, peak burn per
        signal — the facts the report's monitor gates read."""
        by_mark: dict[str, int] = {m: 0 for m in self._marks}
        by_signal: dict[str, int] = {}
        firing = resolved = 0
        for a in self.alerts:
            if a.get("state") == "firing":
                firing += 1
                by_mark[a.get("mark") or ""] = by_mark.get(a.get("mark") or "", 0) + 1
                by_signal[a["signal"]] = by_signal.get(a["signal"], 0) + 1
            elif a.get("state") == "resolved":
                resolved += 1
        out = {
            "windows": self.seq,
            "interval_s": self.interval_s,
            "duration_s": self._rel(self.clock()) if self._t0 is not None else 0.0,
            "scrape_errors": self.scrape_errors,
            "counter_resets": self.resets_total,
            "events": len(self.events),
            "alerts": {"fired": firing, "resolved": resolved,
                       "by_mark": by_mark, "by_signal": by_signal},
            "peak_burn": None if self.alerter is None else self.alerter.peaks(),
        }
        if self.tail_events:
            # the spine loss ledger the always-armed event_drops report
            # gate reads: endpoint ring evictions + evictions past this
            # cursor — "zero event loss" means BOTH stayed zero
            out["event_drops"] = self.event_drops + self.events_lost
            out["spine"] = {"events": self.events_seen,
                            "ring_dropped": self.event_drops,
                            "cursor_lost": self.events_lost}
        if extra:
            out.update(extra)
        return out

    def finish(self, extra: dict | None = None) -> dict:
        rec = self.summary(extra)
        self._emit("monitor_summary", **rec)
        return rec


# ---------------------------------------------------------------------------
# CLI: monitor
# ---------------------------------------------------------------------------


def _arg(argv: list[str], name: str, default):
    return next(
        (a.split("=", 1)[1] for a in argv if a.startswith(f"--{name}=")),
        default,
    )


def monitor_main(argv: list[str]) -> int:
    """``monitor --addr=HOST:PORT [--interval=1.0] [--duration=30]
    [--out=monitor.jsonl] [--slo-target=0.99] [--threshold=8]
    [--fast=0 --slow=0 (0 = scale to duration)] [--debounce=2]``: attach,
    scrape, alert, summarize; or ``monitor --render
    --current=monitor.jsonl [--events=a.jsonl,b.jsonl] [--out=timeline.md]``
    to render a recorded stream as the markdown timeline.

    ``--attach`` turns the scrape into the hands-off loop
    (:mod:`~qdml_tpu_torch.telemetry.attach`): every finished window also
    ticks a :class:`~qdml_tpu_torch.control.fleet_scale.FleetAutoscaler`
    acting through the endpoint's ``{"op": "fleet"}`` verb, the event spine
    is tailed per window, and a front-door restart reconnects with backoff
    (``monitor_reattach``; a typed give-up, exit 3, after
    ``--max-reconnects``). Knobs: ``--min-backends/--max-backends/
    --queue-high/--queue-low/--scale-debounce/--cooldown/--max-reconnects/
    --dry-run``, plus ``--target=plan.json`` to pin a planner target.
    Prints ``{"monitor": summary}``; exit 0, 3 on a give-up, 2 on usage
    errors. Host-side only: no device, no config, no inference."""
    from qdml_tpu_torch.telemetry.burnrate import BurnAlerter, render_timeline

    if any(a == "--render" for a in argv):
        cur = _arg(argv, "current", None)
        if not cur:
            print("monitor --render needs --current=<monitor.jsonl>")
            return 2
        records = []
        with open(cur) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    records.append(json.loads(line))
        extra = []
        ev_paths = _arg(argv, "events", "")
        for p in [x for x in ev_paths.split(",") if x]:
            with open(p) as fh:
                for line in fh:
                    line = line.strip()
                    if line:
                        extra.append(json.loads(line))
        md = render_timeline(records, extra_events=extra)
        out = _arg(argv, "out", None)
        if out:
            with open(out, "w") as fh:
                fh.write(md)
            print(f"wrote {out}")
        else:
            print(md)
        return 0

    addr = _arg(argv, "addr", None)
    if not addr or ":" not in addr:
        print("monitor needs --addr=HOST:PORT (a serve or route endpoint)")
        return 2
    host, port = addr.rsplit(":", 1)
    interval = float(_arg(argv, "interval", "1.0"))
    duration = float(_arg(argv, "duration", "30"))
    out_path = _arg(argv, "out", "monitor.jsonl")
    slo_target = float(_arg(argv, "slo-target", "0.99"))
    threshold = float(_arg(argv, "threshold", "8"))
    fast = float(_arg(argv, "fast", "0"))
    slow = float(_arg(argv, "slow", "0"))
    debounce = int(_arg(argv, "debounce", "2"))

    from qdml_tpu_torch.control.loop import SocketPoller
    from qdml_tpu_torch.telemetry.manifest import run_manifest
    from qdml_tpu_torch.utils.metrics import MetricsLogger

    alerter = BurnAlerter.for_run(
        duration_s=duration, interval_s=interval, slo_target=slo_target,
        threshold=threshold, fast_s=fast or None, slow_s=slow or None,
        debounce=debounce,
    )
    logger = MetricsLogger(
        out_path, echo=False,
        manifest=run_manifest(argv=["monitor"] + list(argv), include_torch=False),
    )
    attach = any(a == "--attach" for a in argv)
    scraper = MonitorScraper(
        SocketPoller(host, int(port), timeout_s=max(5.0, interval * 4)),
        sink=logger.telemetry, interval_s=interval, alerter=alerter,
        tail_events=attach,
    )
    give_up = None
    try:
        if attach:
            from qdml_tpu_torch.control.fleet_scale import (
                FleetAutoscaler, load_planner_target,
            )
            from qdml_tpu_torch.telemetry.attach import MonitorAttachment

            # the actuator is a SEPARATE poller: the scrape path stays on
            # the three read verbs, the fleet verb is the acting path
            actuator = SocketPoller(
                host, int(port), timeout_s=max(5.0, interval * 4)
            )
            autoscaler = FleetAutoscaler(
                lambda n: actuator.fleet(backends=n),
                min_backends=int(_arg(argv, "min-backends", "1")),
                max_backends=int(_arg(argv, "max-backends", "4")),
                queue_high=float(_arg(argv, "queue-high", "32")),
                queue_low=float(_arg(argv, "queue-low", "2")),
                debounce=int(_arg(argv, "scale-debounce", "2")),
                cooldown_ticks=int(_arg(argv, "cooldown", "5")),
                sink=logger.telemetry,
                dry_run=any(a == "--dry-run" for a in argv),
            )
            target = _arg(argv, "target", None)
            if target:
                autoscaler.set_planner_target(load_planner_target(target))
            attachment = MonitorAttachment(
                scraper, autoscaler,
                max_reconnects=int(_arg(argv, "max-reconnects", "8")),
            )
            attachment.run(duration)
            give_up = attachment.give_up
            summary = scraper.finish(extra={"handsoff": attachment.summary()})
        else:
            scraper.run(duration)
            summary = scraper.finish()
    finally:
        logger.close()
    print(json.dumps({"monitor": summary}, default=str))
    return 3 if give_up else 0
