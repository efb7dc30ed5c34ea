"""The live observability loop: a monitor attachment that drives the fleet
(a copy of ``qdml_tpu/telemetry/attach.py``).

``monitor`` (:mod:`~qdml_tpu_torch.telemetry.timeseries`) observes; the
elastic fleet (:mod:`~qdml_tpu_torch.fleet.lifecycle` and
:mod:`~qdml_tpu_torch.control.fleet_scale`) provisions.
:class:`MonitorAttachment` joins them: one long-running scraper, and every
finished window becomes a policy tick.

Per window the attachment:

1. scrapes health + metrics + the event-spine tail (the three read verbs;
   acting happens through the injected autoscaler's ``scale_fn``, a
   separate actuator);
2. reads the burn alerter's latched state
   (:meth:`~qdml_tpu_torch.telemetry.burnrate.BurnAlerter.firing`),
   the open alert-episode ids;
3. ticks ``autoscaler.observe(queue_depth, backends, slo_attainment,
   burn_alert, alert_episode, backends_live)``: a decision made while an
   alert burns carries the episode id, so the ``fleet_scale_event`` joins
   the ``monitor_alert`` that drove it by id on the event spine.

Reconnects: a failed scrape backs off exponentially instead of holding the
grid; on recovery the attachment emits ``monitor_reattach`` and the event
tail resumes from the last seen per-source ``(start_seq, seq)`` cursor.
``max_reconnects`` consecutive failures end the run with a typed give-up
(``monitor_attach_giveup`` and a ``give_up`` summary block), never a
traceback.
"""

from __future__ import annotations

import threading

from qdml_tpu_torch.telemetry.timeseries import MonitorScraper


class MonitorAttachment:
    """Drive a :class:`FleetAutoscaler` (or any object with an
    ``observe(queue_depth, backends, slo_attainment=, burn_alert=,
    alert_episode=)`` method) from a live :class:`MonitorScraper`.

    The scraper should be constructed with ``tail_events=True`` so each
    window also drains the event spine (the attachment works without it,
    but then the stream carries no correlation evidence).
    """

    def __init__(
        self,
        scraper: MonitorScraper,
        autoscaler,
        reconnect_backoff_s: float = 0.5,
        reconnect_max_s: float = 8.0,
        max_reconnects: int = 8,
    ):
        self.scraper = scraper
        self.autoscaler = autoscaler
        self.reconnect_backoff_s = float(reconnect_backoff_s)
        self.reconnect_max_s = float(reconnect_max_s)
        self.max_reconnects = max(1, int(max_reconnects))
        self.ticks = 0
        self.decisions: list[dict] = []
        self.reattaches = 0
        self.give_up: dict | None = None

    # -- one policy tick -----------------------------------------------------

    def tick(self, rec: dict) -> dict | None:
        """One finished window into one ``observe`` tick. Returns the
        ``fleet_scale_event`` payload when the policy decided, else None."""
        self.ticks += 1
        firing = (
            self.scraper.alerter.firing()
            if self.scraper.alerter is not None else []
        )
        slo = rec.get("slo") or {}
        # anchor the policy to MEMBERSHIP (rec["backends"]), not the live
        # count: an ejected-but-provisioned backend is the router's
        # short-horizon remedy in flight, and the policy acts on provisioned
        # capacity through lifecycle.scale_to — anchoring to backends_live
        # would make every ejection look like a retirement. The live count
        # rides along separately: burn + (live < membership) is the
        # short-handed grow signal.
        live = rec.get("backends_live")
        decision = self.autoscaler.observe(
            float(rec.get("queue_depth") or 0),
            int(rec.get("backends") or rec.get("backends_live")
                or rec.get("replicas") or 1),
            slo_attainment=slo.get("attainment"),
            burn_alert=bool(firing),
            alert_episode=firing[0]["episode"] if firing else None,
            backends_live=None if live is None else int(live),
        )
        if decision is not None:
            self.decisions.append(decision)
        return decision

    # -- the attachment loop -------------------------------------------------

    def run(self, duration_s: float, stop: threading.Event | None = None) -> int:
        """Attached scrape-and-tick loop for ``duration_s`` (or until
        ``stop``); returns the number of policy ticks taken.

        Healthy scrapes anchor to the absolute monotonic grid exactly like
        :meth:`MonitorScraper.run` (late scrapes emit ``late_scrape``). A
        FAILED scrape switches to jitter-free exponential backoff — while
        the front door is down there is no window to align, and hammering
        a restarting endpoint on the grid helps nobody. Recovery re-anchors
        the grid at the reattach instant."""
        s = self.scraper
        stop = stop or threading.Event()
        clock = s.clock
        start = clock()
        end = start + float(duration_s)
        next_t = start
        down_attempts = 0
        while clock() < end and not stop.is_set():
            rec = s.scrape_once()
            if rec is None:
                # endpoint unreachable: scrape_once already reported the
                # scrape_error event; back off (bounded) instead of gridding
                down_attempts += 1
                if down_attempts >= self.max_reconnects:
                    self.give_up = {
                        "reason": "reconnect_exhausted",
                        "attempts": down_attempts,
                        "cursor": s.events_cursor,
                    }
                    ev = {"event": "monitor_attach_giveup", **self.give_up,
                          "t_s": s._rel(clock()), "mark": s._mark}
                    s.events.add(ev)
                    s._emit("monitor_event", **ev)
                    break
                delay = min(
                    self.reconnect_max_s,
                    self.reconnect_backoff_s * (2.0 ** (down_attempts - 1)),
                )
                if stop.wait(delay):
                    break
                next_t = clock()  # re-anchor the grid at whatever comes next
                continue
            if down_attempts:
                # recovered: the kept per-source cursor resumes the event
                # tail across the restart (start_seq epochs — no gaps, no
                # duplicates), and the grid re-anchors here
                self.reattaches += 1
                ev = {"event": "monitor_reattach",
                      "after_attempts": down_attempts,
                      "cursor": s.events_cursor,
                      "t_s": s._rel(clock()), "mark": s._mark}
                s.events.add(ev)
                s._emit("monitor_event", **ev)
                down_attempts = 0
            self.tick(rec)
            next_t += s.interval_s
            now = clock()
            if now > next_t:
                ev = {"event": "late_scrape", "t_s": s._rel(now),
                      "late_s": round(now - next_t, 4),
                      "slots_skipped": int((now - next_t) // s.interval_s),
                      "mark": s._mark}
                s.events.add(ev)
                s._emit("monitor_event", **ev)
                while next_t <= now:
                    next_t += s.interval_s
            elif stop.wait(next_t - now):
                break
        return self.ticks

    def summary(self) -> dict:
        """The ``handsoff`` block a run records inside its
        ``monitor_summary`` (the report's hands-off gate evidence)."""
        return {
            "ticks": self.ticks,
            "decisions": len(self.decisions),
            "scale_events": [
                {"direction": d.get("direction"),
                 "backends": d.get("backends"),
                 "decision": d.get("decision"),
                 "alert_episode": d.get("alert_episode"),
                 "burn_alert": d.get("burn_alert")}
                for d in self.decisions
            ],
            "reattaches": self.reattaches,
            "give_up": self.give_up,
        }
