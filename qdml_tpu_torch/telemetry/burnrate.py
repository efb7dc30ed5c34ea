"""SLO error-budget burn-rate alerting and the timeline dashboard (a copy
of ``qdml_tpu/telemetry/burnrate.py``).

An SLO target (say 99% of deadline-carrying requests met) implies an error
budget (1%). The burn rate is how fast a window spends it:

    burn = (windowed error rate) / (budget rate)

Burn 1x spends exactly the budget over the SLO period. One window cannot
do the job: a short one alone pages on every blip, a long one alone pages
late. :class:`BurnRateRule` evaluates a fast and a slow window and fires
only when both exceed the threshold, after ``debounce`` consecutive
evaluations over it, and stays latched until both recover;
:class:`BurnAlerter` runs one rule per monitored signal (SLO attainment,
admission sheds, breaker fast-fails, quarantine and restart events, router
failovers, externally fed stranded futures).

A window with no eligible traffic has no burn rate (:func:`burn_rate`
returns None, never 0/0) and never advances the debounce.

:meth:`BurnAlerter.for_run` scales the window pair to the run length (fast
~ run/15, slow ~ run/4, floored at two scrape intervals), so the rule
shapes of a 5m/1h production pair are testable in seconds.

:func:`render_timeline` turns a monitor JSONL stream (plus sibling event
streams: ``control_event`` / ``drift_event`` / the serving stack's
``counters``-kind fleet events) into the markdown timeline: metric windows
and structured events on one clock, each alert annotated with the events
inside its fast window. Decisions and markdown are the JAX package's on
the same records.
"""

from __future__ import annotations

from collections import deque

# the serve/fleet/control stack's structured event names worth a timeline
# row (all emitted as kind="counters" records with a "name" field)
STACK_EVENT_NAMES = (
    "replica_restarted",
    "replica_quarantined",
    "supervisor_error",
    "backend_ejected",
    "backend_readmitted",
    "router_swap",
    "router_poll_error",
    "drift_event",
    "control_event",
    "counter_reset",
)


def burn_rate(errors: float, total: float, budget: float) -> float | None:
    """Error-budget burn multiple for one window; None when the window has
    no eligible traffic (0/0 is 'no evidence', not 'no burn')."""
    if total is None or total <= 0:
        return None
    bad = max(0.0, float(errors)) / float(total)
    if budget <= 0:
        return float("inf") if bad > 0 else 0.0
    return bad / budget


class BurnRateRule:
    """One signal's fast/slow window pair with debounce + latch."""

    def __init__(
        self,
        signal: str,
        budget: float,
        fast_s: float,
        slow_s: float,
        threshold: float,
        debounce: int = 2,
    ):
        if slow_s < fast_s:
            raise ValueError(f"slow window {slow_s} < fast window {fast_s}")
        self.signal = signal
        self.budget = float(budget)
        self.fast_s = float(fast_s)
        self.slow_s = float(slow_s)
        self.threshold = float(threshold)
        self.debounce = max(1, int(debounce))
        self._samples: deque = deque()  # (t, errors, total)
        self._pending = 0
        self.firing = False
        self.peak_fast = 0.0
        self.peak_slow = 0.0
        self.fired_count = 0
        self.resolved_count = 0

    @property
    def pending(self) -> int:
        """Consecutive over-threshold evaluations so far toward ``debounce``
        (0 while firing)."""
        return self._pending

    def feed(self, t: float, errors: float, total: float) -> None:
        self._samples.append((float(t), float(errors), float(total)))
        horizon = t - self.slow_s
        while self._samples and self._samples[0][0] <= horizon:
            self._samples.popleft()

    def _window_burn(self, t: float, width: float) -> float | None:
        lo = t - width
        err = tot = 0.0
        for ts, e, n in self._samples:
            if ts > lo:
                err += e
                tot += n
        return burn_rate(err, tot, self.budget)

    def burns(self, t: float) -> dict:
        return {"fast": self._window_burn(t, self.fast_s),
                "slow": self._window_burn(t, self.slow_s)}

    def evaluate(self, t: float) -> dict | None:
        """One evaluation at time ``t``; returns the alert-transition
        payload (state firing/resolved) or None. Multi-window: fires iff
        BOTH windows exceed the threshold for ``debounce`` consecutive
        evaluations; latched: resolves only when BOTH recover."""
        fast = self._window_burn(t, self.fast_s)
        slow = self._window_burn(t, self.slow_s)
        if fast is not None:
            self.peak_fast = max(self.peak_fast, fast)
        if slow is not None:
            self.peak_slow = max(self.peak_slow, slow)
        if fast is None or slow is None:
            return None  # zero-traffic window: no evidence, no transition
        over = fast >= self.threshold and slow >= self.threshold
        if not self.firing:
            self._pending = self._pending + 1 if over else 0
            if self._pending >= self.debounce:
                self.firing = True
                self._pending = 0
                self.fired_count += 1
                return self._alert("firing", t, fast, slow)
            return None
        if not over and fast < self.threshold and slow < self.threshold:
            self.firing = False
            self.resolved_count += 1
            return self._alert("resolved", t, fast, slow)
        return None

    def _alert(self, state: str, t: float, fast: float, slow: float) -> dict:
        return {
            "signal": self.signal,
            "state": state,
            # alert-episode id: one per fire, shared by the resolve that
            # closes it. The event spine hoists it as the ``episode``
            # correlation key, and the hands-off autoscaler stamps it onto
            # the scale decision it triggers — "which alert caused this
            # scale-up" is a join on this id, not a timestamp guess.
            "episode": f"{self.signal}#{self.fired_count}",
            "t_s": round(t, 4),
            "fast_burn": round(fast, 3),
            "slow_burn": round(slow, 3),
            "threshold": self.threshold,
            "budget": self.budget,
            "fast_s": self.fast_s,
            "slow_s": self.slow_s,
        }


class BurnAlerter:
    """A battery of :class:`BurnRateRule` — one per monitored signal."""

    #: default per-signal error budgets (fraction of eligible traffic that
    #: may go bad before burn 1x): slo comes from the target; the rest are
    #: operational budgets for events that should essentially never happen
    DEFAULT_BUDGETS = {
        "shed": 0.02,
        "breaker": 0.02,
        "quarantine": 0.05,
        "router": 0.02,
        "stranded": 0.001,
    }

    def __init__(self, rules: dict[str, BurnRateRule]):
        self.rules = dict(rules)

    @classmethod
    def for_run(
        cls,
        duration_s: float,
        interval_s: float,
        slo_target: float = 0.99,
        threshold: float = 8.0,
        fast_s: float | None = None,
        slow_s: float | None = None,
        debounce: int = 2,
        budgets: dict[str, float] | None = None,
    ) -> "BurnAlerter":
        """Window pair scaled to the run length (see module docstring);
        explicit ``fast_s``/``slow_s`` override the scaling."""
        fast = fast_s if fast_s else min(max(2 * interval_s, duration_s / 15.0), 300.0)
        slow = slow_s if slow_s else min(max(3 * fast, duration_s / 4.0), 3600.0)
        slow = max(slow, fast)
        b = dict(cls.DEFAULT_BUDGETS)
        b["slo"] = max(1e-6, 1.0 - float(slo_target))
        if budgets:
            b.update(budgets)
        return cls({
            sig: BurnRateRule(sig, budget, fast, slow, threshold, debounce)
            for sig, budget in b.items()
        })

    def feed(self, t: float, signal: str, errors: float, total: float) -> None:
        rule = self.rules.get(signal)
        if rule is not None:
            rule.feed(t, errors, total)

    def evaluate(self, t: float, mark: str = "") -> list[dict]:
        out = []
        for rule in self.rules.values():
            a = rule.evaluate(t)
            if a is not None:
                a["mark"] = mark
                out.append(a)
        return out

    def burns(self, t: float) -> dict:
        """Current fast/slow burns per signal (only signals with evidence)."""
        out = {}
        for sig, rule in self.rules.items():
            b = rule.burns(t)
            if b["fast"] is not None or b["slow"] is not None:
                out[sig] = {
                    k: (None if v is None else round(v, 3))
                    for k, v in b.items()
                }
        return out

    def peaks(self) -> dict:
        return {
            sig: {"fast": round(r.peak_fast, 3), "slow": round(r.peak_slow, 3)}
            for sig, r in self.rules.items()
            if r.peak_fast > 0 or r.peak_slow > 0
        }

    def firing(self) -> list[dict]:
        """Currently-latched alerts as ``[{"signal", "episode"}]`` — the
        open episode ids the hands-off attachment stamps onto any scale
        decision made while they burn (telemetry/attach.py)."""
        return [
            {"signal": sig, "episode": f"{sig}#{r.fired_count}"}
            for sig, r in self.rules.items()
            if r.firing
        ]


# ---------------------------------------------------------------------------
# timeline rendering
# ---------------------------------------------------------------------------


def _event_label(rec: dict) -> str:
    if rec.get("kind") == "monitor_event" or "event" in rec:
        name = rec.get("event", "?")
        who = rec.get("backend") or rec.get("replica") or ""
        return f"{name}({who})" if who else str(name)
    if rec.get("kind") == "counter_reset":
        return f"counter_reset({rec.get('counter')})"
    name = rec.get("name", rec.get("kind", "?"))
    if name == "control_event":
        return f"control:{rec.get('action', '?')}"
    if name == "drift_event":
        return f"drift(s{rec.get('scenario', '?')})"
    who = rec.get("backend") or rec.get("replica") or ""
    return f"{name}({who})" if who else str(name)


def render_timeline(records: list[dict], extra_events: list[dict] | None = None,
                    max_rows: int = 200) -> str:
    """The markdown timeline dashboard: one table row per monitor window,
    structured events correlated onto the same clock, alerts annotated
    with the events inside their fast window (the 'what was happening when
    it paged' view). ``extra_events`` merges sibling JSONL streams (a
    control loop's control_event/drift_event records, a serve run's fleet
    events) by wall-clock ``ts``."""
    manifest = next((r for r in records if r.get("kind") == "manifest"), None)
    windows = [r for r in records if r.get("kind") == "monitor_timeseries"]
    events = [r for r in records
              if r.get("kind") in ("monitor_event", "counter_reset")]
    alerts = [r for r in records if r.get("kind") == "monitor_alert"]
    summary = next(
        (r for r in records if r.get("kind") == "monitor_summary"), None
    )

    # wall-clock -> monitor-relative mapping for sibling streams
    offset = None
    for w in windows:
        if w.get("ts") is not None and w.get("t_s") is not None:
            offset = float(w["ts"]) - float(w["t_s"])
            break
    merged = list(events)
    for rec in extra_events or []:
        name = rec.get("name")
        if rec.get("kind") == "counters" and name in STACK_EVENT_NAMES:
            if offset is not None and rec.get("ts") is not None:
                rec = dict(rec)
                rec["t_s"] = round(float(rec["ts"]) - offset, 4)
            merged.append(rec)
    merged = [e for e in merged if e.get("t_s") is not None]
    merged.sort(key=lambda e: e["t_s"])

    lines: list[str] = ["# fleet flight deck — monitor timeline", ""]
    if manifest is not None:
        run = manifest.get("run") or {}
        lines.append(
            f"- source: `{run.get('argv') or manifest.get('argv') or '?'}`"
        )
    if summary is not None:
        lines.append(
            f"- {summary.get('windows')} windows over "
            f"{summary.get('duration_s')}s at {summary.get('interval_s')}s; "
            f"{(summary.get('alerts') or {}).get('fired', 0)} alert(s) fired, "
            f"{summary.get('counter_resets')} counter reset(s), "
            f"{summary.get('scrape_errors')} scrape error(s)"
        )
    lines.append("")

    lines.append("## windows")
    lines.append("")
    lines.append("| t (s) | mark | rps | slo | burn slo f/s | burn router f/s "
                 "| queue | live | events |")
    lines.append("|---|---|---|---|---|---|---|---|---|")
    shown = windows[:max_rows]
    prev_t = None
    for w in shown:
        t = w.get("t_s")
        slo = w.get("slo")
        slo_s = "—" if not slo else f"{slo['met']:.0f}/{slo['n']:.0f}"
        burn = w.get("burn") or {}

        def _fmt(v):
            return f"{v:.1f}" if isinstance(v, (int, float)) else "—"

        def _b(sig):
            b = burn.get(sig)
            if not b:
                return "—"
            return f"{_fmt(b.get('fast'))}/{_fmt(b.get('slow'))}"

        evs = [
            _event_label(e) for e in merged
            if (prev_t is None or e["t_s"] > prev_t) and e["t_s"] <= (t or 0)
            and e.get("event") != "mark"
        ]
        mark_s = w.get("mark") or ""
        alert_here = [a for a in alerts
                      if a.get("t_s") == t and a.get("state") == "firing"]
        if alert_here:
            evs = [f"**ALERT {a['signal']}**" for a in alert_here] + evs
        lines.append(
            f"| {t} | {mark_s} | {w.get('rps') if w.get('rps') is not None else '—'} "
            f"| {slo_s} | {_b('slo')} | {_b('router')} "
            f"| {w.get('queue_depth')} | {w.get('backends_live') if w.get('backends_live') is not None else w.get('replicas')} "
            f"| {', '.join(evs) if evs else ''} |"
        )
        prev_t = t
    if len(windows) > max_rows:
        lines.append("")
        lines.append(f"_... {len(windows) - max_rows} more windows truncated_")
    lines.append("")

    lines.append("## alerts")
    lines.append("")
    if not alerts:
        lines.append("none fired.")
    for a in alerts:
        t = a.get("t_s") or 0.0
        mark_s = f" [{a['mark']}]" if a.get("mark") else ""
        lines.append(
            f"- t={t}s{mark_s} **{a.get('signal')} {a.get('state', '?').upper()}** "
            f"fast={a.get('fast_burn')}x slow={a.get('slow_burn')}x "
            f"(threshold {a.get('threshold')}x over {a.get('fast_s')}s/"
            f"{a.get('slow_s')}s, budget {a.get('budget')})"
        )
        if a.get("state") == "firing":
            lo = t - float(a.get("fast_s") or 0.0) - 1.0
            corr = [
                f"{_event_label(e)}@{e['t_s']}s" for e in merged
                if lo <= e["t_s"] <= t + 0.5 and e.get("event") != "mark"
            ]
            if corr:
                lines.append(f"  - correlated events: {', '.join(corr)}")
    lines.append("")

    if summary is not None:
        lines.append("## summary")
        lines.append("")
        peaks = summary.get("peak_burn") or {}
        if peaks:
            lines.append("| signal | peak fast burn | peak slow burn |")
            lines.append("|---|---|---|")
            for sig, p in sorted(peaks.items()):
                lines.append(f"| {sig} | {p.get('fast')}x | {p.get('slow')}x |")
            lines.append("")
        al = summary.get("alerts") or {}
        if al.get("by_mark"):
            lines.append(
                "- alerts by segment: "
                + ", ".join(f"{k or '(untagged)'}={v}"
                            for k, v in al["by_mark"].items())
            )
        if summary.get("planner") is not None:
            pl = summary["planner"]
            lines.append(
                f"- capacity-planner validation: "
                f"{'PASS' if pl.get('ok') else 'FAIL'} "
                f"({pl.get('n_windows')} window(s), max |p99 log-ratio| "
                f"{pl.get('max_p99_ratio')}, max rps err "
                f"{pl.get('max_rps_err')})"
            )
        lines.append("")
    return "\n".join(lines)
