"""Serving telemetry (``qdml_tpu/serve/metrics.py:29-379``): latency, fill, goodput, SLO.

:class:`ServeMetrics` collects one serving window: per-request latency,
batch fill and queue depth, the row ledger behind goodput and padding
waste, SLO attainment, per-scenario counts and confidences, sheds, faults
and restarts, and the per-phase latency of traced requests. Each worker
thread records into its own collector; :meth:`ServeMetrics.merge` folds them
exactly (the histograms keep raw samples). With an active sink, each
dispatch writes a ``serve_batch`` span, each request a ``serve_request``
span, and :meth:`ServeMetrics.flush` one ``counters`` record.

The summary keeps the JAX package's keys. Where JAX reports its compile-cache
counters (``compile_cache`` / ``compile_cache_after_warmup``), the port
reports the dict of :meth:`ServeEngine.request_path_work
<qdml_tpu_torch.serve.engine.ServeEngine.request_path_work>`: the race
measurements, table writes and kernel builds since warmup, since torch
compiles nothing.
"""

from __future__ import annotations

import time

from qdml_tpu_torch.serve.types import DispatchInfo, Overloaded, Prediction
from qdml_tpu_torch.telemetry.counters import Histogram
from qdml_tpu_torch.telemetry.spans import get_sink
from qdml_tpu_torch.telemetry.tracing import PHASES


class ServeMetrics:
    """Latency/fill/depth/goodput collector for one serving window."""

    def __init__(self, sink=None, log_requests: bool = True):
        self._sink = sink
        self.log_requests = log_requests
        self.latency = Histogram()       # per-request enqueue -> result
        self.batch_fill = Histogram()    # valid/static rows per dispatch (0..1)
        self.queue_depth = Histogram()   # depth at dequeue (unitless count)
        # Per-phase latency decomposition from SAMPLED request traces
        # (telemetry/tracing.py): one histogram per phase
        # name, raw seconds, so Histogram.merge aggregates replicas/workers
        # exactly like the end-to-end latency. The five gated phases are
        # pre-seeded; router-side auxiliary spans (pick, dedup_wait) land in
        # histograms created on first sight. ``traced`` counts predictions
        # that CARRIED a trace — the coverage fact the report states next to
        # any phase claim (a p99 over 1% of requests is not the fleet's p99).
        self.phase: dict[str, Histogram] = {p: Histogram() for p in PHASES}
        self.traced = 0
        # Goodput-first row accounting. Three row ledgers, three meanings:
        # - rows_useful: rows the client could USE — completed within their
        #   deadline, or completed with no deadline offered (the serving
        #   literature's goodput numerator: a row delivered after its SLO is
        #   throughput, not goodput); fed per prediction.
        # - rows_valid: real (non-padding) rows dispatched (DispatchInfo.n).
        # - rows_dispatched: what the card actually computed (padded bucket/tier
        #   shapes, every chunk counted) — the gap to rows_valid is padding
        #   waste, the number the ragged batching mode exists to account for
        #   and a report watches.
        # Kept as raw sums so windowed pollers can difference snapshots
        # exactly, like the confidence sums.
        self.rows_useful = 0
        self.rows_valid = 0
        self.rows_dispatched = 0
        self.dispatches = 0              # forward passes (chunks included)
        # classifier-confidence histogram (routed-class probability per
        # prediction; raw samples, so Histogram.merge aggregates exactly) +
        # per-scenario prediction counts and confidence SUMS. The sums exist
        # so a poller can window the stream by differencing two snapshots
        # (mean-of-window = d(sum)/d(n)) — a cumulative histogram cannot be
        # differenced, and drift detectors live on
        # windowed per-scenario means.
        self.confidence = Histogram()
        self.scenario_counts: dict[str, int] = {}
        self.scenario_conf_sum: dict[str, float] = {}
        self.batches = 0
        self.completed = 0
        self.shed: dict[str, int] = {}
        # fault/recovery accounting: worker crashes and
        # batch-level engine failures observed by the serve loop (injected
        # chaos faults included — FaultInjected counts under its kind), and
        # supervised replica restarts. Raw sums, snapshot-differencable.
        self.faults: dict[str, int] = {}
        self.restarts = 0
        # SLO attainment: of the requests that CARRIED a deadline, how many
        # resolved within it. Completions feed via Prediction.deadline_met;
        # a shed request that had a deadline is a miss by definition (the
        # client never got an answer in time).
        self.slo_total = 0
        self.slo_met = 0
        self._t0 = time.perf_counter()

    def _target(self):
        return self._sink if self._sink is not None else get_sink()

    def observe_batch(
        self, preds: list[Prediction], info: DispatchInfo, depth: int, dur_s: float
    ) -> None:
        """One engine dispatch's worth of results. ``info`` is the engine's
        :class:`DispatchInfo`: its static-row total keeps fill/pad accounting
        honest even for oversize batches served in chunks (``n / rows`` is
        never > 1 — the pre-ragged accounting divided by the last chunk's
        bucket alone and inflated chunked fills past 1.0)."""
        self.batches += 1
        self.completed += len(preds)
        self.rows_valid += info.n
        self.rows_dispatched += info.rows
        self.dispatches += info.chunks
        self.batch_fill.add(info.fill)
        self.queue_depth.add(float(depth))
        target = self._target()
        active = target is not None and getattr(target, "active", False)
        if active:
            target.emit(
                "span",
                name="serve_batch",
                path="serve/serve_batch",
                depth=1,
                dur_s=round(dur_s, 6),
                n=len(preds),
                bucket=info.bucket,
                rows=info.rows,
                batching=info.mode,
                queue_depth=depth,
            )
        for p in preds:
            self.observe_prediction(p)
            if active and self.log_requests:
                target.emit(
                    "span",
                    name="serve_request",
                    path="serve/serve_request",
                    depth=2,
                    dur_s=round(p.latency_s, 6),
                    rid=p.rid,
                    bucket=info.bucket,
                )

    def observe_prediction(self, p: Prediction) -> None:
        """Per-request accounting shared by :meth:`observe_batch` and the
        windowed loadgen summaries (which replay results into a fresh
        collector): latency, SLO, per-scenario counts, confidence, and — for
        the sampled traced fraction — the per-phase latency decomposition."""
        self.latency.add(p.latency_s)
        if p.trace is not None:
            self.traced += 1
            for name, dur_s in p.trace.phases:
                hist = self.phase.get(name)
                if hist is None:
                    hist = self.phase[name] = Histogram()
                hist.add(dur_s)
        # goodput numerator: a late completion is throughput, not goodput
        if p.deadline_met is not False:
            self.rows_useful += 1
        if p.deadline_met is not None:
            self.slo_total += 1
            self.slo_met += int(p.deadline_met)
        key = str(p.scenario)
        self.scenario_counts[key] = self.scenario_counts.get(key, 0) + 1
        if p.confidence is not None:
            self.confidence.add(float(p.confidence))
            self.scenario_conf_sum[key] = self.scenario_conf_sum.get(key, 0.0) + float(
                p.confidence
            )

    def observe_shed(self, o: Overloaded, had_deadline: bool = False) -> None:
        self.shed[o.reason] = self.shed.get(o.reason, 0) + 1
        if had_deadline:
            self.slo_total += 1  # shed with a deadline = an SLO miss

    def observe_fault(self, kind: str) -> None:
        """One worker-path failure (crash, batch exception, injected chaos
        fault) — the serve loop records the KIND so a chaos run's summary
        attributes every fault class it survived."""
        self.faults[kind] = self.faults.get(kind, 0) + 1

    def merge(self, other: "ServeMetrics") -> "ServeMetrics":
        """Fold another collector into this one (``Histogram.merge`` keeps
        raw samples, so the merged quantiles are exact, not approximate).
        Per-WORKER collectors aggregate this way: each serve-loop worker
        thread records into its own ServeMetrics — no cross-thread lock on
        the hot path — and snapshots merge on demand. The window start is
        the earliest of the two, so a merged ``rps`` spans the union."""
        self.latency.merge(other.latency)
        self.batch_fill.merge(other.batch_fill)
        self.queue_depth.merge(other.queue_depth)
        self.confidence.merge(other.confidence)
        for name, hist in other.phase.items():
            mine = self.phase.get(name)
            if mine is None:
                mine = self.phase[name] = Histogram()
            mine.merge(hist)
        self.traced += other.traced
        self.batches += other.batches
        self.completed += other.completed
        self.rows_useful += other.rows_useful
        self.rows_valid += other.rows_valid
        self.rows_dispatched += other.rows_dispatched
        self.dispatches += other.dispatches
        for k, v in other.shed.items():
            self.shed[k] = self.shed.get(k, 0) + v
        for k, v in other.faults.items():
            self.faults[k] = self.faults.get(k, 0) + v
        self.restarts += other.restarts
        for k, v in other.scenario_counts.items():
            self.scenario_counts[k] = self.scenario_counts.get(k, 0) + v
        for k, v in other.scenario_conf_sum.items():
            self.scenario_conf_sum[k] = self.scenario_conf_sum.get(k, 0.0) + v
        self.slo_total += other.slo_total
        self.slo_met += other.slo_met
        self._t0 = min(self._t0, other._t0)
        return self

    def slo(self) -> dict | None:
        """``{"n", "met", "attainment"}`` over deadline-carrying requests, or
        ``None`` when no request in the window had a deadline (an attainment
        over zero requests would read as a perfect-or-failed SLO that was
        never actually offered)."""
        if self.slo_total == 0:
            return None
        return {
            "n": self.slo_total,
            "met": self.slo_met,
            "attainment": round(self.slo_met / self.slo_total, 4),
        }

    def padding_waste(self) -> float | None:
        """Fraction of dispatched rows that were padding (``1 -
        valid/dispatched``), or ``None`` before any dispatch was OBSERVED
        (a window rebuilt from results alone — the loadgen external-pool
        replay — has no dispatch-side row counts, and a fabricated 0.0
        would read as perfect fill that was never measured)."""
        if self.rows_dispatched == 0:
            return None
        return round(1.0 - self.rows_valid / self.rows_dispatched, 4)

    def rows(self) -> dict | None:
        """The raw row ledger behind goodput/padding-waste (``None`` before
        any observed dispatch): useful vs valid vs dispatched rows and
        forward passes — snapshot-differencable, like the confidence
        sums."""
        if self.rows_dispatched == 0:
            return None
        return {
            "useful": self.rows_useful,
            "valid": self.rows_valid,
            "dispatched": self.rows_dispatched,
            "padded": self.rows_dispatched - self.rows_valid,
            "dispatches": self.dispatches,
        }

    def per_scenario(self) -> dict | None:
        """Per predicted-scenario counts + confidence stats, or ``None``
        before any prediction. ``conf_sum`` is deliberately raw (not just the
        mean): two snapshots of a live server difference to an exact window
        mean, which is what the drift detectors consume."""
        if not self.scenario_counts:
            return None
        out: dict = {}
        for k in sorted(self.scenario_counts, key=int):
            n = self.scenario_counts[k]
            rec: dict = {"n": n}
            if k in self.scenario_conf_sum and n:
                cs = self.scenario_conf_sum[k]
                rec["conf_sum"] = round(cs, 4)
                rec["conf_mean"] = round(cs / n, 4)
            out[k] = rec
        return out

    def phases(self) -> dict | None:
        """Per-phase latency summaries from the traced sample (``None``
        before any traced request): per phase, the exact quantile summary
        PLUS ``(n, sum_ms)`` — the pair the fleet router sums EXACTLY across
        backends (quantiles cannot cross a process boundary exactly; the raw
        samples live here)."""
        out: dict = {}
        for name, hist in self.phase.items():
            s = hist.summary()
            if s is None:
                continue
            s["sum_ms"] = round(hist.sum() * 1e3, 3)
            out[name] = s
        return out or None

    def trace_coverage(self) -> dict | None:
        """The sampling fact that must sit next to any phase claim: how many
        of the window's completed requests actually carried a trace. ``None``
        when nothing was traced (a phase table with no stated coverage reads
        as the whole fleet's decomposition when it may be 1% of it)."""
        if not self.traced:
            return None
        return {
            "sampled": self.traced,
            "completed": self.completed,
            "fraction": (
                round(self.traced / self.completed, 4) if self.completed else None
            ),
        }

    def flush(self, compile_cache: dict | None = None, **tags) -> None:
        """One ``counters`` record for the window; histograms keep
        accumulating (the final summary sees the whole run)."""
        target = self._target()
        if target is not None and getattr(target, "active", False):
            elapsed = time.perf_counter() - self._t0
            target.emit(
                "counters",
                name="serve",
                latency=self.latency.summary(),
                phases=self.phases(),
                trace=self.trace_coverage(),
                batch_fill=self.batch_fill.summary(unit=None),
                queue_depth=self.queue_depth.summary(unit=None),
                batches=self.batches,
                completed=self.completed,
                goodput_rps=(
                    round(self.rows_useful / elapsed, 2) if elapsed > 0 else None
                ),
                padding_waste=self.padding_waste(),
                rows=self.rows(),
                shed=dict(self.shed),
                faults=dict(self.faults),
                restarts=self.restarts,
                slo=self.slo(),
                confidence=self.confidence.summary(unit=None),
                per_scenario=self.per_scenario(),
                compile_cache=compile_cache,
                **tags,
            )

    def snapshot(self, compile_cache: dict | None = None, **extra) -> dict:
        """The live-metrics view (``{"op": "metrics"}`` serve verb): the
        summary fields without the ``serve_summary`` record kind — a poll of
        a running server is a reading, not a run artifact."""
        s = self.summary(compile_cache=compile_cache, **extra)
        s.pop("kind", None)
        return s

    def summary(self, compile_cache: dict | None = None, **extra) -> dict:
        """The run-level ``serve_summary`` record (the JAX package's
        report reads exactly this shape)."""
        elapsed = time.perf_counter() - self._t0
        return {
            "kind": "serve_summary",
            "elapsed_s": round(elapsed, 3),
            "completed": self.completed,
            "batches": self.batches,
            "shed": dict(self.shed),
            # fault-tolerance accounting: worker-path
            # failures by kind + supervised replica restarts in this window
            "faults": dict(self.faults),
            "restarts": self.restarts,
            "rps": round(self.completed / elapsed, 2) if elapsed > 0 else None,
            # goodput = USEFUL rows/s: completed within deadline (or with no
            # deadline offered — a request is one row here), so sheds, LATE
            # completions and the window's drain all cost goodput while mere
            # rows/s hides them; padding waste is the dispatched-row fraction
            # the card computed for nothing
            "goodput_rps": (
                round(self.rows_useful / elapsed, 2) if elapsed > 0 else None
            ),
            "padding_waste": self.padding_waste(),
            "rows": self.rows(),
            "slo": self.slo(),
            "latency_ms": self.latency.summary(),
            # the phase decomposition of that latency (traced sample only)
            # plus its coverage fact — where the time went, and how much of
            # the window actually said so
            "phases": self.phases(),
            "trace": self.trace_coverage(),
            "batch_fill": self.batch_fill.summary(unit=None),
            "queue_depth": self.queue_depth.summary(unit=None),
            # classifier-confidence histogram + per-scenario counts/means:
            # the drift detectors' raw input, independently useful fleet
            # observability
            "confidence": self.confidence.summary(unit=None),
            "per_scenario": self.per_scenario(),
            "compile_cache_after_warmup": compile_cache,
            **extra,
        }
