"""Per-request phase tracing (``qdml_tpu/telemetry/tracing.py:62-146``).

A sampled :class:`TraceContext` rides a request (its id is the request id)
and collects phase *durations* stamped at host-side boundaries: batcher
enqueue, dequeue, the engine's compute and fetch, future resolution.

- **Host-side only**: nothing here runs inside a kernel or a captured graph.
- **Free when off**: ``serve.trace_sample=0`` builds no context and reads no
  clock for it.
- **One clock a duration**: every phase is measured on one host's clock;
  two hosts' timestamps are never differenced.

Phases, in pipeline order: ``batch_wait`` (enqueue to the batch's newest
member's enqueue), ``queue_wait`` (from there to dequeue), ``compute``
(dispatch until the card's work is done), ``fetch`` (the device-to-host
copy of the reply), ``wire`` (a router's exchange, :mod:`qdml_tpu_torch.fleet`).
"""

from __future__ import annotations

import hashlib

# The gated phase vocabulary, in pipeline order. ServeMetrics accepts any
# phase name (routers add pick/dedup_wait), but these five are the report's
# decomposition gates.
PHASES: tuple[str, ...] = ("batch_wait", "queue_wait", "compute", "fetch", "wire")

_SAMPLE_BUCKETS = 1 << 16


def trace_sampled(rid, rate: float) -> bool:
    """Deterministic id-hash sampling: the same request id makes the same
    decision on the client, the router and every backend WITHOUT any
    coordination bit on the wire — a retried/failed-over id stays traced
    end to end. ``rate`` <= 0 never samples (the overhead-free default);
    >= 1 always; in between, a stable md5 bucket of ``str(rid)``."""
    if rate <= 0.0:
        return False
    if rate >= 1.0:
        return True
    h = int.from_bytes(hashlib.md5(str(rid).encode()).digest()[:4], "big")
    return (h % _SAMPLE_BUCKETS) < rate * _SAMPLE_BUCKETS


class TraceContext:
    """One request's ordered (phase, duration) spans + the end-to-end total.

    Durations are seconds internally (the Histogram convention) and
    milliseconds on the wire (the reply-latency convention). Phases may
    repeat — a failover retry appends one ``wire`` span per attempt.
    ``detail`` carries structured non-duration facts (the router's attempt
    table, dedup re-attachment) that ride the wire for humans and the dryrun
    checks but never enter a histogram.
    """

    __slots__ = ("rid", "phases", "total_s", "detail")

    def __init__(self, rid, phases=None, total_s: float | None = None,
                 detail: dict | None = None):
        self.rid = rid
        self.phases: list[tuple[str, float]] = list(phases or [])
        self.total_s = total_s
        self.detail = detail

    def add_phase(self, name: str, dur_s: float) -> None:
        """Append one measured span. Clamped at zero: a fake-clock test (or
        a coarse clock) must never histogram a negative duration."""
        self.phases.append((str(name), max(0.0, float(dur_s))))

    def phase_sum_s(self) -> float:
        return sum(d for _, d in self.phases)

    def prepend(self, phases: list[tuple[str, float]]) -> None:
        """Insert upstream-tier spans ahead of this trace's own (the router
        prepends pick/wire before the backend's queue/compute/fetch)."""
        self.phases[:0] = list(phases)

    def to_wire(self) -> dict:
        """The optional ``trace`` field of a newline-JSON reply."""
        out: dict = {
            "id": self.rid,
            "phases": [[n, round(d * 1e3, 3)] for n, d in self.phases],
        }
        if self.total_s is not None:
            out["total_ms"] = round(self.total_s * 1e3, 3)
        if self.detail:
            out["detail"] = self.detail
        return out

    @classmethod
    def from_wire(cls, obj) -> "TraceContext | None":
        """Parse a reply's ``trace`` field; tolerant — a malformed block from
        an older/newer peer degrades to None, never an exception on the
        client's reply path."""
        if not isinstance(obj, dict):
            return None
        phases: list[tuple[str, float]] = []
        for item in obj.get("phases") or []:
            if (
                isinstance(item, (list, tuple))
                and len(item) == 2
                and isinstance(item[0], str)
                and isinstance(item[1], (int, float))
            ):
                phases.append((item[0], max(0.0, float(item[1]) / 1e3)))
            else:
                return None
        total = obj.get("total_ms")
        detail = obj.get("detail")
        return cls(
            obj.get("id"),
            phases=phases,
            total_s=float(total) / 1e3 if isinstance(total, (int, float)) else None,
            detail=detail if isinstance(detail, dict) else None,
        )
