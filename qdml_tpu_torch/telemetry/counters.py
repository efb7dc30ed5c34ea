"""Percentile histograms (``qdml_tpu/telemetry/counters.py:23-87``)."""

from __future__ import annotations


class Histogram:
    """Streaming duration collector; summarizes as p50/p95/p99/max (ms)."""

    __slots__ = ("_vals",)

    def __init__(self):
        self._vals: list[float] = []

    def add(self, seconds: float) -> None:
        self._vals.append(seconds)

    def __len__(self) -> int:
        return len(self._vals)

    def reset(self) -> None:
        self._vals = []

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold another histogram's samples into this one. Exact: the raw
        samples are kept, so merged quantiles are the quantiles of the
        concatenated samples. Returns ``self``."""
        self._vals.extend(other._vals)
        return self

    def sum(self) -> float:
        """Exact sample sum, in the unit the samples were added in."""
        return sum(self._vals)

    def summary(self, unit: str | None = "ms") -> dict | None:
        """``{"n", "mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms"}``, or
        None when empty. ``unit=None`` summarizes unitless samples (fills,
        depths, confidences): no scaling and unsuffixed keys."""
        if not self._vals:
            return None
        v = sorted(self._vals)

        def pct(p: float) -> float:
            return v[min(len(v) - 1, int(round(p / 100.0 * (len(v) - 1))))]

        if unit == "ms":
            fmt = lambda s: round(s * 1e3, 3)  # noqa: E731
            sfx = "_ms"
        else:
            fmt = lambda s: round(s, 4)  # noqa: E731
            sfx = ""
        return {
            "n": len(v),
            f"mean{sfx}": fmt(sum(v) / len(v)),
            f"p50{sfx}": fmt(pct(50)),
            f"p95{sfx}": fmt(pct(95)),
            f"p99{sfx}": fmt(pct(99)),
            f"max{sfx}": fmt(v[-1]),
        }
