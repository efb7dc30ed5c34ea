"""Streaming drift detection over per-scenario serve statistics (``qdml_tpu/control/drift.py``).

Per (scenario, signal) a one-sided Page-Hinkley/CUSUM statistic against the
stream's own running mean, with a magnitude slack ``delta`` and a trip
threshold, hardened two ways because a false fine-tune + swap cycle is
expensive:

- **min_samples**: the running mean must be established before the
  statistic can trip;
- **debounce**: ``debounce`` CONSECUTIVE tripping windows are required
  before a ``drift_event`` fires.

A fired detector latches (:meth:`DriftMonitor.active`) until the controller
adapts and calls :meth:`DriftMonitor.reset`, which re-arms it against the
post-adaptation distribution.

Signals and their trip directions: ``confidence`` (the routed class's
windowed mean probability) trips on a sustained drop; ``nmse_parity``
(served NMSE in dB, fed by harnesses that know the ground truth) on a
sustained rise, its slack and threshold scaled by :data:`DB_SCALE`;
``overflow_rate`` (sparse overflow fraction, scenario ``-1``) on a
sustained rise. The detector map is written by the controller's tick thread
and read by status paths, so it is guarded by one lock.
"""

from __future__ import annotations

from qdml_tpu_torch.control.events import emit_record
from qdml_tpu_torch.utils import lockdep

# nmse_parity streams are in dB (~10x the dynamic range of the [0, 1]
# fraction signals): detector delta/threshold scale up by this factor.
DB_SCALE = 10.0

# signal -> trip direction ("down": a sustained drop is drift; "up": a rise)
SIGNALS: dict[str, str] = {
    "confidence": "down",
    "nmse_parity": "up",
    "overflow_rate": "up",
}


class PageHinkley:
    """One-sided Page-Hinkley/CUSUM mean-shift detector for a scalar stream.

    ``update(x)`` folds one observation into the running mean and the
    cumulative deviation ``cum = max(0, cum + dev)``, ``dev`` being ``mean -
    x - delta`` (direction "down") or ``x - mean - delta`` ("up"); returns
    True while ``cum > threshold`` once ``min_samples`` observations
    established the mean."""

    def __init__(
        self,
        delta: float = 0.01,
        threshold: float = 0.15,
        direction: str = "down",
        min_samples: int = 5,
    ):
        if direction not in ("down", "up"):
            raise ValueError(f"direction must be 'down' or 'up', got {direction!r}")
        if delta < 0 or threshold <= 0:
            raise ValueError(
                f"need delta >= 0 and threshold > 0, got {delta}, {threshold}"
            )
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.direction = direction
        self.min_samples = int(min_samples)
        self.reset()

    def reset(self) -> None:
        self.n = 0
        self.mean = 0.0
        self.cum = 0.0

    def update(self, x: float) -> bool:
        x = float(x)
        self.n += 1
        # the mean of everything seen so far, x included
        self.mean += (x - self.mean) / self.n
        dev = (self.mean - x - self.delta) if self.direction == "down" else (
            x - self.mean - self.delta
        )
        self.cum = max(0.0, self.cum + dev)
        return self.n >= self.min_samples and self.cum > self.threshold


class DriftMonitor:
    """Per-(scenario, signal) detector bank with debounce and latched events.

    ``observe(scenario, signal, value)`` feeds one windowed statistic and
    returns a ``drift_event`` record the FIRST time that stream's debounced
    detector fires (also emitted to the telemetry sink); the stream then
    stays ``active`` until :meth:`reset` re-arms it."""

    def __init__(
        self,
        delta: float = 0.01,
        threshold: float = 0.15,
        debounce: int = 2,
        min_samples: int = 5,
        sink=None,
    ):
        self.delta = float(delta)
        self.threshold = float(threshold)
        self.debounce = max(1, int(debounce))
        self.min_samples = int(min_samples)
        self._sink = sink
        self._lock = lockdep.Lock("DriftMonitor._lock")
        # (scenario, signal) -> {"det": PageHinkley, "hits": int, "fired": bool}
        self._windows: dict[tuple[int, str], dict] = {}

    def observe(self, scenario: int, signal: str, value: float) -> dict | None:
        """Feed one windowed statistic; the ``drift_event`` record on the
        debounced first trip of that (scenario, signal) stream, else
        ``None``. An unknown signal raises."""
        if signal not in SIGNALS:
            raise ValueError(f"unknown drift signal {signal!r} (have {sorted(SIGNALS)})")
        with self._lock:
            key = (int(scenario), signal)
            ent = self._windows.get(key)
            if ent is None:
                scale = DB_SCALE if signal == "nmse_parity" else 1.0
                ent = self._windows[key] = {
                    "det": PageHinkley(
                        delta=self.delta * scale,
                        threshold=self.threshold * scale,
                        direction=SIGNALS[signal],
                        min_samples=self.min_samples,
                    ),
                    "hits": 0,
                    "fired": False,
                }
            if ent["fired"]:
                return None  # latched: one event per drift episode
            det: PageHinkley = ent["det"]
            tripped = det.update(value)
            ent["hits"] = ent["hits"] + 1 if tripped else 0
            if ent["hits"] < self.debounce:
                return None
            ent["fired"] = True
            event = {
                "scenario": int(scenario),
                "signal": signal,
                "value": round(float(value), 6),
                "mean": round(det.mean, 6),
                "stat": round(det.cum, 6),
                "threshold": det.threshold,
                "windows": det.n,
                "debounce": self.debounce,
            }
        return emit_record(self._sink, "drift_event", **event)

    def active(self) -> list[tuple[int, str]]:
        """(scenario, signal) streams whose drift_event fired and was not
        reset: the controller's adaptation queue."""
        with self._lock:
            return sorted(k for k, e in self._windows.items() if e["fired"])

    def reset(self, scenario: int | None = None) -> None:
        """Re-arm the detectors (all, or one scenario's), after an
        adaptation deploys."""
        with self._lock:
            for (s, _sig), ent in self._windows.items():
                if scenario is None or s == int(scenario):
                    ent["det"].reset()
                    ent["hits"] = 0
                    ent["fired"] = False

    def state(self) -> dict:
        """Snapshot for status displays and control_event records."""
        with self._lock:
            return {
                f"{s}:{sig}": {
                    "n": e["det"].n,
                    "mean": round(e["det"].mean, 6),
                    "stat": round(e["det"].cum, 6),
                    "hits": e["hits"],
                    "fired": e["fired"],
                }
                for (s, sig), e in sorted(self._windows.items())
            }
