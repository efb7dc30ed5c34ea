"""Circuit-breaker brownout for the serving front door (``qdml_tpu/serve/breaker.py``).

When the shared queue crosses a high watermark the breaker opens and new
submits fast-fail with a typed ``Overloaded("breaker_open")`` before they
enter the queue: requests already queued keep their place, and a retrying
client gets an immediate signal instead of a doomed wait. It keeps shedding
until the backlog has drained (hysteresis). States, clock injected:

- **closed**: everything admits; depth >= high watermark opens it;
- **open**: every submit fast-fails for ``open_s`` seconds;
- **half-open**: up to ``probes`` submits admit; depth <= low watermark
  closes it, depth >= high (or the probes spent) re-opens it.

One breaker fronts the whole pool (submits funnel through replica 0); its
counters ride the same lock.
"""

from __future__ import annotations

import time
from typing import Callable

from qdml_tpu_torch.utils import lockdep

CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"


class CircuitBreaker:
    """Queue-depth-watermark breaker with half-open probe recovery."""

    def __init__(
        self,
        max_queue: int,
        high_frac: float = 0.8,
        low_frac: float = 0.3,
        open_s: float = 0.25,
        probes: int = 4,
        clock: Callable[[], float] = time.monotonic,
    ):
        if not (0.0 < low_frac <= high_frac <= 1.0):
            raise ValueError(
                f"need 0 < low_frac <= high_frac <= 1, got {low_frac}/{high_frac}"
            )
        self.high = max(1, int(max_queue * high_frac))
        self.low = max(0, int(max_queue * low_frac))
        self.open_s = float(open_s)
        self.probes = max(1, int(probes))
        self.clock = clock
        self._lock = lockdep.Lock("CircuitBreaker._lock")
        self._state = CLOSED
        self._opened_at = 0.0
        self._probes_left = 0
        self._opens = 0        # closed/half-open -> open transitions
        self._fast_fails = 0   # submits rejected while open
        self._admitted = 0     # submits allowed through (all states)

    def allow(self, depth: int, now: float | None = None) -> bool:
        """One submit's admission decision at current queue ``depth``.
        Runs the whole state machine: False means fast-fail with the typed
        ``breaker_open`` result, BEFORE the request touches the queue."""
        now = self.clock() if now is None else now
        with self._lock:
            if self._state == CLOSED:
                if depth >= self.high:
                    self._state = OPEN
                    self._opened_at = now
                    self._opens += 1
                    self._fast_fails += 1
                    return False
                self._admitted += 1
                return True
            if self._state == OPEN:
                if now - self._opened_at >= self.open_s:
                    self._state = HALF_OPEN
                    self._probes_left = self.probes
                else:
                    self._fast_fails += 1
                    return False
            # half-open: transition on the watermarks, else spend a probe
            if depth <= self.low:
                self._state = CLOSED
                self._admitted += 1
                return True
            if depth >= self.high or self._probes_left <= 0:
                self._state = OPEN
                self._opened_at = now
                self._opens += 1
                self._fast_fails += 1
                return False
            self._probes_left -= 1
            self._admitted += 1
            return True

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def summary(self) -> dict:
        """The ``serve_summary.breaker`` block (and the health verb's view):
        state + transition/shed counters + the open fraction a report
        compares absolutely (``serve.breaker_open_fraction``, slack-gated
        like the sparse overflow rate — healthy runs sit at 0.0)."""
        with self._lock:
            total = self._admitted + self._fast_fails
            return {
                "state": self._state,
                "opens": self._opens,
                "fast_fails": self._fast_fails,
                "admitted": self._admitted,
                "open_fraction": (
                    round(self._fast_fails / total, 6) if total else 0.0
                ),
                "high_watermark": self.high,
                "low_watermark": self.low,
            }
