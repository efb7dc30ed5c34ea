"""Queue-depth replica autoscaler with hysteresis (``qdml_tpu/control/autoscale.py``).

The signal is the live ``{"op": "metrics"}`` queue depth (requests waiting
at the shared micro-batcher) plus the windowed SLO attainment:

- depth above ``queue_high`` for ``scale_debounce`` consecutive ticks scales
  UP one replica (never above ``max_replicas``);
- depth below ``queue_low`` with a healthy SLO for ``scale_debounce`` ticks
  scales DOWN one (never below ``min_replicas``);
- ``cooldown_ticks`` pass after any action before the next.

Actions go through the drain-safe pool levers
(:meth:`~qdml_tpu_torch.serve.server.ReplicaPool.scale_to`) or, remotely,
the ``{"op": "scale"}`` verb. Every decision emits a ``control_event``; in
dry-run mode the decision is reported and not taken.
"""

from __future__ import annotations

from qdml_tpu_torch.control.events import emit_record
from qdml_tpu_torch.utils import lockdep


class Autoscaler:
    """Hysteresis controller: ``observe(queue_depth, replicas, slo)`` ->
    action. ``scale_fn(n)`` performs the resize; the scaler only decides."""

    def __init__(
        self,
        scale_fn,
        min_replicas: int = 1,
        max_replicas: int = 4,
        queue_high: float = 16.0,
        queue_low: float = 2.0,
        debounce: int = 2,
        cooldown_ticks: int = 3,
        sink=None,
        dry_run: bool = False,
    ):
        if not (1 <= min_replicas <= max_replicas):
            raise ValueError(
                f"need 1 <= min_replicas <= max_replicas, got "
                f"{min_replicas}..{max_replicas}"
            )
        if queue_low >= queue_high:
            raise ValueError(
                f"hysteresis band requires queue_low < queue_high, got "
                f"{queue_low} >= {queue_high}"
            )
        self._scale_fn = scale_fn
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.debounce = max(1, int(debounce))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self._sink = sink
        self.dry_run = bool(dry_run)
        self._lock = lockdep.Lock("Autoscaler._lock")
        # the decision state: the current target (None until the first
        # observation), the debounce streaks and the cooldown countdown
        self._target: int | None = None
        self._high_streak = 0
        self._low_streak = 0
        self._cooldown = 0

    def _emit(self, **payload) -> dict:
        return emit_record(
            self._sink, "control_event",
            action="scale", dry_run=self.dry_run, **payload,
        )

    def state(self) -> dict:
        with self._lock:
            return {
                "target": self._target,
                "high_streak": self._high_streak,
                "low_streak": self._low_streak,
                "cooldown": self._cooldown,
            }

    def observe(
        self,
        queue_depth: float,
        replicas: int,
        slo_attainment: float | None = None,
    ) -> dict | None:
        """One tick: the action record when a resize was decided (and,
        unless dry-run, performed), else None. ``replicas`` is the pool's
        current size from the same poll: the scaler re-anchors to it, so a
        manual resize is respected."""
        with self._lock:
            self._target = int(replicas)
            if self._cooldown > 0:
                self._cooldown -= 1
                self._high_streak = self._low_streak = 0
                return None
            if queue_depth > self.queue_high:
                self._high_streak += 1
                self._low_streak = 0
            elif queue_depth < self.queue_low and (
                slo_attainment is None or slo_attainment >= 0.99
            ):
                self._low_streak += 1
                self._high_streak = 0
            else:
                self._high_streak = self._low_streak = 0
            up = self._high_streak >= self.debounce and self._target < self.max_replicas
            down = self._low_streak >= self.debounce and self._target > self.min_replicas
            if not (up or down):
                return None
            new_target = self._target + (1 if up else -1)
            self._target = new_target
            self._high_streak = self._low_streak = 0
            self._cooldown = self.cooldown_ticks
        direction = "up" if up else "down"
        rec = None if self.dry_run else self._scale_fn(new_target)
        return self._emit(
            direction=direction,
            replicas=new_target,
            queue_depth=round(float(queue_depth), 2),
            queue_high=self.queue_high,
            queue_low=self.queue_low,
            slo_attainment=slo_attainment,
            result=rec,
        )
