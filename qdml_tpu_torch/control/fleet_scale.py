"""Fleet-tier autoscaling (``qdml_tpu/control/fleet_scale.py``): the backend-count axis.

:class:`~qdml_tpu_torch.control.autoscale.Autoscaler` resizes replicas
inside the existing hosts; this policy changes how many host processes
exist, driving :meth:`~qdml_tpu_torch.fleet.lifecycle.BackendLifecycle.scale_to`
(spawn-and-warm admission / drain-then-retire) through an injected
``scale_fn``. The discipline mirrors the replica scaler (hysteresis,
debounce, cooldown, hard min/max bounds, SLO-guarded scale-down) with two
additions:

- **burn-alert guard**: while the monitor's burn-rate alert fires,
  scale-down is refused; a burn alert alone never spawns either, except
  with a provably short-handed fleet (``backends_live`` below the
  provisioned membership), and then the decision carries the alert's
  episode id.
- **planner targets**: a ``plan --emit-target`` JSON pins the wanted
  backend count; the policy converges to it one cooldown-spaced step at a
  time (scale-down still guarded), and every event records the target's
  ``assumptions_sha``.

Every decision emits a ``fleet_scale_event`` (``control/events.py``);
``dry_run`` reports decisions without calling ``scale_fn``. Decisions and
events are the JAX policy's, step for step.
"""

from __future__ import annotations

import json

from qdml_tpu_torch.control.events import emit_record
from qdml_tpu_torch.utils import lockdep

#: scale-down is refused when windowed SLO attainment is below this (the
#: replica autoscaler's guard, one tier up)
SLO_FLOOR = 0.99


def load_planner_target(path: str) -> dict:
    """Read a ``plan --emit-target`` JSON (the shape of the JAX package's
    ``telemetry/capacity.py:emit_target``). Raises ValueError when the file carries no
    actionable count (``backends_needed: null`` — the planner's honest
    "unmeetable at any size" answer must not be silently coerced)."""
    with open(path) as fh:
        rec = json.load(fh)
    tgt = rec.get("fleet_target") if "fleet_target" in rec else rec
    if not isinstance(tgt, dict) or tgt.get("backends_needed") is None:
        raise ValueError(
            f"{path} carries no actionable backends_needed "
            "(planner target unmet at every candidate size?)"
        )
    return tgt


class FleetAutoscaler:
    """Hysteresis policy over the fleet-total queue depth (and/or a planner
    target), acting through ``scale_fn(n_backends) -> record``."""

    def __init__(
        self,
        scale_fn,
        min_backends: int = 1,
        max_backends: int = 4,
        queue_high: float = 32.0,
        queue_low: float = 2.0,
        debounce: int = 2,
        cooldown_ticks: int = 5,
        sink=None,
        dry_run: bool = False,
    ):
        if not 1 <= int(min_backends) <= int(max_backends):
            raise ValueError(
                f"need 1 <= min_backends <= max_backends, got "
                f"{min_backends}..{max_backends}"
            )
        if not float(queue_low) < float(queue_high):
            raise ValueError(
                f"need fleet_queue_low < fleet_queue_high, got "
                f"{queue_low} >= {queue_high}"
            )
        self.min_backends = int(min_backends)
        self.max_backends = int(max_backends)
        self.queue_high = float(queue_high)
        self.queue_low = float(queue_low)
        self.debounce = max(1, int(debounce))
        self.cooldown_ticks = max(0, int(cooldown_ticks))
        self._scale_fn = scale_fn
        self._sink = sink
        self.dry_run = bool(dry_run)
        self._lock = lockdep.Lock("FleetAutoscaler._lock")
        self._target = self.min_backends
        self._high_streak = 0
        self._low_streak = 0
        self._cooldown = 0
        self._planner: dict | None = None
        self._decisions = 0

    @classmethod
    def from_config(cls, control, scale_fn, sink=None, dry_run: bool | None = None) -> "FleetAutoscaler":
        """The policy at ``ControlConfig``'s ``min_backends``,
        ``max_backends``, ``fleet_queue_high``, ``fleet_queue_low``,
        ``fleet_debounce`` and ``fleet_cooldown_ticks``; ``dry_run``
        defaults to ``control.dry_run``."""
        return cls(
            scale_fn,
            min_backends=control.min_backends,
            max_backends=control.max_backends,
            queue_high=control.fleet_queue_high,
            queue_low=control.fleet_queue_low,
            debounce=control.fleet_debounce,
            cooldown_ticks=control.fleet_cooldown_ticks,
            sink=sink,
            dry_run=control.dry_run if dry_run is None else dry_run,
        )

    def set_planner_target(self, target: dict | None) -> None:
        """Pin (or clear) a ``plan --emit-target`` record: the policy then
        converges to its ``backends_needed`` (clamped to the min/max
        bounds) instead of walking the watermarks."""
        with self._lock:
            self._planner = dict(target) if target else None

    def _clamp(self, n: int) -> int:
        return max(self.min_backends, min(self.max_backends, int(n)))

    def observe(
        self,
        queue_depth: float,
        backends: int,
        slo_attainment: float | None = None,
        burn_alert: bool = False,
        alert_episode: str | None = None,
        backends_live: int | None = None,
    ) -> dict | None:
        """One policy tick over the monitor's windowed signals. Returns the
        emitted ``fleet_scale_event`` payload when a decision fired, else
        None. ``backends`` is the OBSERVED provisioned membership — the
        policy re-anchors to it each tick, so an operator's manual
        fleet-scale is respected, exactly like the replica scaler.
        ``backends_live`` is the router's live (non-ejected) count when the
        caller has it: a firing burn alert combined with
        ``backends_live < backends`` counts as grow pressure (the fleet is
        provably short-handed AND paging), rides the same debounce, and the
        decision carries ``alert_episode`` — the burn alert's episode id —
        so the event stream answers "which alert drove this scale-up" by
        join, not by timestamp proximity."""
        slo_ok = slo_attainment is None or slo_attainment >= SLO_FLOOR
        short_handed = (
            burn_alert
            and backends_live is not None
            and int(backends_live) < max(1, int(backends))
        )
        with self._lock:
            self._target = max(1, int(backends))
            if self._cooldown > 0:
                self._cooldown -= 1
                self._high_streak = self._low_streak = 0
                return None
            planner = self._planner
            direction = None
            if planner is not None:
                desired = self._clamp(planner["backends_needed"])
                if desired > self._target:
                    direction = "up"
                elif desired < self._target and slo_ok and not burn_alert:
                    direction = "down"
            else:
                if queue_depth > self.queue_high or short_handed:
                    self._high_streak += 1
                    self._low_streak = 0
                elif queue_depth < self.queue_low and slo_ok and not burn_alert:
                    self._low_streak += 1
                    self._high_streak = 0
                else:
                    self._high_streak = self._low_streak = 0
                if (
                    self._high_streak >= self.debounce
                    and self._target < self.max_backends
                ):
                    direction = "up"
                elif (
                    self._low_streak >= self.debounce
                    and self._target > self.min_backends
                ):
                    direction = "down"
            if direction is None:
                return None
            new_target = self._target + (1 if direction == "up" else -1)
            self._target = new_target
            self._high_streak = self._low_streak = 0
            self._cooldown = self.cooldown_ticks
            self._decisions += 1
            decision = f"scale#{self._decisions}"
        rec = None if self.dry_run else self._scale_fn(new_target)
        return emit_record(
            self._sink, "fleet_scale_event",
            action="fleet_scale", direction=direction, backends=new_target,
            backends_before=int(backends),
            backends_live=None if backends_live is None else int(backends_live),
            queue_depth=float(queue_depth),
            slo_attainment=slo_attainment, burn_alert=bool(burn_alert),
            alert_episode=alert_episode if burn_alert else None,
            decision=decision,
            planner_sha=(planner or {}).get("assumptions_sha"),
            dry_run=self.dry_run, result=rec,
        )

    def state(self) -> dict:
        with self._lock:
            return {
                "target": self._target,
                "high_streak": self._high_streak,
                "low_streak": self._low_streak,
                "cooldown": self._cooldown,
                "planner": None if self._planner is None else {
                    "backends_needed": self._planner.get("backends_needed"),
                    "assumptions_sha": self._planner.get("assumptions_sha"),
                },
            }
