"""FleetPoller (``qdml_tpu/fleet/poller.py``): the control plane's attachment to the router tier.

:class:`~qdml_tpu_torch.control.loop.SocketPoller` generalized over the
router's aggregated verbs: the
:class:`~qdml_tpu_torch.control.loop.FleetController`'s drift detection
windows the summed per-scenario counters exactly as it windows one host's
(raw sums difference exactly), the queue-depth autoscaler sees the
fleet-total depth while the router chooses which host to resize
(:meth:`FleetRouter.scale_fleet`), and a tagged deploy fans the swap to
every live backend at once.

Two forms, one contract:

- **in process**: :class:`FleetPoller` wraps a live
  :class:`~qdml_tpu_torch.fleet.router.FleetRouter`;
- **remote**: the router's front socket speaks the serve protocol, so a
  ``SocketPoller`` pointed at the router's address is the remote fleet
  poller (``control`` against ``fleet.host:fleet.port``);
  :meth:`FleetPoller.remote` spells that out.

A swap that lands on every LIVE backend succeeds even when ejected hosts
were skipped (one backend's ejection never suspends adaptation for the
others); a swap that failed on a live backend raises, which the
controller's ``tick_failed`` path reports and survives.
"""

from __future__ import annotations

from qdml_tpu_torch.fleet.router import FleetRouter


class FleetPoller:
    """In-process controller attachment to a running :class:`FleetRouter`.
    ``lifecycle`` (a :class:`~qdml_tpu_torch.fleet.lifecycle.BackendLifecycle`)
    arms :meth:`fleet`: the backend-count axis, distinct from
    :meth:`scale`'s replica axis."""

    def __init__(self, router: FleetRouter, lifecycle=None):
        self.router = router
        self.lifecycle = lifecycle

    def metrics(self) -> dict:
        """The aggregated fleet view (summed counters + per-backend rows) —
        the same payload the router's ``{"op": "metrics"}`` verb serves."""
        return self.router.live_metrics()

    def health(self) -> dict:
        """The cheap cached-poll view (per-backend rows carry ``uptime_s`` /
        ``start_seq``, the monitor's restart detectors) — the same payload
        the router's ``{"op": "health"}`` verb serves."""
        return self.router.health()

    def events(self, cursor: dict | None = None, limit: int = 512) -> dict:
        """The aggregated event-spine tail (router's own + every live
        backend's, per-source cursors) — the same payload the router's
        ``{"op": "events"}`` verb serves."""
        return self.router.live_events(cursor, limit=limit)

    def swap(self, tags: dict) -> dict:
        rec = self.router.swap_fanout(tags)
        if not rec["ok"]:
            # a LIVE backend failed to swap: the deploy did not land fleet-
            # wide — typed failure for the controller's tick_failed path
            # (skipped ejected hosts alone never get here: ok stays true)
            raise RuntimeError(
                f"fleet swap partial: {rec['ok_count']}/{rec['fanned_to']} "
                f"live backends swapped ({rec['backends']})"
            )
        return rec

    def scale(self, n: int) -> dict:
        """Replica axis: fleet-total replica target, router picks the host."""
        return self.router.scale_fleet(n)

    def fleet(self, backends: int | None = None) -> dict:
        """Backend-count axis: membership status, or (with ``backends``)
        converge the serving member count through the lifecycle manager —
        the same facts the front door's ``{"op": "fleet"}`` verb serves."""
        if backends is None:
            if self.lifecycle is not None:
                return self.lifecycle.status()
            return {
                "backends": len(self.router.live_backends()),
                "backends_draining": sum(
                    1 for b in self.router.backends if b.draining
                ),
            }
        if self.lifecycle is None:
            raise RuntimeError(
                "fleet_scale_unavailable: poller has no lifecycle manager"
            )
        return self.lifecycle.scale_to(int(backends))

    @staticmethod
    def remote(host: str, port: int, timeout_s: float = 30.0):
        """The remote twin: the router speaks the serve protocol, so the
        control plane's existing socket attachment IS the remote fleet
        poller when pointed at the router's front address."""
        from qdml_tpu_torch.control.loop import SocketPoller

        return SocketPoller(host, port, timeout_s=timeout_s)
