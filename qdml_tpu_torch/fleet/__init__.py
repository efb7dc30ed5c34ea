"""The fleet router tier (``qdml_tpu/fleet/``): the front door that spans backend processes.

- :class:`~qdml_tpu_torch.fleet.router.FleetRouter`: per-backend tables,
  breaker-state ejection and re-admission, consistent-hash or
  least-queue balancing, fleet-wide request dedup, ``swap`` fan-out and
  ``metrics``/``health`` aggregation (exact counter sums, ``Histogram.merge``
  wire latency);
- :func:`~qdml_tpu_torch.fleet.frontend.run_router` (``route``): the asyncio
  front socket speaking the serve protocol, so clients, loadgen and the
  control plane cannot tell a router from a single host;
- :class:`~qdml_tpu_torch.fleet.poller.FleetPoller`: the control plane's
  attachment, so drift adaptation, canary-gated tagged hot-swap and
  queue-depth autoscaling span the fleet;
- :mod:`~qdml_tpu_torch.fleet.spawn`: real ``serve`` subprocesses, on the
  card unless ``--device=cpu`` is among their overrides;
- :class:`~qdml_tpu_torch.fleet.lifecycle.BackendLifecycle`: elastic
  membership, spawn-and-warm admission (a cold backend is never admitted),
  drain-then-retire, the ``{"op": "fleet"}`` / ``fleet-scale`` lever the
  fleet autoscaler (:mod:`qdml_tpu_torch.control.fleet_scale`) drives.

The router holds no model and does no device work; the exports are the
JAX package's ``qdml_tpu/fleet/__init__.py``'s.
"""

from qdml_tpu_torch.fleet.frontend import (  # noqa: F401
    lifecycle_from_config,
    route_async,
    router_from_config,
    run_router,
)
from qdml_tpu_torch.fleet.lifecycle import (  # noqa: F401
    AdmissionFailed,
    BackendLifecycle,
    verify_warm,
)
from qdml_tpu_torch.fleet.poller import FleetPoller  # noqa: F401
from qdml_tpu_torch.fleet.router import (  # noqa: F401
    Backend,
    BackendState,
    FleetRouter,
    RouterDedup,
    parse_backends,
)
from qdml_tpu_torch.fleet.spawn import BackendProc, spawn_backend  # noqa: F401
