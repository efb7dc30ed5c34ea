"""The control plane (``qdml_tpu/control/``): the closed serve -> detect -> adapt -> deploy loop.

- :mod:`~qdml_tpu_torch.control.drift`: Page-Hinkley/CUSUM detectors over
  per-scenario serve statistics with debounce, emitting ``drift_event``s;
- :mod:`~qdml_tpu_torch.control.finetune`: fine-tuning of ONLY the drifted
  trunk (head and other trunks bit-identical) on the drifted family;
- :mod:`~qdml_tpu_torch.control.deploy`: the canary gate, the explicit-tag
  hot-swap and the watch window with automatic rollback;
- :mod:`~qdml_tpu_torch.control.autoscale`: a queue-depth replica
  autoscaler with hysteresis over ``ReplicaPool.scale_to``;
- :mod:`~qdml_tpu_torch.control.fleet_scale`: the fleet autoscaler, the
  backend-count axis over ``BackendLifecycle.scale_to``;
- :mod:`~qdml_tpu_torch.control.loop`: :class:`FleetController`, the
  supervised loop (``control``), in process, over the serve socket or over
  a fleet router (:class:`~qdml_tpu_torch.fleet.poller.FleetPoller`).

Knobs: :class:`qdml_tpu_torch.config.ControlConfig`.
"""

from qdml_tpu_torch.control.autoscale import Autoscaler  # noqa: F401
from qdml_tpu_torch.control.deploy import Deployer  # noqa: F401
from qdml_tpu_torch.control.drift import DriftMonitor, PageHinkley  # noqa: F401
from qdml_tpu_torch.control.finetune import finetune_trunk  # noqa: F401
from qdml_tpu_torch.control.loop import FleetController  # noqa: F401
