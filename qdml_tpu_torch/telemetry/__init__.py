"""The telemetry names the serving tier uses (``qdml_tpu/telemetry/``).

Only these are ported: :class:`~.counters.Histogram` (exact merges),
:func:`~.spans.span` with the process-global sink (:func:`~.spans.set_sink`
/ :func:`~.spans.get_sink`), the request phase trace (:mod:`.tracing`) and
the event spine (:mod:`.events`). A sink is anything with ``active``,
``write_raw(record)`` and ``emit(kind, **payload)``:
:class:`~qdml_tpu_torch.utils.metrics.MetricsLogger` is one. Run manifests,
device counters, the report gate and the rest of the JAX package's
telemetry are ROADMAP A.12.
"""

from qdml_tpu_torch.telemetry.counters import Histogram  # noqa: F401
from qdml_tpu_torch.telemetry.events import (  # noqa: F401
    EventBus,
    ensure_bus,
    get_bus,
    install_bus,
    publish,
)
from qdml_tpu_torch.telemetry.spans import get_sink, set_sink, span  # noqa: F401
from qdml_tpu_torch.telemetry.tracing import PHASES, TraceContext, trace_sampled  # noqa: F401
