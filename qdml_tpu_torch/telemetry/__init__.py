"""Telemetry of the port (``qdml_tpu/telemetry/``): run manifests, spans,
device counters, the numerics flight recorder, the sanitizer, cost records
and the report gate.

- :func:`run_manifest`: one header record a run (config and its hash, git
  SHA, the torch/device topology, the effective knobs, the seeds), the first
  line of every metrics JSONL;
- :func:`span`: nested wall-clock spans into the process-global sink
  (:func:`set_sink`), rank-aware, bridged into an active ``torch.profiler``
  session (:func:`profiler_trace`);
- :class:`StepClock`, :class:`Histogram`, :func:`device_memory_snapshot`:
  step percentiles, host transfers, the cards' memory and the port's work
  counters (kernel builds, graph captures and replays, autotune measures);
- :func:`probe_tree`, :class:`Watchdog`, :class:`FlightRecorder`,
  :class:`DivergenceError`: on-device numerics probes and the divergence
  watchdog with its post-mortem bundle;
- :mod:`~.sanitizer`: the runtime checks behind ``train.checkify`` and
  ``serve.checkify``;
- :mod:`~.cost`: FLOPs, bytes and roofline records of a counted dispatch;
- :mod:`~.report`: the ``report`` regression gate;
- the request phase trace (:mod:`.tracing`) and the event spine
  (:mod:`.events`) of the serving tier;
- the host-side flight deck: :mod:`.timeseries` and :mod:`.burnrate`
  (``monitor``: verb-only scraping of a running serve or route address,
  counter differencing into windows, multi-window burn-rate alerts, the
  timeline), :mod:`.attach` (``monitor --attach``, the hands-off loop),
  :mod:`.capacity` (``plan``, the trace-replay capacity planner) and
  :func:`.events.events_main` (``events``). None of them touches a device.

A sink is anything with ``active``, ``write_raw(record)`` and
``emit(kind, **payload)``: :class:`~.core.Telemetry` and
:class:`~qdml_tpu_torch.utils.metrics.MetricsLogger` are.
"""

from qdml_tpu_torch.telemetry import cost  # noqa: F401
from qdml_tpu_torch.telemetry.core import Telemetry, is_primary  # noqa: F401
from qdml_tpu_torch.telemetry.counters import (  # noqa: F401
    Histogram,
    StepClock,
    device_memory_snapshot,
)
from qdml_tpu_torch.telemetry.events import (  # noqa: F401
    EventBus,
    ensure_bus,
    get_bus,
    install_bus,
    publish,
)
from qdml_tpu_torch.telemetry.manifest import (  # noqa: F401
    config_hash,
    effective_knobs,
    run_manifest,
)
from qdml_tpu_torch.telemetry.numerics import (  # noqa: F401
    DivergenceError,
    FlightRecorder,
    Watchdog,
    probe_tree,
)
from qdml_tpu_torch.telemetry.spans import get_sink, profiler_trace, set_sink, span  # noqa: F401
from qdml_tpu_torch.telemetry.tracing import PHASES, TraceContext, trace_sampled  # noqa: F401
from qdml_tpu_torch.telemetry.timeseries import (  # noqa: F401
    MonitorScraper,
    SnapshotDiff,
    counter_delta,
)
from qdml_tpu_torch.telemetry.burnrate import (  # noqa: F401
    BurnAlerter,
    BurnRateRule,
    burn_rate,
    render_timeline,
)
