"""One home for control-plane telemetry emission (``qdml_tpu/control/events.py``).

``drift_event`` and ``control_event`` records both route through
:func:`emit_record`: the durable ``counters`` record on the sink and the
live event spine (:mod:`qdml_tpu_torch.telemetry.events`).
"""

from __future__ import annotations

from qdml_tpu_torch.telemetry.events import publish
from qdml_tpu_torch.telemetry.spans import get_sink


def emit_record(sink, name: str, **payload) -> dict:
    """Emit one ``counters`` record named ``name`` to ``sink`` (or the
    process-global sink when ``sink`` is None); returns the payload either
    way, so callers can use the emitted record as their return value. Every
    record also lands on the process-global event spine, the live
    ``{"op": "events"}`` tail."""
    target = sink if sink is not None else get_sink()
    if target is not None and getattr(target, "active", False):
        target.emit("counters", name=name, **payload)
    publish(name, tier="control", **payload)
    return payload
