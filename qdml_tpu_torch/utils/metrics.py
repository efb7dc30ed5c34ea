"""NMSE metrics and a JSONL metrics log (``qdml_tpu/utils/metrics.py``).

NMSE is the reference's whole-batch ratio ``sum((x_hat - x)**2) / sum(x**2)``,
reported in dB as ``10 * log10(nmse)``. The logger writes one JSON object per
line and is a telemetry sink (``active``, ``write_raw``, ``emit``): spans,
counters, numerics, cost and the serving tier's records go into the same
stream as the metrics, after the run manifest it opens with when given one.
"""

from __future__ import annotations

import json
import math
import os
import time
from typing import Any

import torch


def nmse(x_hat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Whole-batch NMSE over real arrays."""
    return torch.sum((x_hat - x) ** 2) / torch.sum(x**2)


def nmse_db(value: float) -> float:
    return 10.0 * math.log10(max(float(value), 1e-30))


class MetricsLogger:
    """Append-only JSONL metrics stream with an optional console echo.

    Records keep the JAX package's bare shape: ``ts``, then ``step`` when
    given, then the values. ``path=None`` logs to the console only, and so
    does every rank but 0 of a ``torch.distributed`` world;
    ``manifest`` (a :func:`~qdml_tpu_torch.telemetry.manifest.run_manifest`
    record) is written as the file's first line, as the JAX package's
    logger writes it."""

    def __init__(self, path: str | None = None, echo: bool = True, manifest: dict | None = None):
        self.path = path
        self.echo = echo
        self._fh = None
        from qdml_tpu_torch.telemetry.core import is_primary

        if path is not None and is_primary():  # under a world, rank 0 alone writes
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")
            if manifest is not None:  # the stream's header line
                self.write_raw(dict(manifest))

    @property
    def active(self) -> bool:
        """Whether records reach a file (a sink that writes nowhere is inert)."""
        return self._fh is not None

    @property
    def telemetry(self) -> "MetricsLogger":
        """The sink behind this logger: the logger itself (the JAX package's
        ``MetricsLogger.telemetry``)."""
        return self

    def span(self, name: str, **tags):
        """A :func:`~qdml_tpu_torch.telemetry.spans.span` into this stream."""
        from qdml_tpu_torch.telemetry.spans import span

        return span(name, sink=self, **tags)

    def write_raw(self, rec: dict) -> None:
        """Append one record exactly as given."""
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def emit(self, kind: str, **payload: Any) -> dict:
        """Append one typed record ``{"kind", "ts", **payload}``."""
        rec = {"kind": kind, "ts": round(time.time(), 3), **payload}
        self.write_raw(rec)
        return rec

    def log(self, step: int | None = None, **values: Any) -> None:
        rec: dict[str, Any] = {"ts": round(time.time(), 3)}
        if step is not None:
            rec["step"] = step
        for k, v in values.items():
            rec[k] = float(v) if hasattr(v, "item") else v
        self.write_raw(rec)
        if self.echo:
            shown = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in rec.items() if k != "ts"}
            print(" ".join(f"{k}={v}" for k, v in shown.items()), flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
