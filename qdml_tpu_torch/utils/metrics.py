"""NMSE metrics and a JSONL metrics log (``qdml_tpu/utils/metrics.py``).

NMSE is the reference's whole-batch ratio ``sum((x_hat - x)**2) / sum(x**2)``,
reported in dB as ``10 * log10(nmse)``. The logger writes one JSON object per
line; the JAX package's telemetry hooks (manifests, spans, sinks) are a later
slice of the port (ROADMAP A.12).
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
    given, then the values. ``path=None`` logs to the console only."""

    def __init__(self, path: str | None = None, echo: bool = True):
        self.path = path
        self.echo = echo
        self._fh = None
        if path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fh = open(path, "a")

    def log(self, step: int | None = None, **values: Any) -> None:
        rec: dict[str, Any] = {"ts": round(time.time(), 3)}
        if step is not None:
            rec["step"] = step
        for k, v in values.items():
            rec[k] = float(v) if hasattr(v, "item") else v
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.echo:
            shown = {k: (round(v, 6) if isinstance(v, float) else v) for k, v in rec.items() if k != "ts"}
            print(" ".join(f"{k}={v}" for k, v in shown.items()), flush=True)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
