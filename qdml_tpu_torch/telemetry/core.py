"""Telemetry sink: one append-only JSONL stream a run, written by one rank
(``qdml_tpu/telemetry/core.py``).

A :class:`Telemetry` owns the run's JSONL file. Every record kind shares the
one stream: a ``manifest`` header line first, then ``metrics`` (the bare
records), ``span``, ``counters``, ``numerics`` and ``cost`` lines, so one
artifact carries the numbers and their provenance.

Under a ``torch.distributed`` world every rank measures and only rank 0
writes: the others' sinks are inert (``active`` False, writes no-ops).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import IO, Any


def is_primary() -> bool:
    """True on the one process that writes shared files: rank 0 of a live
    ``torch.distributed`` world, else True. Reads the world only when
    ``torch.distributed`` is already imported, so a host-side tool (``report``)
    never imports torch for it."""
    dist = sys.modules.get("torch.distributed")
    if dist is None:
        return True
    try:
        return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0
    except (RuntimeError, ValueError):  # a world torn down mid-call acts as one process
        return True


class Telemetry:
    """Append-only JSONL telemetry stream.

    ``manifest`` (a :func:`~qdml_tpu_torch.telemetry.manifest.run_manifest`
    dict) is written as the stream's first record at open: every run appends
    its own, so a resumed file carries one header per invocation."""

    def __init__(self, path: str | None = None, manifest: dict | None = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._fh: IO[str] | None = None
        if path is not None and is_primary():
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._fh = open(path, "a", buffering=1)
            if manifest is not None:
                self.write_raw(dict(manifest))

    @property
    def active(self) -> bool:
        """Whether writes reach a file (the primary process, with a path)."""
        return self._fh is not None

    def write_raw(self, rec: dict) -> None:
        """Append one record exactly as given."""
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
        if self.echo:
            print(json.dumps(rec), flush=True)

    def emit(self, kind: str, **payload: Any) -> dict:
        """Append one typed record ``{"kind": kind, "ts": ..., **payload}``."""
        rec = {"kind": kind, "ts": round(time.time(), 3), **payload}
        self.write_raw(rec)
        return rec

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
