"""Nested wall-clock spans and the process-global sink (``qdml_tpu/telemetry/spans.py:30-94``).

``with span("serve_warmup"): ...`` times the block and writes one ``span``
record at exit (children close before parents; ``path``/``depth`` rebuild
the tree) to the explicit ``sink``, else to the process-global one
(:func:`set_sink`). With neither, a span costs two clock reads. The JAX
package's profiler bridge and ``profiler_trace`` are not ported (ROADMAP
A.12).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Iterator

_local = threading.local()
_sink = None


def set_sink(sink) -> None:
    """Install the process-global sink, or ``None`` to detach."""
    global _sink
    _sink = sink


def get_sink():
    return _sink


def _stack() -> list[str]:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


@contextlib.contextmanager
def span(name: str, sink=None, **tags) -> Iterator[None]:
    """Time a block; write one nested ``span`` record at exit."""
    st = _stack()
    st.append(name)
    path = "/".join(st)
    t_wall = time.time()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dur = time.perf_counter() - t0
        st.pop()
        target = sink if sink is not None else _sink
        if target is not None and getattr(target, "active", False):
            target.write_raw({
                "kind": "span",
                "ts": round(t_wall, 3),
                "name": name,
                "path": path,
                "depth": len(st),
                "dur_s": round(dur, 6),
                **tags,
            })
