"""Nested wall-clock spans and the process-global sink (``qdml_tpu/telemetry/spans.py``).

``with span("serve_warmup"): ...`` times the block and writes one ``span``
record at exit (children close before parents; ``path``/``depth`` rebuild
the tree) to the explicit ``sink``, else to the process-global one
(:func:`set_sink`). With neither, a span costs two clock reads. Under a
``torch.distributed`` world a record carries the writing rank as
``process``. Bridge: while a ``torch.profiler`` session is recording, each
span is also a ``record_function`` range, so it shows as a named region in
the trace (:func:`profiler_trace`, ``cli profile``).
"""

from __future__ import annotations

import contextlib
import sys
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


def _process_index() -> int | None:
    dist = sys.modules.get("torch.distributed")
    if dist is None or not (dist.is_available() and dist.is_initialized()):
        return None
    return dist.get_rank()


def _bridge(name: str):
    """A ``record_function`` range while a profiler session records, else
    nothing (spans cost no profiler work outside a trace)."""
    profiler = sys.modules.get("torch.autograd.profiler")
    if profiler is None or not getattr(profiler, "_is_profiler_enabled", False):
        return contextlib.nullcontext()
    return profiler.record_function(name)


@contextlib.contextmanager
def span(name: str, sink=None, **tags) -> Iterator[None]:
    """Time a block; write one nested ``span`` record at exit."""
    st = _stack()
    st.append(name)
    path = "/".join(st)
    t_wall = time.time()
    t0 = time.perf_counter()
    try:
        with _bridge(name):
            yield
    finally:
        dur = time.perf_counter() - t0
        st.pop()
        target = sink if sink is not None else _sink
        if target is not None and getattr(target, "active", False):
            rec = {
                "kind": "span",
                "ts": round(t_wall, 3),
                "name": name,
                "path": path,
                "depth": len(st),
                "dur_s": round(dur, 6),
                **tags,
            }
            proc = _process_index()
            if proc is not None:
                rec["process"] = proc
            target.write_raw(rec)


@contextlib.contextmanager
def profiler_trace(logdir: str, device=None, sink=None) -> Iterator:
    """A ``torch.profiler`` session over the enclosed work, wrapped in a
    ``torch_profiler_trace`` span (``qdml_tpu/telemetry/spans.py:97-108``,
    ``jax_profiler_trace`` there). Yields the profiler; the Chrome trace is
    written to ``logdir/trace.json`` at exit (:func:`~qdml_tpu_torch.utils.
    profiling.trace`)."""
    import torch

    from qdml_tpu_torch.utils.profiling import trace

    with span("torch_profiler_trace", sink=sink, logdir=logdir):
        with trace(logdir, torch.device(device or "cpu")) as prof:
            yield prof
