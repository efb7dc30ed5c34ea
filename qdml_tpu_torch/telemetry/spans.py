"""Nested wall-clock spans and the process-global sink (``qdml_tpu/telemetry/spans.py``).

``with span("serve_warmup"): ...`` times the block and writes one ``span``
record at exit (children close before parents; ``path``/``depth`` rebuild
the tree) to the explicit ``sink``, else to the process-global one
(:func:`set_sink`). With neither, a span costs two clock reads and builds
no record. Under a ``torch.distributed`` world a record carries the writing
rank as ``process``. Bridge: while a ``torch.profiler`` session is
recording, each span is also a ``record_function`` range, so it shows as a
named region in the trace (:func:`profiler_trace`, ``cli profile``).

A record's start and end, ``t0_ns`` and ``t1_ns``, are
``time.perf_counter_ns()`` readings (on Linux ``CLOCK_MONOTONIC``, which
``time.perf_counter`` reads too), so a profiler session's device timeline
is aligned to them by one marker: a kernel launched, after a
synchronisation, at a known reading. ``dur_s`` is their difference in
seconds and ``ts`` the start's wall clock, to the millisecond. The two
clock fields are the port's own: JAX's records carry ``ts`` and ``dur_s``
alone.

``with span(...) as tags`` yields the record's tags, which the block may
add to. A hot path times its phases into a ``phases`` tag, each a
``[t0_ns, t1_ns]`` pair on the same clock, so a call writes one record
where a span a phase would write several.
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


def record(name: str, path: str, depth: int, t0_ns: int, t1_ns: int, **tags) -> dict:
    """The ``span`` record of a block that ran from ``t0_ns`` to ``t1_ns``
    (``time.perf_counter_ns`` readings): what :func:`span` writes, and any
    other code that times a block itself."""
    dur_s = (t1_ns - t0_ns) / 1e9
    rec = {
        "kind": "span",
        "ts": round(time.time() - dur_s, 3),
        "name": name,
        "path": path,
        "depth": depth,
        "dur_s": round(dur_s, 6),
        "t0_ns": t0_ns,
        "t1_ns": t1_ns,
        **tags,
    }
    proc = _process_index()
    if proc is not None:
        rec["process"] = proc
    return rec


@contextlib.contextmanager
def span(name: str, sink=None, **tags) -> Iterator[dict]:
    """Time a block; write one nested ``span`` record at exit. Yields the
    record's tags."""
    st = _stack()
    st.append(name)
    t0 = time.perf_counter_ns()
    try:
        with _bridge(name):
            yield tags
    finally:
        t1 = time.perf_counter_ns()
        target = sink if sink is not None else _sink
        active = target is not None and getattr(target, "active", False)
        path = "/".join(st) if active else ""
        st.pop()  # before the write, so a sink that raises leaves the stack right
        if active:
            target.write_raw(record(name, path, len(st), t0, t1, **tags))


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
