"""Profiling hooks (``qdml_tpu/utils/profiling.py``).

- :func:`trace`: a ``torch.profiler`` session around device work, written
  as a Chrome trace (``trace.json``) under a directory;
- :func:`device_busy_us`: the time the device was busy in a session, the
  union of its device activities' intervals (kernels, copies, fills; the
  user annotations the profiler mirrors onto the device timeline, which
  span kernels already counted, are left out);
- :class:`StepTimer`: steady-state step timing, ``warmup`` untimed steps and
  then timed ones ended by a host fetch (which waits for the card), with
  samples/sec and the percentiles of the tick-to-tick intervals;
- :func:`card`: the card's name and power limit as ``nvidia-smi`` reports
  them, to stand beside every number measured on it.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Iterator

import torch


def force(x: torch.Tensor) -> float:
    """A host scalar from ``x``: waits for the work that produces it."""
    return float(x.reshape(-1)[0])


@contextlib.contextmanager
def trace(logdir: str, device: torch.device) -> Iterator[torch.profiler.profile]:
    """``with trace(dir, dev) as prof:`` profiles the enclosed work (the CPU,
    and the card when ``device`` is one) and writes ``dir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_busy_us(events) -> float:
    """Microseconds in which the device ran something, from a finished
    session's ``prof.events()``: the union of the intervals of its device
    activities, so that work counted twice (overlapping streams) is counted
    once; GPU user annotations (``record_function`` ranges such as
    ``Optimizer.step`` mirrored onto the device) are not activities. 0.0
    when the session traced no device."""
    return union_us(
        (evt.time_range.start, evt.time_range.end)
        for evt in events
        if "CUDA" in str(getattr(evt, "device_type", "")) and not getattr(evt, "is_user_annotation", False)
    )


def union_us(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            busy += end - max(start, reach)
            reach = end
    return float(busy)


def card() -> str | None:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``'s
    first line, or None where there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0] if lines else None


class StepTimer:
    """Throughput of a step loop: ``warmup`` untimed ticks (the last one
    waits for the card and starts the clock), then timed ticks; the timed
    span ends at the first read after the last tick, with a fetch of the
    last tick's output.

    >>> timer = StepTimer(warmup=2)
    >>> for _ in range(12):
    ...     timer.tick(step()["loss"])
    >>> timer.samples_per_sec(rows_per_step)

    ``histogram()`` summarizes the tick-to-tick intervals as percentiles;
    each tick's own enqueue runs ahead of the card, so they are dispatch
    intervals backpressured by it, not synchronized step times."""

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self._seen = 0
        self._steps = 0
        self._t0: float | None = time.perf_counter() if warmup == 0 else None
        self._t_prev = self._t0
        self._last: torch.Tensor | None = None
        self._frozen: float | None = None
        self._intervals: list[float] = []

    def tick(self, out: torch.Tensor | None = None) -> None:
        self._seen += 1
        self._last = out
        self._frozen = None
        if self._seen == self.warmup:
            if out is not None:
                force(out)  # drain the queue before the clock starts
            self._t0 = self._t_prev = time.perf_counter()
        elif self._seen > self.warmup:
            self._steps += 1
            now = time.perf_counter()
            if self._t_prev is not None:
                self._intervals.append(now - self._t_prev)
            self._t_prev = now

    def elapsed(self) -> float:
        """Seconds over the timed steps, frozen at the first read after the
        last tick."""
        if self._t0 is None:
            return 0.0
        if self._frozen is None:
            if self._last is not None:
                force(self._last)
                self._last = None
            self._frozen = time.perf_counter() - self._t0
        return self._frozen

    def steps_per_sec(self) -> float:
        dt = self.elapsed()
        return self._steps / dt if dt > 0 else 0.0

    def samples_per_sec(self, rows_per_step: int) -> float:
        return self.steps_per_sec() * rows_per_step

    def histogram(self) -> dict | None:
        """``n``, mean, p50, p95, p99 and max of the timed intervals in ms
        (nearest rank, as the JAX package's ``Histogram``); None before any."""
        if not self._intervals:
            return None
        v = sorted(self._intervals)

        def pct(p: float) -> float:
            return round(v[min(len(v) - 1, int(round(p / 100.0 * (len(v) - 1))))] * 1e3, 3)

        return {
            "n": len(v),
            "mean_ms": round(sum(v) / len(v) * 1e3, 3),
            "p50_ms": pct(50),
            "p95_ms": pct(95),
            "p99_ms": pct(99),
            "max_ms": round(v[-1] * 1e3, 3),
        }
