"""The traced run's device timeline: a ``torch.profiler`` session over the
first ``trace_seconds`` of the window, read into device intervals, the busy
seconds, the kernels by name and the idle gaps by what the host had open.

The session traces the card only (CUPTI): recording every host operator
slows a host-paced run by more than the thing measured. Host spans are
kept by the benchmark itself on the host's clock (:meth:`Tracer.host_span`)
and placed on the device's timeline by a marker kernel launched right
after a synchronisation when the session starts.
"""

from __future__ import annotations

import heapq
import time
from collections import defaultdict

import torch

MARKER = "spin_kernel"  # torch.cuda._sleep's kernel

def union_s(intervals: list[tuple[float, float]]) -> tuple[float, list[tuple[float, float]]]:
    """The length (in the intervals' unit) of the union of ``intervals``,
    and the union as sorted disjoint intervals."""
    merged: list[list[float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return sum(e - s for s, e in merged), [(s, e) for s, e in merged]


class Tracer:
    """Profiles from :meth:`start` until ``seconds`` have passed on the
    host (checked at each :meth:`poll`) or :meth:`stop`. Disabled, every
    method does nothing. Starting a session takes seconds, so a window
    starts its clock after :meth:`start` returns."""

    def __init__(self, enabled: bool, seconds: float, device: torch.device):
        self.enabled = enabled
        self.seconds = seconds
        self.device = device
        self.prof = None
        self.t0 = None
        self.window_s = None
        self.done = False

    def start(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile

        self.spans: list[tuple[str, float, float]] = []
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t0 = time.perf_counter()
        torch.cuda._sleep(1000)

    @property
    def recording(self) -> bool:
        return self.prof is not None and not self.done

    def host_span(self, name: str, start: float, end: float) -> None:
        """A host span on ``time.perf_counter``'s clock, kept while recording."""
        if self.prof is not None and not self.done:
            self.spans.append((name, start, end))

    def poll(self) -> None:
        if self.prof is not None and not self.done and time.perf_counter() - self.t0 >= self.seconds:
            self.stop()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        self.done = True

    def read(self) -> dict:
        """The session read: ``device`` [(name, start_us, end_us)], ``host``
        [(name, start_us, end_us)], ``busy_s``, ``window_s`` and the
        ``breakdown``. Raises where the session holds no device activity."""
        device, marker = [], None
        for evt in self.prof.events():
            if "CUDA" not in str(getattr(evt, "device_type", "")) or getattr(evt, "is_user_annotation", False):
                continue
            rng = (evt.name, float(evt.time_range.start), float(evt.time_range.end))
            if MARKER in evt.name and (marker is None or rng[1] < marker):
                marker = rng[1]
            elif MARKER not in evt.name:
                device.append(rng)
        if not device:
            raise RuntimeError("the traced window holds no device activity: the profiler saw no kernel")
        # host seconds -> the session's microseconds, the marker launched at t0
        base = marker if marker is not None else min(s for _, s, _ in device)
        host = [(n, base + 1e6 * (a - self.t0), base + 1e6 * (b - self.t0)) for n, a, b in self.spans]
        busy_us, merged = union_s([(s, e) for _, s, e in device])
        return {"device": device, "host": host, "busy_s": busy_us / 1e6, "window_s": self.window_s,
                "breakdown": breakdown(device, host, merged)}


def breakdown(device: list, host: list, merged: list, top: int = 10) -> dict:
    """The device operations that took the most time, and the idle gaps
    between device activity summed by the host span open at each gap's
    middle (the latest-started one)."""
    per_op: dict[str, float] = defaultdict(float)
    for name, s, e in device:
        per_op[name] += (e - s) / 1e6
    host_sorted = sorted(host, key=lambda h: h[1])
    per_gap: dict[str, float] = defaultdict(float)
    heap: list[tuple[float, float, str]] = []  # (-start, end, name) of ranges begun so far
    i = 0
    for (_, end), (start, _) in zip(merged, merged[1:]):
        mid = 0.5 * (end + start)
        while i < len(host_sorted) and host_sorted[i][1] <= mid:
            name, hs, he = host_sorted[i]
            heapq.heappush(heap, (-hs, he, name))
            i += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        owner = heap[0][2] if heap else "no host span open"
        per_gap[owner] += (start - end) / 1e6
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(per_gap.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in gaps]}
