"""Device/step counters: percentile histograms, memory stats, loop clocks
(``qdml_tpu/telemetry/counters.py``).

Everything reports p50/p95/max beside the mean: a stall hides inside a
good-looking mean. :class:`StepClock` is the train loops' instrumentation:
the first dispatch of a run (kernel builds and loads, cuDNN's choices, the
first CUDA-graph capture's eager chunk) is recorded apart as ``compile_s``;
later dispatches go into steady-state and host-transfer histograms, flushed
as one ``counters`` record an epoch with a memory snapshot of the cards and
the port's counterparts of JAX's compile-cache counters
(:func:`work_counters`).
"""

from __future__ import annotations

import contextlib
import sys
import time
from typing import Iterator

from qdml_tpu_torch.telemetry import spans as _spans


class Histogram:
    """Streaming duration collector; summarizes as p50/p95/p99/max (ms)."""

    __slots__ = ("_vals",)

    def __init__(self):
        self._vals: list[float] = []

    def add(self, seconds: float) -> None:
        self._vals.append(seconds)

    def __len__(self) -> int:
        return len(self._vals)

    def reset(self) -> None:
        self._vals = []

    def merge(self, other: "Histogram") -> "Histogram":
        """Fold another histogram's samples into this one. Exact: the raw
        samples are kept, so merged quantiles are the quantiles of the
        concatenated samples. Returns ``self``."""
        self._vals.extend(other._vals)
        return self

    def sum(self) -> float:
        """Exact sample sum, in the unit the samples were added in."""
        return sum(self._vals)

    def summary(self, unit: str | None = "ms") -> dict | None:
        """``{"n", "mean_ms", "p50_ms", "p95_ms", "p99_ms", "max_ms"}``, or
        None when empty. ``unit=None`` summarizes unitless samples (fills,
        depths, confidences): no scaling and unsuffixed keys."""
        if not self._vals:
            return None
        v = sorted(self._vals)

        def pct(p: float) -> float:
            return v[min(len(v) - 1, int(round(p / 100.0 * (len(v) - 1))))]

        if unit == "ms":
            fmt = lambda s: round(s * 1e3, 3)  # noqa: E731
            sfx = "_ms"
        else:
            fmt = lambda s: round(s, 4)  # noqa: E731
            sfx = ""
        return {
            "n": len(v),
            f"mean{sfx}": fmt(sum(v) / len(v)),
            f"p50{sfx}": fmt(pct(50)),
            f"p95{sfx}": fmt(pct(95)),
            f"p99{sfx}": fmt(pct(99)),
            f"max{sfx}": fmt(v[-1]),
        }


def device_memory_snapshot() -> dict | None:
    """Per-card memory under JAX's keys (``bytes_in_use``: allocated by
    torch's caching allocator, ``peak_bytes_in_use``: its peak since the
    last reset, ``bytes_limit``: the card's total memory), for every
    visible card, and ``live_tensors`` where the allocator counts them.
    None without a card (JAX's snapshot without a backend); never raises."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    out: dict = {"devices": []}
    for i in range(torch.cuda.device_count()):
        ent: dict = {"id": i, "kind": torch.cuda.get_device_name(i)}
        try:
            ent["bytes_in_use"] = int(torch.cuda.memory_allocated(i))
            ent["peak_bytes_in_use"] = int(torch.cuda.max_memory_allocated(i))
            ent["bytes_limit"] = int(torch.cuda.mem_get_info(i)[1])
        except RuntimeError:  # a card the process cannot query keeps its name only
            pass
        out["devices"].append(ent)
    try:
        out["live_tensors"] = int(torch.cuda.memory_stats(0).get("active.all.current", 0))
    except RuntimeError:
        pass
    return out


def work_counters() -> dict:
    """The port's counterparts of JAX's compile-cache counters, process-wide
    since start: kernel builds (``nvcc`` runs) and loads, CUDA-graph
    captures and replays (:mod:`qdml_tpu_torch.train.scan`), and autotune
    measurements and table writes. The serving engine's
    ``request_path_work`` reads the same counters. A module not yet
    imported has done none of its work: its counts are 0."""
    out = dict.fromkeys(("kernel_builds", "kernel_loads", "graph_captures", "graph_replays",
                         "autotune_measure", "autotune_table_write"), 0)
    kernels = sys.modules.get("qdml_tpu_torch.quantum.kernels")
    if kernels is not None:
        out["kernel_builds"] = sum(kernels.builds.values())
        out["kernel_loads"] = len(kernels._libs)
    scan = sys.modules.get("qdml_tpu_torch.train.scan")
    if scan is not None:
        out["graph_captures"] = scan.activity["captures"]
        out["graph_replays"] = scan.activity["replays"]
    tune = sys.modules.get("qdml_tpu_torch.utils.tune_table")
    if tune is not None:
        out["autotune_measure"] = tune.activity["measure"]
        out["autotune_table_write"] = tune.activity["save"]
    return out


class _StepCtx:
    """Handle yielded by :meth:`StepClock.step`; ``transfer()`` marks where
    dispatch ends and the host transfer (a device-to-host fetch) begins."""

    __slots__ = ("t_transfer",)

    def __init__(self):
        self.t_transfer: int | None = None  # time.perf_counter_ns()

    def transfer(self) -> None:
        self.t_transfer = time.perf_counter_ns()


class StepClock:
    """Per-loop step timing: first dispatch vs steady state vs host transfer.

    >>> clock = StepClock("hdce_train")
    >>> with clock.step() as st:
    ...     m = step(batch)                 # dispatch
    ...     st.transfer()                   # host transfer starts here
    ...     loss = float(m["loss"])
    >>> clock.epoch_end(epoch=0)            # one counters record

    The first ``step()`` of the clock's life is recorded as ``compile_s``
    (and a ``compile_first_step`` span) and kept out of the steady-state
    histogram. The pre-``transfer()`` segment is enqueue time; the transfer
    segment carries the device work the host waits for."""

    def __init__(self, name: str, sink=None):
        self.name = name
        self._sink = sink
        self.compile_s: float | None = None
        self.steps = Histogram()
        self.transfers = Histogram()

    def _target(self):
        return self._sink if self._sink is not None else _spans.get_sink()

    @contextlib.contextmanager
    def step(self) -> Iterator[_StepCtx]:
        ctx = _StepCtx()
        t0 = time.perf_counter_ns()
        yield ctx
        t1 = time.perf_counter_ns()
        if self.compile_s is None:
            self.compile_s = (t1 - t0) / 1e9
            target = self._target()
            if target is not None and getattr(target, "active", False):
                target.write_raw(_spans.record("compile_first_step", f"{self.name}/compile_first_step", 0, t0, t1))
        else:
            self.steps.add((t1 - t0) / 1e9)
            if ctx.t_transfer is not None:
                self.transfers.add((t1 - ctx.t_transfer) / 1e9)

    def epoch_end(self, **tags) -> None:
        """Flush one ``counters`` record (step/transfer percentiles, the
        explicit ``host_transfers`` count, memory snapshot, work counters)
        and reset the histograms."""
        target = self._target()
        if target is not None and getattr(target, "active", False):
            target.emit(
                "counters",
                name=self.name,
                compile_s=round(self.compile_s, 6) if self.compile_s else None,
                step=self.steps.summary(),
                host_transfer=self.transfers.summary(),
                # a count (0, not a null summary): the zero-transfer contract
                # of the K-step path at probe_every=0 is read off this field
                host_transfers=len(self.transfers),
                memory=device_memory_snapshot(),
                compile_cache=work_counters(),
                **tags,
            )
        self.steps.reset()
        self.transfers.reset()
