"""The program's own spans in a traced run: a sink that keeps them, their
place on the traced window's device timeline, and the readings taken from
them.

``qdml_tpu_torch.telemetry.spans`` writes one record a span to the
process-global sink, with its start and end on ``time.perf_counter_ns``'s
clock (``t0_ns``, ``t1_ns``): the clock :class:`~port_bench.tracing.Tracer`
places its host spans by. A :class:`Collector` installed as that sink keeps
every record; while it feeds a recording tracer, each span that closes is
also one of the tracer's host spans, so the breakdown's idle gaps are
summed under the program's innermost open span (``scan_stage_wait``,
``scan_replay``, ...) where the benchmark's own ``k_step_call`` covers the
whole call. A record's ``phases`` tag (the phases a hot path times inside
one record, each ``[t0_ns, t1_ns]``) is kept as child records, each named
by its phase, before the record itself.

The spans read (``qdml_tpu_torch/train/scan.py``, ``train/hdce.py``,
``train/optim.py``):

- ``scan_call`` (tag ``k``) and its ``scan_stage_wait`` phase: the host's own
  work in one K-step call, :func:`scan_host_ms`, to be read on the window's
  calls outside the profiler session (``Collector.untraced``): under CUPTI
  a 16-step graph's launch takes ~43 ms against 3-5 ms without it (H100
  80GB HBM3, 700 W);
- ``hdce_make_trainer``, with ``hdce_init``, ``hdce_to_device`` and
  ``optimizer_init`` inside: the trainer's construction in set-up,
  :func:`trainer_build_s` and :func:`setup_line`.

Wiring, in ``port_bench/harness.py:run_cell`` of a traced run: a
:class:`Collector` entered before ``drv.setup()`` and left after the
window, :meth:`Collector.feed` given the tracer before ``drv.window``, the
collector in the readers' context as ``program_spans``, and
:func:`setup_line` logged. The harness does not do this yet; the span
readings in ``PERF.md`` apply this wiring from outside it.
"""

from __future__ import annotations

import statistics


class Collector:
    """A sink that keeps the program's span records in memory while it is
    installed (``with Collector() as spans:``; the previous sink comes back
    at exit). ``records`` holds every span in the order they closed;
    ``setup`` those that closed before :meth:`feed`, ``traced`` those that
    closed while the fed tracer recorded, ``untraced`` the others after
    :meth:`feed`."""

    active = True

    def __init__(self):
        self.records: list[dict] = []
        self.setup: list[dict] = []
        self.traced: list[dict] = []
        self.untraced: list[dict] = []
        self._tracer = None
        self._previous = None

    def __enter__(self) -> "Collector":
        from qdml_tpu_torch.telemetry import spans

        self._previous = spans.get_sink()
        spans.set_sink(self)
        return self

    def __exit__(self, *exc) -> None:
        from qdml_tpu_torch.telemetry import spans

        spans.set_sink(self._previous)
        self._tracer = None

    def feed(self, tracer) -> None:
        """Hand each span that closes while ``tracer`` records to it as a
        host span (``Tracer.host_span``, on ``time.perf_counter``'s clock)."""
        self.setup = list(self.records)
        self._tracer = tracer

    def write_raw(self, rec: dict) -> None:
        if rec.get("kind") != "span":
            return
        for r in [*phase_records(rec), rec]:
            self.records.append(r)
            tracer = self._tracer
            if tracer is None:
                continue
            if tracer.recording:
                self.traced.append(r)
                tracer.host_span(r["name"], r["t0_ns"] / 1e9, r["t1_ns"] / 1e9)
            else:
                self.untraced.append(r)

    def emit(self, kind: str, **payload) -> dict:
        rec = {"kind": kind, **payload}
        self.write_raw(rec)
        return rec


def phase_records(rec: dict) -> list[dict]:
    """The span records of ``rec``'s ``phases`` tag: one child a phase,
    named by it, one level below ``rec``."""
    return [{"kind": "span", "name": name, "path": f"{rec['path']}/{name}", "depth": rec["depth"] + 1,
             "t0_ns": int(t0), "t1_ns": int(t1)} for name, (t0, t1) in rec.get("phases", {}).items()]


def _inside(child: dict, parent: dict) -> bool:
    return (child["path"].startswith(parent["path"] + "/")
            and parent["t0_ns"] <= child["t0_ns"] <= child["t1_ns"] <= parent["t1_ns"])


def scan_host_ms(records: list[dict], log=None) -> float | None:
    """The median over ``records``' ``scan_call`` spans of the call's
    milliseconds less its ``scan_stage_wait`` child's (the host waiting for
    the card): the host's own work in one K-step call. None without a
    ``scan_call``. ``log`` gets the number of calls read."""
    calls = [r for r in records if r["name"] == "scan_call"]
    if not calls:
        return None
    waits = [r for r in records if r["name"] == "scan_stage_wait"]
    own = [(c["t1_ns"] - c["t0_ns"] - sum(w["t1_ns"] - w["t0_ns"] for w in waits if _inside(w, c))) / 1e6
           for c in calls]
    if log is not None:
        log(f"scan_host_ms read {len(own)} scan_call spans")
    return statistics.median(own)


def trainer_build_s(records: list[dict]) -> float | None:
    """The seconds of the first ``hdce_make_trainer`` span: the HDCE
    trainer built (the module drawn on the host, moved to the card, its
    optimizer). None without one."""
    for r in records:
        if r["name"] == "hdce_make_trainer":
            return (r["t1_ns"] - r["t0_ns"]) / 1e9
    return None


def setup_line(records: list[dict]) -> str:
    """One line of set-up's spans, in the order they started, each by its
    path and seconds."""
    parts = [f"{r['path']} {(r['t1_ns'] - r['t0_ns']) / 1e9:.3f} s" for r in sorted(records, key=lambda r: r["t0_ns"])]
    return "program spans in set-up: " + (", ".join(parts) if parts else "none")
