"""The program's spans in a traced run (``port_bench/program_spans.py``), on
synthetic spans and device events: the collector keeps the records and
puts the previous sink back and keeps a record's timed phases as its
children, a gap inside ``scan_stage_wait`` is summed under that name, and
the readings take what they say."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest

from port_bench import program_spans, tracing


def _span(name: str, path: str, t0_ms: float, t1_ms: float, **tags) -> dict:
    return {"kind": "span", "name": name, "path": path, "depth": path.count("/"),
            "t0_ns": int(t0_ms * 1e6), "t1_ns": int(t1_ms * 1e6), **tags}


class _Session:
    """A finished profiler session holding ``events``."""

    def __init__(self):
        self.evts = []

    def events(self):
        return self.evts

    def __exit__(self, *exc):
        pass


def _device(name: str, start_us: float, end_us: float):
    return SimpleNamespace(name=name, device_type="DeviceType.CUDA", is_user_annotation=False,
                           time_range=SimpleNamespace(start=start_us, end=end_us))


def test_the_collector_keeps_span_records_and_restores_the_previous_sink():
    from qdml_tpu_torch.telemetry import get_sink, set_sink, span

    previous = program_spans.Collector()
    set_sink(previous)
    try:
        with program_spans.Collector() as spans:
            assert get_sink() is spans
            with span("hdce_make_trainer"):
                with span("hdce_init"):
                    pass
            spans.emit("counters", name="ignored")
        assert get_sink() is previous
    finally:
        set_sink(None)
    assert [r["name"] for r in spans.records] == ["hdce_init", "hdce_make_trainer"]
    assert spans.setup == spans.traced == spans.untraced == [] and previous.records == []
    assert program_spans.setup_line(spans.records).startswith(
        "program spans in set-up: hdce_make_trainer ")


def test_a_gap_inside_the_stage_wait_is_summed_under_its_name():
    """The spans reach the tracer only while it records, and placed by its
    marker, the idle gap in the middle of the wait is the wait's."""
    import torch

    from qdml_tpu_torch.telemetry import span

    tracer = tracing.Tracer(True, 60.0, torch.device("cpu"))
    session = _Session()
    with program_spans.Collector() as spans:
        with span("hdce_make_trainer"):
            pass
        tracer.prof, tracer.spans, tracer.t0 = session, [], time.perf_counter()
        spans.feed(tracer)
        with span("scan_call", k=16) as tags:  # timed as ScanSteps times its phases
            t0 = time.perf_counter_ns()
            time.sleep(0.02)
            t1 = time.perf_counter_ns()
            tags["phases"] = {"scan_stage_wait": (t0, t1), "scan_stage": (t1, time.perf_counter_ns())}
        tracer.stop()
        with span("scan_call", k=16):  # after the session: kept, not traced
            pass
    assert [r["name"] for r in spans.setup] == ["hdce_make_trainer"]
    assert [r["name"] for r in spans.traced] == ["scan_stage_wait", "scan_stage", "scan_call"]
    assert [r["name"] for r in spans.untraced] == ["scan_call"] and len(spans.records) == 5
    wait = spans.traced[0]
    assert [(r["path"], r["depth"]) for r in spans.traced] == [
        ("scan_call/scan_stage_wait", 1), ("scan_call/scan_stage", 1), ("scan_call", 0)]
    assert wait["t1_ns"] - wait["t0_ns"] >= 20_000_000
    call = spans.traced[2]
    assert program_spans.scan_host_ms(spans.traced) == pytest.approx(
        (call["t1_ns"] - call["t0_ns"] - wait["t1_ns"] + wait["t0_ns"]) / 1e6)
    marker_end = 500.0  # the session's microsecond at which the host read t0
    w0 = marker_end + (wait["t0_ns"] / 1e3 - tracer.t0 * 1e6)
    w1 = marker_end + (wait["t1_ns"] / 1e3 - tracer.t0 * 1e6)
    session.evts = [_device("void at::native::spin_kernel", 400.0, marker_end),
                    _device("gemm", marker_end, w0 + 1000.0), _device("gemm", w1 - 1000.0, w1 + 2000.0)]
    got = tracer.read()
    assert [h[0] for h in got["host"]] == ["scan_stage_wait", "scan_stage", "scan_call"]
    ((owner, idle),) = got["breakdown"]["idle_gaps"]
    assert owner == "scan_stage_wait" and idle == pytest.approx((w1 - w0 - 2000.0) / 1e6)


def test_scan_host_ms_is_the_median_call_less_its_wait():
    records = [
        _span("scan_stage_wait", "scan_call/scan_stage_wait", 1.0, 9.0),
        _span("scan_replay", "scan_call/scan_replay", 9.0, 9.5),
        _span("scan_call", "scan_call", 0.0, 10.0, k=16),  # 10 - 8 = 2 ms
        _span("scan_stage_wait", "scan_call/scan_stage_wait", 21.0, 28.0),
        _span("scan_call", "scan_call", 20.0, 32.0, k=16),  # 12 - 7 = 5 ms
        _span("scan_call", "scan_call", 40.0, 44.0, k=16),  # no wait: 4 ms
        _span("scan_stage_wait", "other/scan_stage_wait", 41.0, 43.0),  # not its child
    ]
    lines = []
    assert program_spans.scan_host_ms(records, log=lines.append) == pytest.approx(4.0)
    assert lines == ["scan_host_ms read 3 scan_call spans"]
    assert program_spans.scan_host_ms(records[:3]) == pytest.approx(2.0)


def test_trainer_build_s_reads_the_trainers_span():
    records = [_span("hdce_init", "hdce_make_trainer/hdce_init", 0.0, 900.0),
               _span("hdce_make_trainer", "hdce_make_trainer", 0.0, 2500.0)]
    assert program_spans.trainer_build_s(records) == pytest.approx(2.5)


@pytest.mark.parametrize("read", [program_spans.scan_host_ms, program_spans.trainer_build_s])
def test_a_reading_without_its_spans_is_none(read):
    assert read([]) is None
    assert read([_span("other", "other", 0.0, 1.0)]) is None
