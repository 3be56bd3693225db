"""portbench/spans.py on a synthetic chrome trace: nested program ranges
inside the harness's dispatch and sync ranges, their device-timeline twins,
kernels and known gaps; ``window.reduce_trace`` reads the same trace as
before (its gaps' labels ignore the program's ranges)."""
from __future__ import annotations

import json

import pytest

from portbench import spans, window


def _x(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def trace_events():
    """Two calls, times in microseconds. Call 1: dispatch 0-100 holds
    sbwt.engine 10-90, which holds desc 20-30 and launch 60-80; its kernel
    runs 85-300 (the launch's twin on the device spans it); sync 100-300.
    Call 2: dispatch 310-400, engine 315-395 (desc 320-340, launch
    350-390), kernel 392-600, sync 400-600. Gaps: 0-85 (middle 42.5, in
    sbwt.engine) and 300-392 (middle 346, in sbwt.engine after desc)."""
    return [
        _x(window.DISPATCH, 0, 100), _x("sbwt.engine", 10, 80), _x("sbwt.engine.desc", 20, 10),
        _x("sbwt.engine.launch", 60, 20), _x("sbwt.engine.launch", 85, 215, "gpu_user_annotation"),
        _x("kernel_a", 85, 215, "kernel"), _x(window.SYNC, 100, 200),
        _x(window.DISPATCH, 310, 90), _x("sbwt.engine", 315, 80), _x("sbwt.engine.desc", 320, 20),
        _x("sbwt.engine.launch", 350, 40), _x("kernel_a", 392, 208, "kernel"),
        _x("sbwt.engine.launch", 392, 208, "gpu_user_annotation"), _x(window.SYNC, 400, 200),
        {"ph": "i", "name": "marker", "ts": 5},
    ]


def test_reduce_spans_self_seconds_and_idle_by_span():
    r = spans.reduce_spans(trace_events())
    assert r["window_s"] == pytest.approx(600e-6)
    want_self = {window.DISPATCH: (100 - 80) + (90 - 80), window.SYNC: 200 + 200,
                 "sbwt.engine": (80 - 10 - 20) + (80 - 20 - 40), "sbwt.engine.desc": 10 + 20,
                 "sbwt.engine.launch": 20 + 40}
    assert r["span_s"] == pytest.approx({n: v * 1e-6 for n, v in want_self.items()})
    assert r["idle_by_span"] == pytest.approx({"sbwt.engine": (85 + 92) * 1e-6})


def test_reduce_spans_innermost_range_and_loop():
    """Ranges that open together: the gap 0-30 is desc's, the shortest. The
    gap 100-150 has its middle between sync and the next dispatch: the
    loop's, whole."""
    events = [_x(window.DISPATCH, 0, 50), _x("sbwt.engine", 0, 50), _x("sbwt.engine.desc", 0, 40),
              _x("kernel_a", 30, 70, "kernel"), _x(window.SYNC, 50, 50),
              _x(window.DISPATCH, 140, 20), _x("kernel_b", 150, 10, "kernel"),
              _x(window.SYNC, 160, 10)]
    r = spans.reduce_spans(events)
    assert r["idle_by_span"] == pytest.approx(
        {"sbwt.engine.desc": 30e-6, "loop": 50e-6, window.SYNC: 10e-6})
    assert r["span_s"]["sbwt.engine"] == pytest.approx(10e-6)


def test_reduce_spans_without_harness_ranges():
    assert spans.reduce_spans([_x("sbwt.engine", 0, 10)]) == {
        "window_s": 0.0, "span_s": {}, "idle_by_span": {}}


def test_reduce_trace_keeps_its_keys_and_gaps():
    """The harness's reduction of the same trace: its keys, and gaps named
    by the harness's ranges only."""
    class Prof:
        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                json.dump({"traceEvents": trace_events()}, f)

    t = window.reduce_trace(Prof())
    assert set(t) == {"window_s", "busy_s", "op_s", "kernel_s", "gaps"}
    assert [name for name, _ in t["gaps"]] == ["dispatch", "dispatch"]
    assert [s for _, s in t["gaps"]] == pytest.approx([85e-6, 92e-6])
    assert t["kernel_s"] == pytest.approx(423e-6)
