"""The port's profiling utilities (sbwt_tpu_torch/utils/profiling.py),
mirroring tests/test_profiling.py; on the CPU the trace holds the host's
ops only."""
import io
import json
import os
import time

import torch

from sbwt_tpu_torch.utils.profiling import ProgressPrinter, ThroughputMeter, annotate, trace


def test_throughput_meter_two_views():
    m = ThroughputMeter()
    with m.measure(1000):
        time.sleep(0.01)
    assert m.n_queries == 1000
    assert m.us_per_query_device() >= 10  # 10ms / 1000
    assert m.us_per_query_total() >= m.us_per_query_device()
    assert m.queries_per_sec_device() > 0


def test_progress_printer_monotone_to_100():
    buf = io.StringIO()
    p = ProgressPrinter(37, stream=buf)
    for _ in range(37):
        p.job_done()
    out = buf.getvalue()
    assert "0%" in out and "100%" in out


def test_annotate_usable_without_device():
    with annotate("test-span"):
        pass


def test_trace_writes_dir_with_the_spans(tmp_path):
    d = str(tmp_path / "trace")
    with trace(d) as prof:
        with annotate("doubling"):
            (torch.arange(8) * 2).sum()
    assert os.path.isdir(d)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "doubling" for e in events)
    assert any(ev.key == "doubling" for ev in prof.key_averages())
