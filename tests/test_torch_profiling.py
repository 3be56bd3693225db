"""The port's profiling utilities (sbwt_tpu_torch/utils/profiling.py),
mirroring tests/test_profiling.py; on the CPU the trace holds the host's
ops only."""
import io
import json
import os

import torch

from sbwt_tpu_torch.utils.profiling import ProgressPrinter, annotate, trace


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
