"""Profiling and observability: torch.profiler traces, named spans and a
progress ticker.

The port of sbwt_tpu/utils/profiling.py (the reference's observability is
timestamped stderr logging plus timers around the query loop,
src/CLI/sbwt_search.cpp:48-63, 255-256; include/sbwt/globals.hh:83-112):

* ``trace(dir)``: a torch.profiler window over the host's ops and, where a
  card is present, its kernels; the trace opens in Perfetto or
  chrome://tracing, and the yielded profiler's ``key_averages()`` sum the
  device time by kernel.
* ``annotate(name)``: a named span (a record_function range while a
  profiler records) so engine phases show inside a trace. The engine
  opens three a streaming search: ``sbwt.engine`` around the call,
  ``sbwt.engine.desc`` around the rank descriptor's build and
  ``sbwt.engine.launch`` around a kernel's arguments and launch.
* ``ProgressPrinter``: percent ticker for long host-side loops.
"""
from __future__ import annotations

import contextlib
import os
import sys

import torch

from .logging import write_log


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed block (CPU ops, and CUDA kernels where a card is
    present) and write the trace to ``log_dir``/trace.json; yields the
    torch.profiler.profile object."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
        write_log(f"profiler trace written to {log_dir}")


_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """Named span inside a trace: a record_function range while a
    torch.profiler records, on the clock of the device's kernels and
    copies, so a device gap can be put down to the span open at the time.
    Otherwise a shared no-op context, after one check."""
    if not torch.autograd._profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(name)


class ProgressPrinter:
    """Percent ticker for host-side streaming loops (globals.hh:83-112)."""

    def __init__(self, n_jobs: int, n_steps: int = 100, stream=sys.stderr):
        self.n_jobs = max(1, n_jobs)
        self.n_steps = n_steps
        self.processed = 0
        self.next_tick = 0
        self.stream = stream

    def job_done(self, n: int = 1):
        self.processed += n
        while self.next_tick <= self.n_steps * self.processed // self.n_jobs:
            self.stream.write(f"\r{100 * self.next_tick // self.n_steps}%")
            self.stream.flush()
            self.next_tick += 1
        if self.processed >= self.n_jobs:
            self.stream.write("\r")
            self.stream.flush()
