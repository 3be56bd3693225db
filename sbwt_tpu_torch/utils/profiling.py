"""Profiling and observability: torch.profiler traces, named spans and
throughput counters.

The port of sbwt_tpu/utils/profiling.py (the reference's observability is
timestamped stderr logging plus timers around the query loop,
src/CLI/sbwt_search.cpp:48-63, 255-256; include/sbwt/globals.hh:83-112):

* ``trace(dir)``: a torch.profiler window over the host's ops and, where a
  card is present, its kernels; the trace opens in Perfetto or
  chrome://tracing, and the yielded profiler's ``key_averages()`` sum the
  device time by kernel.
* ``annotate(name)``: a named span (record_function, plus an NVTX range on
  a card) so engine phases show inside a trace.
* ``ThroughputMeter``: queries/s and us/query, excluding and including I/O.
* ``ProgressPrinter``: percent ticker for long host-side loops.
"""
from __future__ import annotations

import contextlib
import os
import sys
import time

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


@contextlib.contextmanager
def annotate(name: str):
    """Named span inside a trace: a record_function range, and an NVTX range
    when a card is present."""
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


class ThroughputMeter:
    """Queries/s and us/query, split into device time and end-to-end time.

    Mirrors the reference's two log lines (us/query excluding I/O,
    sbwt_search.cpp:63; us/query including I/O, sbwt_search.cpp:255-256).
    """

    def __init__(self):
        self.n_queries = 0
        self.device_s = 0.0
        self._t_start = time.perf_counter()

    @contextlib.contextmanager
    def measure(self, n_queries: int):
        """Time a device-side batch (call with the answers blocked-on)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.device_s += time.perf_counter() - t0
            self.n_queries += n_queries

    def us_per_query_device(self) -> float:
        return self.device_s * 1e6 / max(1, self.n_queries)

    def us_per_query_total(self) -> float:
        return (time.perf_counter() - self._t_start) * 1e6 / max(1, self.n_queries)

    def queries_per_sec_device(self) -> float:
        return self.n_queries / self.device_s if self.device_s else 0.0

    def log(self):
        write_log(f"us/query excluding I/O: {self.us_per_query_device()}")
        write_log(f"us/query including I/O: {self.us_per_query_total()}")
        write_log(f"queries/s (device): {self.queries_per_sec_device():.0f}")


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
