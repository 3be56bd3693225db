"""Progress ticker for long host-side loops.

The ``ProgressPrinter`` of sbwt_tpu/utils/profiling.py (globals.hh:83-112
Progress_printer). The trace and span wrappers of that module are not yet
ported.
"""
from __future__ import annotations

import sys


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
