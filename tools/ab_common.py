"""What the A/B timing tools share: the CUDA-event timer and the reader of
nvcc's ``-Xptxas -v`` log.

A tool under tools/ imports it as ``import ab_common`` (Python puts the
script's own directory first on the path). It imports torch only, so it
serves whichever checkout a tool times.
"""
import re

import torch

SPIN_CYCLES = 4_000_000  # about 2 ms at the H100's 1,980 MHz


def mean_ms(fn, groups: int = 6, reps: int = 5):
    """``groups`` means of ``reps`` launches of fn by CUDA events, each group
    queued behind a 2 ms spin of the card (so that the host's time to launch
    a call does not count for a kernel that takes less), and fn's last
    output."""
    out = fn()
    torch.cuda.synchronize()
    res = []
    for _ in range(groups):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        s.record()
        for _ in range(reps):
            del out
            out = fn()
        e.record()
        e.synchronize()
        res.append(s.elapsed_time(e) / reps)
    return res, out


def ptxas_entries(log: str) -> list:
    """(mangled entry point, registers, spill bytes stored and loaded) of
    every kernel in nvcc's ``-Xptxas -v`` output."""
    out, entry, spill = [], "", 0
    for line in log.splitlines():
        if m := re.search(r"Compiling entry function '([^']+)'", line):
            entry = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line):
            spill = int(m.group(1)) + int(m.group(2))
        elif m := re.search(r"Used (\d+) registers", line):
            out.append((entry, int(m.group(1)), spill))
    return out
