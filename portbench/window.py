"""The measured window: a closed loop with one client, and the reduction of
its profiler trace.

The client sends a batch, waits for its answers (a synchronize), then sends
the next, cycling through the pool, until ``seconds`` have passed. Each call
is timed by the host clock: from the call to its return (the dispatch) and
to the return of the synchronize that follows (the batch).

The answers of the timed calls are what the check judges: the last answers
of each pool batch, and those of a few calls drawn from the seed. The
caching allocator is given room for them during warm-up, so keeping them
allocates nothing inside the window.
"""
from __future__ import annotations

import bisect
import gc
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch

DISPATCH, SYNC = "portbench.dispatch", "portbench.sync"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class WindowRun:
    batches: int = 0
    window_s: float = 0.0
    batch_s: list = field(default_factory=list)
    dispatch_s: list = field(default_factory=list)
    slots: list = field(default_factory=list)      # pool slot of each call
    last: dict = field(default_factory=dict)       # slot -> its last answers
    sampled: list = field(default_factory=list)    # (call, slot, answers)
    trace: dict | None = None


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(engine, pool_args, n_sampled: int, device) -> None:
    """Run every pool batch once, then hold as many answers at once as the
    window will (one a pool batch, the sampled calls and the call in
    flight), so that the allocator's cache has a block for each."""
    held = [engine(*args) for args in pool_args]
    held += [engine(*pool_args[i % len(pool_args)]) for i in range(n_sampled + 1)]
    _sync(device)
    del held


def closed_loop(engine, pool_args, seconds: float, sample_calls: set, device,
                profile: bool = False) -> WindowRun:
    """Run the window; with ``profile``, under torch.profiler (CPU and CUDA
    activity) and reduced by ``reduce_trace``."""
    prof = None
    if profile:
        from torch.profiler import ProfilerActivity, profile as profiler

        acts = [ProfilerActivity.CPU]
        if torch.device(device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profiler(activities=acts)
        prof.__enter__()
    run = WindowRun()
    n = len(pool_args)
    gc.collect()
    gc.disable()  # as timeit does: no collector pause inside the window
    try:
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i = 0
        while True:
            slot = i % n
            if prof is not None:
                with torch.profiler.record_function(DISPATCH):
                    t0 = time.perf_counter()
                    out = engine(*pool_args[slot])
                    t1 = time.perf_counter()
                with torch.profiler.record_function(SYNC):
                    _sync(device)
                    t2 = time.perf_counter()
            else:
                t0 = time.perf_counter()
                out = engine(*pool_args[slot])
                t1 = time.perf_counter()
                _sync(device)
                t2 = time.perf_counter()
            run.dispatch_s.append(t1 - t0)
            run.batch_s.append(t2 - t0)
            run.slots.append(slot)
            if i in sample_calls:
                run.sampled.append((i, slot, out))
            run.last[slot] = out
            del out
            i += 1
            if t2 >= deadline:
                break
        run.batches = i
        run.window_s = t2 - t_start
    finally:
        gc.enable()
        if prof is not None:
            prof.__exit__(None, None, None)
    if prof is not None:
        t0 = time.perf_counter()
        run.trace = reduce_trace(prof)
        run.trace["reduce_s"] = time.perf_counter() - t0
    return run


def _merge(intervals):
    """Sorted, merged (start, end) pairs."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(prof) -> dict:
    """From the profiler's trace (its chrome export, read back): the traced
    window (the first dispatch's start to the last synchronize's end), the
    seconds in it in which a kernel, copy or set ran on the device (busy_s),
    device seconds by op name, and the idle gaps of the device, each named
    by the harness span the host was in at its middle."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    spans, dev = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        if e.get("cat") in DEVICE_CATS:
            dev.append((s, s + d, e.get("name", "?"), e["cat"]))
        elif e.get("name") in (DISPATCH, SYNC):
            spans.append((s, s + d, e["name"].split(".")[1]))
    if not spans:
        return {"window_s": 0.0, "busy_s": 0.0, "op_s": {}, "kernel_s": 0.0, "gaps": []}
    spans.sort()
    starts = [s for s, _, _ in spans]
    w0, w1 = starts[0], max(e for _, e, _ in spans)
    inside = [(max(s, w0), min(e, w1), name, cat) for s, e, name, cat in dev if e > w0 and s < w1]
    op_s: dict = {}
    for s, e, name, _ in inside:
        op_s[name] = op_s.get(name, 0.0) + (e - s) * 1e-6
    busy = _merge([(s, e) for s, e, _, _ in inside])
    gaps = []
    edges = [w0] + [x for b in busy for x in b] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            j = bisect.bisect_right(starts, mid) - 1
            label = spans[j][2] if j >= 0 and spans[j][1] >= mid else "loop"
            gaps.append((label, (b - a) * 1e-6))
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "op_s": op_s,
        "kernel_s": sum((e - s) * 1e-6 for s, e, _, cat in inside if cat == "kernel"),
        "gaps": gaps,
    }
