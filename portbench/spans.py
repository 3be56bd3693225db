"""The program's spans in a profiler trace (sbwt_tpu_torch/utils/profiling.py
``annotate``: ``sbwt.engine``, ``sbwt.engine.desc``, ``sbwt.engine.launch``)
beside the harness's dispatch and sync ranges.

``reduce_spans`` gives the host seconds of each range with the ranges
inside it subtracted (self seconds), and the device's idle seconds by the
innermost range open at each gap's middle, over the same traced window as
``window.reduce_trace``: the first dispatch's start to the last sync's end.
Only the host's ranges count: torch.profiler gives each range a twin on the
device's timeline (``gpu_user_annotation``) that spans the kernels it
launched, and would otherwise nest wrongly. ``tools/work_ab.py`` reads it;
``window.reduce_trace`` does not call it yet (PERF.md §7).
"""
from __future__ import annotations

from portbench import window

HOST_RANGE = "user_annotation"


def reduce_spans(events: list) -> dict:
    """{"window_s", "span_s": {range: self seconds}, "idle_by_span":
    {range or "loop": idle seconds}} of a chrome trace's events; empty
    maps when the trace has no harness range."""
    ranges, dev = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        name = e.get("name", "")
        if e.get("cat") in window.DEVICE_CATS:
            dev.append((s, s + d))
        elif e.get("cat") == HOST_RANGE and (name.startswith("sbwt.")
                                            or name in (window.DISPATCH, window.SYNC)):
            ranges.append((s, s + d, name))
    harness = [r for r in ranges if r[2] in (window.DISPATCH, window.SYNC)]
    if not harness:
        return {"window_s": 0.0, "span_s": {}, "idle_by_span": {}}
    ranges.sort(key=lambda r: (r[0], -r[1]))
    self_us, stack = {}, []
    for s, e, name in ranges:
        while stack and stack[-1][1] <= s:
            stack.pop()
        if stack:  # the enclosing range loses this one's time
            self_us[stack[-1][2]] = self_us.get(stack[-1][2], 0.0) - (e - s)
        self_us[name] = self_us.get(name, 0.0) + (e - s)
        stack.append((s, e, name))
    w0, w1 = min(r[0] for r in harness), max(r[1] for r in harness)
    busy = window._merge([(max(s, w0), min(e, w1)) for s, e in dev if e > w0 and s < w1])
    idle = {}
    edges = [w0] + [x for b in busy for x in b] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            inside = [r for r in ranges if r[0] <= mid <= r[1]]
            # the innermost: the latest to open, the shorter of two that open together
            label = max(inside, key=lambda r: (r[0], -r[1]))[2] if inside else "loop"
            idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return {"window_s": (w1 - w0) * 1e-6,
            "span_s": {n: v * 1e-6 for n, v in sorted(self_us.items())},
            "idle_by_span": dict(sorted(idle.items()))}
