"""dispatch_ms: mean host milliseconds from an engine call to its return,
before the synchronize, over the window's batches (host_clock)."""


def read(run):
    d = run["dispatch_s"]
    return sum(d) / len(d) * 1e3 if d else None
