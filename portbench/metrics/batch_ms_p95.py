"""batch_ms_p95: the 95th percentile, over every batch of the window, of the
host milliseconds from the engine call to the return of the synchronize
after it (host_clock)."""
import statistics


def read(run):
    ms = [s * 1e3 for s in run["batch_s"]]
    if len(ms) < 2:
        return ms[0] if ms else None
    return statistics.quantiles(ms, n=100, method="inclusive")[94]
