"""answers_per_s: every real k-mer answer completed in the window over the
window's host seconds (host_clock)."""


def read(run):
    return run["answers"] / run["window_s"] if run["window_s"] > 0 else None
