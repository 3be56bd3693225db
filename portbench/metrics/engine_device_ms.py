"""engine_device_ms: device milliseconds of every kernel in the traced
window (torch.profiler), per batch."""


def read(run):
    t = run["trace"]
    if t is None or t["kernel_s"] <= 0 or not run["batches"]:
        return None
    return t["kernel_s"] / run["batches"] * 1e3
