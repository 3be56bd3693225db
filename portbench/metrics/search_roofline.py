"""search_roofline: the least time the card could take for the window's
batches, their compulsory bytes (portbench/yardstick.py) over its HBM peak
(portbench/peaks.json), as a share of the kernels' device time in the
traced window."""


def read(run):
    t, peak = run["trace"], run["peaks"]
    if t is None or peak is None or t["kernel_s"] <= 0:
        return None
    return 100.0 * run["compulsory_bytes"] / peak["hbm_bytes_per_s"] / t["kernel_s"]
