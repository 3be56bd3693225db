"""build_s: host seconds of SBWT.build_on_device and a synchronize (the
device build, construct/device.py, K19), the precalc fill with it."""


def read(run):
    return run["spans"].get("build")
