"""table_s: host seconds of the turbo table's build and a synchronize
(ops/turbo.py build_turbo, K5/K6); cells on the turbo engine only."""


def read(run):
    return run["spans"].get("table")
