"""variant_s: host seconds of to_variant and a synchronize (models/sbwt.py,
models/variants.py, models/subsetrank.py); cells of a compressed variant
only."""


def read(run):
    return run["spans"].get("variant")
