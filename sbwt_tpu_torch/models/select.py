"""Subset select support over the matrix rows.

Equivalent of SubsetMatrixSelectSupport (include/sbwt/
SubsetMatrixSelectSupport.hh:27-46): per-character positions of set bits,
so select(r, c) (1-based) is a single array lookup.  Batched variant used
for vectorized k-mer extraction.
"""
from __future__ import annotations

import numpy as np


class MatrixSelectSupport:
    def __init__(self, bits: np.ndarray):
        self.positions = [np.flatnonzero(bits[c]).astype(np.int64) for c in range(4)]

    def select(self, rank_1based: int, c: int) -> int:
        return int(self.positions[c][rank_1based - 1])

    def select_batch(self, ranks_1based: np.ndarray, c: int) -> np.ndarray:
        return self.positions[c][np.asarray(ranks_1based) - 1]
