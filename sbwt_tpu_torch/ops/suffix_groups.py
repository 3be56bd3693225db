"""Suffix-group bit-matrix post-processing.

Vectorized equivalents of src/suffix_group_optimization.cpp: entropy
experiments that redistribute edge bits within a suffix group (queries on
a streaming-supported index are invariant to where a group's bits sit,
because every rank interval at < k characters covers whole groups), plus
recomputation of the streaming-support marks from the matrix alone.

push_bits_left's right-to-left OR cascade (suffix_group_optimization.cpp:
20-42) becomes a segment-max scatter; spread_bits_after_push_left
(44-64)'s per-column shift chain becomes a per-group rank assignment.
Both are exact functional equivalents verified against a direct loop
oracle in tests.
"""
from __future__ import annotations

import numpy as np


def _group_ids(suffix_group_marks: np.ndarray) -> np.ndarray:
    return np.cumsum(suffix_group_marks.astype(np.int64)) - 1


def push_bits_left(bits: np.ndarray, suffix_group_marks: np.ndarray) -> np.ndarray:
    """OR every suffix group's columns into its first column; clear the rest
    (suffix_group_optimization.cpp:20-42).  bits: bool [4, n]."""
    bits = np.asarray(bits, dtype=bool)
    marks = np.asarray(suffix_group_marks, dtype=bool)
    n = bits.shape[1]
    if n == 0:
        return bits.copy()
    gid = _group_ids(marks)
    n_groups = int(gid[-1]) + 1
    starts = np.flatnonzero(marks)
    out = np.zeros_like(bits)
    for c in range(4):
        acc = np.zeros(n_groups, dtype=bool)
        np.logical_or.at(acc, gid, bits[c])
        out[c, starts] = acc
    return out


def spread_bits_after_push_left(
    bits: np.ndarray, suffix_group_marks: np.ndarray
) -> np.ndarray:
    """Maximally spread each group's bits over its columns, keeping the
    topmost bit in the first column (suffix_group_optimization.cpp:44-64).

    The reference's left-to-right cascade has a closed form: in a group
    with bits only in its first column (the push_bits_left postcondition),
    the j-th smallest set row ends up in the group's j-th column (extra
    bits beyond the group size pile up in the last column).
    """
    bits = np.asarray(bits, dtype=bool)
    marks = np.asarray(suffix_group_marks, dtype=bool)
    n = bits.shape[1]
    if n == 0:
        return bits.copy()
    gid = _group_ids(marks)
    n_groups = int(gid[-1]) + 1
    starts = np.flatnonzero(marks)
    group_len = np.diff(np.append(starts, n))

    out = np.zeros_like(bits)
    # rank of each set bit within its column (bits are only in start columns)
    col_rank = np.cumsum(bits, axis=0) - 1  # for set positions: 0..3
    for c in range(4):
        set_groups = bits[c, starts]  # group has row c set in its first col
        g = np.flatnonzero(set_groups)
        r = col_rank[c, starts[g]]
        dest = starts[g] + np.minimum(r, group_len[g] - 1)
        out[c, dest] = True
    return out


def mark_suffix_groups(bits: np.ndarray, k: int) -> np.ndarray:
    """Recompute streaming-support marks from the matrix alone by k-1
    rounds of incoming-label propagation (suffix_group_optimization.cpp:
    66-121).  Marks accumulate over rounds (a column is a group start if
    its incoming path label differs from its left neighbor's at any depth
    < k)."""
    bits = np.asarray(bits, dtype=bool)
    n = bits.shape[1]
    counts = bits.sum(axis=1, dtype=np.int64)
    C = np.empty(4, dtype=np.int64)
    C[0] = 1
    C[1:] = 1 + np.cumsum(counts[:-1])

    last = np.full(n, -1, dtype=np.int8)  # -1 = '$'
    for c in range(4):
        last[C[c] : C[c] + counts[c]] = c

    sgs = np.zeros(n, dtype=bool)
    for _ in range(k - 1):
        sgs[0] = True
        sgs[1:] |= last[1:] != last[:-1]
        propagated = np.full(n, -1, dtype=np.int8)
        for c in range(4):
            src = np.flatnonzero(bits[c])
            propagated[C[c] : C[c] + len(src)] = last[src]
        last = propagated
    return sgs


def compute_column_entropy(bits: np.ndarray) -> float:
    """Empirical entropy of the distribution of 4-bit column patterns
    (suffix_group_optimization.cpp:123-137)."""
    bits = np.asarray(bits, dtype=bool)
    n = bits.shape[1]
    if n == 0:
        return 0.0
    patterns = (
        bits[0].astype(np.int64) * 8
        + bits[1] * 4
        + bits[2] * 2
        + bits[3] * 1
    )
    counts = np.bincount(patterns, minlength=16)
    P = counts[counts > 0] / n
    P = P[(P != 0) & (P != 1)]
    return float(np.sum(P * np.log2(1.0 / P)))
