"""Packed k-mer arrays with colexicographic word order.

The reference stores k-mers bit-packed so that a plain word comparison is a
colexicographic comparison (include/sbwt/Kmer.hh:26-31, 108-123): the
*rightmost* character sits in the most significant bits, and a shorter
string that is a prefix of a longer one (padded with implicit 'A') compares
smaller via a length tiebreak.

We use the same idea, redesigned for vectorized numpy: a k-mer of
length L <= 32 is a single uint64 where the character at distance d from the
END occupies bits [62-2d, 63-2d].  Colex comparison of (value, length)
tuples is then exactly `np.lexsort((lengths, values))` order.

All operations are vectorized over arrays of k-mers.
"""
from __future__ import annotations

import numpy as np

MAX_K = 32  # single-word packing; larger k is a planned extension

_U64 = np.uint64


def pack_kmer(codes: np.ndarray) -> np.uint64:
    """Pack one k-mer (int8 codes, all valid) into a top-aligned uint64."""
    codes = np.asarray(codes)
    L = len(codes)
    if L > MAX_K:
        raise ValueError(f"k-mer length {L} > MAX_K={MAX_K}")
    val = _U64(0)
    for d in range(L):  # d = distance from the end
        val |= _U64(int(codes[L - 1 - d])) << _U64(62 - 2 * d)
    return val


def unpack_kmer(val: np.uint64, length: int) -> np.ndarray:
    """Inverse of pack_kmer: top-aligned uint64 -> int8 codes array."""
    out = np.empty(length, dtype=np.int8)
    v = int(val)
    for d in range(length):
        out[length - 1 - d] = (v >> (62 - 2 * d)) & 3
    return out


def pack_windows(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack every length-k window of a code sequence.

    Returns (vals, valid): vals is uint64 [n-k+1] of top-aligned packed
    windows; valid is bool [n-k+1], true iff the window contains no
    invalid (-1) codes.  Windows with invalid codes have unspecified vals.

    Vectorized as k shifted passes over the sequence (O(nk) bit-ops but
    fully vectorized; n is genome length).
    """
    codes = np.asarray(codes, dtype=np.int8)
    n = len(codes)
    if k > MAX_K:
        raise ValueError(f"k={k} > MAX_K={MAX_K}")
    if n < k:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=bool)
    m = n - k + 1
    vals = np.zeros(m, dtype=np.uint64)
    u = codes.astype(np.uint64) & _U64(3)  # -1 becomes garbage; masked below
    # char at window offset j (0-based from window start) has distance
    # d = k-1-j from the end -> bit position 62-2d = 64-2k+2j
    for j in range(k):
        vals |= u[j : j + m] << (64 - 2 * k + 2 * j)
    bad = (codes < 0).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    return vals, valid


def drop_first(vals: np.ndarray, k: int) -> np.ndarray:
    """Remove the first character of length-k packed k-mers (Kmer::dropleft).

    The first char is at distance k-1 from the end -> bits [64-2k, 65-2k].
    Result is a length-(k-1) packed value.
    """
    if k == 32:
        mask = ~_U64(3)
    else:
        mask = ~(_U64(3) << _U64(64 - 2 * k))
    return vals & mask


def drop_last(vals: np.ndarray) -> np.ndarray:
    """Remove the last character (Kmer::dropright): shift everything up."""
    return vals << 2


def append_last(vals: np.ndarray, c) -> np.ndarray:
    """Append character code c at the end (Kmer::appendright)."""
    return (vals >> 2) | (np.asarray(c).astype(np.uint64) << _U64(62))


def append_last_base(vals: np.ndarray) -> np.ndarray:
    """The char-independent part of append_last (vals >> 2): hoisted by
    callers that append each of the 4 candidate chars to the same set."""
    return vals >> 2


def append_from_base(base: np.ndarray, c) -> np.ndarray:
    return base | (np.asarray(c).astype(np.uint64) << _U64(62))


def first_char(vals: np.ndarray, k: int) -> np.ndarray:
    """Code of the first character of length-k packed k-mers."""
    return ((vals >> (64 - 2 * k)) & _U64(3)).astype(np.int8)


def last_char(vals: np.ndarray) -> np.ndarray:
    """Code of the last character."""
    return ((vals >> 62) & _U64(3)).astype(np.int8)


def char_at_distance(vals: np.ndarray, d) -> np.ndarray:
    """Code of the character at distance d from the end (d=0 is last)."""
    d = np.asarray(d, dtype=np.uint64)
    return ((vals >> (_U64(62) - _U64(2) * d)) & _U64(3)).astype(np.int8)


def prefix_of_length(vals: np.ndarray, k: int, m) -> np.ndarray:
    """Packed value of the first m characters of length-k packed k-mers.

    Dropping the last (k-m) characters shifts the value up by 2*(k-m).
    m may be an array (broadcast against vals); m=0 yields 0.
    """
    m = np.asarray(m, dtype=np.int64)
    shift = (2 * (k - m)).astype(np.uint64)
    out = np.where(shift >= 64, _U64(0), vals << np.minimum(shift, _U64(63)))
    # np shift by >=64 is undefined; the where above keeps only safe lanes,
    # but the shift itself must also be clamped to a defined range.
    return out.astype(np.uint64)


def colex_argsort(vals: np.ndarray, lens: np.ndarray | None = None) -> np.ndarray:
    """Argsort in colex order: by packed value, then by length (shorter first)."""
    if lens is None:
        return np.argsort(vals, kind="stable")
    return np.lexsort((lens, vals))


def to_string(val, length: int) -> str:
    from .dna import decode

    return decode(unpack_kmer(np.uint64(val), length))
