"""Multi-word packed k-mer arrays for k > 32 (up to 255, like the
reference's MAX_KMER_LENGTH ceiling, CMakeLists.txt:71-81, Kmer.hh:21-31).

Same colex-by-word-compare idea as utils/kmers.py, widened: a k-mer is a
row of W = ceil(k/32) uint64 words, where word 0 holds the LAST (up to)
32 characters top-aligned exactly like the single-word layout and word w
holds the characters at distances [32w, 32w+31] from the end.  Colex
comparison of (row, length) is then lexicographic over
(word 0, word 1, ..., word W-1, length) — word 0 dominates because the
rightmost characters decide colex order.

All arrays are [m, W] uint64; every operation is vectorized over m.
The reference's bit-packed Kmer<max_len> (include/sbwt/Kmer.hh:26-31,
108-123) stores the same information per k-mer; here the layout is
struct-of-words so numpy passes stay contiguous.
"""
from __future__ import annotations

import numpy as np

MAX_K_WIDE = 255  # parity with the reference's MAX_KMER_LENGTH ceiling

_U64 = np.uint64
_Z = _U64(0)


def n_words(k: int) -> int:
    return -(-k // 32)


def _check_k(k: int):
    if not 1 <= k <= MAX_K_WIDE:
        raise ValueError(f"k={k} out of range 1..{MAX_K_WIDE}")


def pack_kmer(codes: np.ndarray, W: int | None = None) -> np.ndarray:
    """Pack one k-mer (int8 codes, all valid) into a [W] uint64 row."""
    codes = np.asarray(codes)
    L = len(codes)
    _check_k(L)
    W = n_words(L) if W is None else W
    out = np.zeros(W, dtype=_U64)
    for d in range(L):  # d = distance from the end
        w, r = divmod(d, 32)
        out[w] |= _U64(int(codes[L - 1 - d])) << _U64(62 - 2 * r)
    return out


def unpack_kmer(row: np.ndarray, length: int) -> np.ndarray:
    """Inverse of pack_kmer: [W] uint64 row -> int8 codes array."""
    out = np.empty(length, dtype=np.int8)
    for d in range(length):
        w, r = divmod(d, 32)
        out[length - 1 - d] = (int(row[w]) >> (62 - 2 * r)) & 3
    return out


def pack_windows(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack every length-k window of a code sequence into [m, W] rows.

    Returns (vals, valid) like kmers.pack_windows."""
    _check_k(k)
    codes = np.asarray(codes, dtype=np.int8)
    n = len(codes)
    W = n_words(k)
    if n < k:
        return np.empty((0, W), dtype=_U64), np.empty(0, dtype=bool)
    m = n - k + 1
    vals = np.zeros((m, W), dtype=_U64)
    u = codes.astype(_U64) & _U64(3)
    for j in range(k):  # window offset j -> distance d = k-1-j from the end
        d = k - 1 - j
        w, r = divmod(d, 32)
        vals[:, w] |= u[j : j + m] << _U64(62 - 2 * r)
    bad = (codes < 0).astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(bad)])
    valid = (cs[k:] - cs[:-k]) == 0
    return vals, valid


# ---------------------------------------------------------------------------
# comparison / sorting / searching
# ---------------------------------------------------------------------------


def colex_argsort(vals: np.ndarray, lens: np.ndarray | None = None) -> np.ndarray:
    """Argsort rows in colex order (value words, then length)."""
    keys = [vals[:, w] for w in range(vals.shape[1] - 1, -1, -1)]
    if lens is not None:
        keys = [lens] + keys
    return np.lexsort(keys)


def rows_equal(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.all(a == b, axis=-1)


def rows_less(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Lexicographic row comparison a < b over the word axis (= colex order
    of the packed k-mers, equal lengths assumed)."""
    W = a.shape[-1]
    res = a[..., W - 1] < b[..., W - 1]
    for w in range(W - 2, -1, -1):
        res = (a[..., w] < b[..., w]) | ((a[..., w] == b[..., w]) & res)
    return res


def searchsorted_rows(
    sorted_vals: np.ndarray, queries: np.ndarray, side: str = "left"
) -> np.ndarray:
    """np.searchsorted for [n, W] sorted rows (duplicates allowed):
    vectorized binary search, ~log2(n) comparison passes over the queries."""
    n = len(sorted_vals)
    m = len(queries)
    lo = np.zeros(m, dtype=np.int64)
    hi = np.full(m, n, dtype=np.int64)
    if n == 0:
        return lo
    steps = int(np.ceil(np.log2(n + 1))) + 1
    for _ in range(steps):
        mid = (lo + hi) >> 1
        smid = sorted_vals[np.minimum(mid, n - 1)]
        if side == "left":
            go_right = rows_less(smid, queries)  # sorted[mid] < q
        else:
            go_right = ~rows_less(queries, smid)  # sorted[mid] <= q
        take = (mid < hi) & go_right
        lo = np.where(take, mid + 1, lo)
        hi = np.where(take, hi, np.minimum(hi, mid))
    return lo


def isin_sorted(sorted_vals: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """Membership of query rows in sorted unique rows."""
    n = len(sorted_vals)
    if n == 0:
        return np.zeros(len(queries), dtype=bool)
    idx = searchsorted_rows(sorted_vals, queries)
    idx_c = np.minimum(idx, n - 1)
    return (idx < n) & rows_equal(sorted_vals[idx_c], queries)


def unique_rows_sorted(vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Colex-sort rows and dedup; returns (unique_rows, counts)."""
    if len(vals) == 0:
        return vals, np.empty(0, dtype=np.int64)
    order = colex_argsort(vals)
    v = vals[order]
    new = np.empty(len(v), dtype=bool)
    new[0] = True
    new[1:] = ~rows_equal(v[1:], v[:-1])
    starts = np.flatnonzero(new)
    counts = np.diff(np.concatenate([starts, [len(v)]]))
    return v[new], counts


# ---------------------------------------------------------------------------
# per-character edits (all [m, W] -> [m, W])
# ---------------------------------------------------------------------------


def drop_first(vals: np.ndarray, k: int) -> np.ndarray:
    """Zero the first character (distance k-1 from the end)."""
    w, r = divmod(k - 1, 32)
    out = vals.copy()
    out[..., w] &= ~(_U64(3) << _U64(62 - 2 * r))
    return out


def drop_last(vals: np.ndarray) -> np.ndarray:
    """Remove the last character: 2-bit left shift across the word row
    (word 0 is most significant)."""
    out = np.empty_like(vals)
    W = vals.shape[-1]
    for w in range(W):
        out[..., w] = vals[..., w] << _U64(2)
        if w + 1 < W:
            out[..., w] |= vals[..., w + 1] >> _U64(62)
    return out


def append_last(vals: np.ndarray, c) -> np.ndarray:
    """Append character code c at the end: 2-bit right shift, c into the
    top of word 0."""
    out = np.empty_like(vals)
    W = vals.shape[-1]
    for w in range(W - 1, -1, -1):
        out[..., w] = vals[..., w] >> _U64(2)
        if w > 0:
            out[..., w] |= vals[..., w - 1] << _U64(62)
    out[..., 0] |= np.asarray(c).astype(_U64) << _U64(62)
    return out


def append_last_base(vals: np.ndarray) -> np.ndarray:
    """append_last without the char: the shifted row, reused for all 4
    candidate chars (one shift pass instead of four)."""
    out = np.empty_like(vals)
    W = vals.shape[-1]
    for w in range(W - 1, -1, -1):
        out[..., w] = vals[..., w] >> _U64(2)
        if w > 0:
            out[..., w] |= vals[..., w - 1] << _U64(62)
    return out


def append_from_base(base: np.ndarray, c) -> np.ndarray:
    out = base.copy()
    out[..., 0] |= np.asarray(c).astype(_U64) << _U64(62)
    return out


def first_char(vals: np.ndarray, k: int) -> np.ndarray:
    w, r = divmod(k - 1, 32)
    return ((vals[..., w] >> _U64(62 - 2 * r)) & _U64(3)).astype(np.int8)


def last_char(vals: np.ndarray) -> np.ndarray:
    return ((vals[..., 0] >> _U64(62)) & _U64(3)).astype(np.int8)


def char_at_distance(vals: np.ndarray, d) -> np.ndarray:
    """Character at distance d from the end (d and the row shape broadcast
    against each other)."""
    d = np.asarray(d, dtype=np.int64)
    shape = np.broadcast_shapes(vals.shape[:-1], d.shape)
    vals = np.broadcast_to(vals, shape + vals.shape[-1:])
    d = np.broadcast_to(d, shape)
    w = d >> 5
    r = (d & 31).astype(_U64)
    word = np.take_along_axis(vals, w[..., None], axis=-1)[..., 0]
    return ((word >> (_U64(62) - _U64(2) * r)) & _U64(3)).astype(np.int8)


def prefix_of_length(vals: np.ndarray, k: int, m) -> np.ndarray:
    """Packed rows of the first m characters (drop the last k-m): a 2(k-m)
    bit left shift across the whole row.  m broadcasts over rows."""
    m_arr = np.asarray(m, dtype=np.int64)
    shape = np.broadcast_shapes(vals.shape[:-1], m_arr.shape)
    vals = np.broadcast_to(vals, shape + vals.shape[-1:])
    m_arr = np.broadcast_to(m_arr, shape)
    s = 2 * (k - m_arr)  # total left shift in bits
    ws = s >> 6  # whole-word shift
    bs = (s & 63).astype(_U64)  # intra-word shift
    W = vals.shape[-1]
    # padded source: vals words followed by W zero words, so src gathers
    # with index >= W read zeros.
    pad = np.concatenate([vals, np.zeros_like(vals)], axis=-1)
    widx = np.arange(W, dtype=np.int64)
    src_i = np.minimum(ws[..., None] + widx, 2 * W - 1)
    a = np.take_along_axis(pad, src_i, axis=-1)
    b = np.take_along_axis(pad, np.minimum(src_i + 1, 2 * W - 1), axis=-1)
    bsx = bs[..., None]
    lo_shift = (_U64(64) - bsx) & _U64(63)  # when bs==0, b-part must vanish
    out = (a << bsx) | np.where(bsx == 0, _Z, b >> lo_shift)
    return out.astype(_U64)


def to_string(row: np.ndarray, length: int) -> str:
    from .dna import decode

    return decode(unpack_kmer(np.asarray(row, dtype=_U64), length))
