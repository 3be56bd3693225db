"""sdsl-lite on-disk codecs for the cpp `.sbwt` interchange format.

The reference serializes each index variant as a composition of sdsl-lite
structures (variants.hh:19-63; SubsetMatrixRank.hh:86-125,
SubsetSplitRank.hh:37-52, SubsetConcatRank.hh:67-80, SubsetWT.hh:122-134,
MEF.hpp:238-268).  The sdsl-lite submodule is not vendored in the
reference mount, so every layout here is reconstructed from the sdsl-lite
sources (github.com/iosfwd/sdsl-lite, a fork of simongog/sdsl-lite v2.x)
and documented in docs/SDSL_LAYOUT.md.  Each codec comes with:

* a writer producing the byte stream,
* a reader that parses the same stream back to plain content, and
* a "replica" query function that answers rank/select the way the C++
  implementation would, reading ONLY the serialized payload — the tests
  use these to prove the payloads are semantically valid, not merely
  round-trippable.

Everything here is host-side numpy; the loaded content is re-packed into
the device structures by io/serialize.py.

Byte-order/packing conventions (sdsl int_vector.hpp):
  * all integers little-endian;
  * `int_vector<w>` serializes as: u64 size-in-bits, then (for the
    default `int_vector<0>` only) a u8 width, then ceil(bits/64) raw
    64-bit data words;  bit i of the logical stream lives in word i/64
    at bit position i%64;
  * `bit_vector` == `int_vector<1>` (no width byte);
  * `write_member(x)` for an integral type writes sizeof(x) raw bytes.
"""
from __future__ import annotations

import math
import struct

import numpy as np

UNDEF = (1 << 64) - 1  # sdsl's "undefined" node/leaf marker


def _hi(x: int) -> int:
    """sdsl bits::hi — position of the highest set bit; hi(0) == 0."""
    return x.bit_length() - 1 if x > 0 else 0


# ---------------------------------------------------------------------------
# Bit packing
# ---------------------------------------------------------------------------

def bits_to_words(bools: np.ndarray) -> np.ndarray:
    """Pack bools to uint64 words, bit i of the stream at word i//64 bit i%64."""
    n = len(bools)
    n_words = (n + 63) // 64
    if n_words == 0:
        return np.zeros(0, dtype=np.uint64)
    padded = np.zeros(n_words * 64, dtype=bool)
    padded[:n] = bools
    return (
        np.packbits(padded, bitorder="little")
        .view("<u8")
        .astype(np.uint64)
    )


def words_to_bits(words: np.ndarray, n: int) -> np.ndarray:
    if n == 0:
        return np.zeros(0, dtype=bool)
    raw = np.asarray(words, dtype="<u8").tobytes()
    return np.unpackbits(np.frombuffer(raw, dtype=np.uint8), bitorder="little")[
        :n
    ].astype(bool)


class BitWriter:
    """Append-only little-endian bit stream (for variable-width payloads)."""

    def __init__(self):
        self._acc = 0  # python int bit accumulator
        self.nbits = 0

    def append(self, value: int, width: int) -> None:
        if width == 0:
            return
        assert 0 <= value < (1 << width)
        self._acc |= value << self.nbits
        self.nbits += width

    def words(self, min_bits: int = 0) -> np.ndarray:
        nbits = max(self.nbits, min_bits)
        n_words = (nbits + 63) // 64
        acc = self._acc
        out = np.empty(n_words, dtype=np.uint64)
        for i in range(n_words):
            out[i] = acc & UNDEF
            acc >>= 64
        return out


class BitReader:
    def __init__(self, words: np.ndarray):
        self._acc = 0
        for w in reversed(np.asarray(words, dtype=np.uint64)):
            self._acc = (self._acc << 64) | int(w)
        self.pos = 0

    def read(self, width: int) -> int:
        v = (self._acc >> self.pos) & ((1 << width) - 1)
        self.pos += width
        return v

    def read_at(self, pos: int, width: int) -> int:
        return (self._acc >> pos) & ((1 << width) - 1)


# ---------------------------------------------------------------------------
# int_vector / bit_vector framing (sdsl int_vector.hpp: write_header +
# serialize_vector)
# ---------------------------------------------------------------------------

def write_int_vector_words(f, words: np.ndarray, n_bits: int, width: int | None) -> int:
    """Low-level int_vector writer from pre-packed words.

    width=None means a compile-time width (bit_vector, int_vector<64>):
    no width byte is written.  width=int means the default int_vector<0>:
    a u8 width byte follows the size.
    """
    f.write(struct.pack("<Q", n_bits))
    written = 8
    if width is not None:
        f.write(struct.pack("<B", width))
        written += 1
    n_words = (n_bits + 63) // 64
    data = np.zeros(n_words, dtype="<u8")
    data[: len(words)] = words[:n_words]
    f.write(data.tobytes())
    return written + n_words * 8


def read_int_vector_words(f, fixed_width: int | None):
    """Returns (words, n_bits, width)."""
    (n_bits,) = struct.unpack("<Q", f.read(8))
    if fixed_width is None:
        (width,) = struct.unpack("<B", f.read(1))
    else:
        width = fixed_width
    n_words = (n_bits + 63) // 64
    words = np.frombuffer(f.read(n_words * 8), dtype="<u8").astype(np.uint64)
    return words, n_bits, width


def write_bit_vector(f, bools: np.ndarray) -> int:
    return write_int_vector_words(f, bits_to_words(bools), len(bools), None)


def read_bit_vector(f) -> np.ndarray:
    words, n_bits, _ = read_int_vector_words(f, 1)
    return words_to_bits(words, n_bits)


def write_bit_vector_packed(
    f, packed: np.ndarray, n_bits: int, window: int = 1 << 26
) -> int:
    """sdsl bit_vector from little-bit-order packed BYTES, streamed in
    bounded windows — no bool expansion, no word-pad copy (the chunked
    save path for pangenome-scale plain-matrix indexes).  The byte order
    of np.packbits(bitorder='little') equals sdsl's LE uint64 word bytes,
    so the payload is a straight copy plus zero padding."""
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    nb = (n_bits + 7) // 8
    assert len(packed) >= nb
    f.write(struct.pack("<Q", n_bits))
    n_words = (n_bits + 63) // 64
    for off in range(0, nb, window):
        chunk = packed[off : min(off + window, nb)]
        if off + len(chunk) >= nb and n_bits % 8:
            chunk = chunk.copy()
            chunk[-1] &= (1 << (n_bits % 8)) - 1  # sdsl pad bits are zero
        f.write(chunk.tobytes())
    f.write(bytes(n_words * 8 - nb))
    return 8 + n_words * 8


def read_bit_vector_packed(f):
    """Read an sdsl bit_vector as (packed little-order bytes, n_bits)
    without bool expansion (chunked load path)."""
    (n_bits,) = struct.unpack("<Q", f.read(8))
    n_words = (n_bits + 63) // 64
    raw = np.frombuffer(f.read(n_words * 8), dtype=np.uint8)
    return raw[: (n_bits + 7) // 8].copy(), n_bits


def write_int_vector0(f, values, width: int) -> int:
    """Default-width int_vector<0>: size, width byte, packed values."""
    values = np.asarray(values, dtype=np.uint64)
    if width and len(values):
        assert width == 64 or int(values.max()) < (1 << width)
        widths = np.full(len(values), width, dtype=np.int64)
        words, _ = _pack_varwidth_stream(values, widths, min_bits=0)
    else:
        words = np.zeros(0, dtype=np.uint64)
    return write_int_vector_words(f, words, len(values) * width, width)


def read_int_vector0(f):
    """Returns (values ndarray, width)."""
    words, n_bits, width = read_int_vector_words(f, None)
    if width == 0:
        return np.zeros(0, dtype=np.uint64), width
    count = n_bits // width
    offs = np.arange(count, dtype=np.int64) * width
    widths = np.full(count, width, dtype=np.int64)
    return _read_varwidth_stream(words, offs, widths), width


def write_int_vector64(f, words: np.ndarray) -> int:
    """int_vector<64> (e.g. rank-support basic blocks, byte_tree vectors)."""
    words = np.asarray(words, dtype=np.uint64)
    return write_int_vector_words(f, words, len(words) * 64, None)


def read_int_vector64(f) -> np.ndarray:
    words, n_bits, _ = read_int_vector_words(f, 64)
    assert n_bits % 64 == 0
    return words


# ---------------------------------------------------------------------------
# rank_support_v (0.25n bits) and rank_support_v5 (0.0625n bits)
#
# Both store one int_vector<64> of interleaved [absolute, packed-relative]
# word pairs per superblock (rank_support_v.hpp / rank_support_v5.hpp):
#   * v : superblock = 8 words (512 bits); the odd word packs seven 9-bit
#     cumulative counts of the first m in 1..7 words, at shift 63 - 9*m.
#   * v5: superblock = 32 words (2048 bits); the odd word packs five
#     11-bit cumulative counts at 384-bit sub-block boundaries
#     (m in 1..5, boundary word 6*m), at shift 63 - 11*m.
# The vector has (capacity_words // sb_words + 1) pairs, where capacity
# is the bit count rounded up to a full 64-bit word; an empty supported
# vector serializes 2 zero words.  Field (s, m) is only materialized when
# its boundary word 8s+m (resp. 32s+6m) <= capacity_words.
# ---------------------------------------------------------------------------

def _popcounts(words: np.ndarray) -> np.ndarray:
    v = words.copy()
    cnt = np.zeros(len(words), dtype=np.uint64)
    # SWAR popcount on uint64 lanes
    m1 = np.uint64(0x5555555555555555)
    m2 = np.uint64(0x3333333333333333)
    m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
    h01 = np.uint64(0x0101010101010101)
    v = v - ((v >> np.uint64(1)) & m1)
    v = (v & m2) + ((v >> np.uint64(2)) & m2)
    v = (v + (v >> np.uint64(4))) & m4
    cnt = (v * h01) >> np.uint64(56)
    return cnt.astype(np.int64)


_BYTE_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def word_popcounts_packed(
    packed: np.ndarray, n_bits: int, window_words: int = 1 << 23
) -> np.ndarray:
    """Per-64-bit-word popcounts from little-order packed bytes (no bool
    expansion; the chunked save path feeds rank payloads from this).
    Processed in bounded windows — at wide-engine scale (4.3e9 columns) a
    whole-row int64 table lookup would transiently cost 8x the row."""
    nb = (n_bits + 7) // 8
    n_words = (n_bits + 63) // 64
    out = np.empty(n_words, dtype=np.int64)
    pc8 = _BYTE_POPCOUNT.astype(np.uint8)
    for w0 in range(0, n_words, window_words):
        w1 = min(w0 + window_words, n_words)
        buf = np.zeros((w1 - w0) * 8, dtype=np.uint8)
        lob, hib = w0 * 8, min(w1 * 8, nb)
        buf[: hib - lob] = packed[lob:hib]
        if hib == nb and n_bits % 8:
            buf[nb - 1 - lob] &= (1 << (n_bits % 8)) - 1
        out[w0:w1] = pc8[buf].reshape(-1, 8).sum(axis=1, dtype=np.int64)
    return out


def _rank_family_payload_from_counts(
    wcnt_words: np.ndarray, cap_words: int, sb_words: int, stride: int, field_bits: int
) -> np.ndarray:
    nsb = cap_words // sb_words + 1
    wcnt = np.zeros(nsb * sb_words, dtype=np.int64)
    wcnt[:cap_words] = wcnt_words
    cumw = np.concatenate([[0], np.cumsum(wcnt)])
    out = np.zeros(2 * nsb, dtype=np.uint64)
    starts = np.arange(nsb) * sb_words
    out[0::2] = cumw[np.minimum(starts, cap_words)].astype(np.uint64)
    n_fields = -(-sb_words // stride) - 1
    rel = np.zeros(nsb, dtype=np.uint64)
    for m in range(1, n_fields + 1):
        boundary = starts + m * stride
        val = (cumw[np.minimum(boundary, cap_words)] - cumw[np.minimum(starts, cap_words)]).astype(np.uint64)
        val = np.where(boundary <= cap_words, val, np.uint64(0))
        rel |= val << np.uint64(63 - field_bits * m)
    out[1::2] = rel
    return out


def _rank_family_payload(bools: np.ndarray, sb_words: int, stride: int, field_bits: int) -> np.ndarray:
    n = len(bools)
    if n == 0:
        return np.zeros(2, dtype=np.uint64)
    words = bits_to_words(bools)
    return _rank_family_payload_from_counts(
        _popcounts(words), len(words), sb_words, stride, field_bits
    )


def rank_v_payload(bools: np.ndarray) -> np.ndarray:
    return _rank_family_payload(bools, sb_words=8, stride=1, field_bits=9)


def rank_v5_payload(bools: np.ndarray) -> np.ndarray:
    return _rank_family_payload(bools, sb_words=32, stride=6, field_bits=11)


def rank_v5_payload_packed(packed: np.ndarray, n_bits: int) -> np.ndarray:
    """rank_support_v5 payload from packed bytes (no bool expansion)."""
    if n_bits == 0:
        return np.zeros(2, dtype=np.uint64)
    n_words = (n_bits + 63) // 64
    return _rank_family_payload_from_counts(
        word_popcounts_packed(packed, n_bits), n_words,
        sb_words=32, stride=6, field_bits=11,
    )


def write_rank_support_v(f, bools: np.ndarray) -> int:
    return write_int_vector64(f, rank_v_payload(bools))


def write_rank_support_v5(f, bools: np.ndarray) -> int:
    return write_int_vector64(f, rank_v5_payload(bools))


def skip_int_vector64(f) -> None:
    (n_bits,) = struct.unpack("<Q", f.read(8))
    f.seek(((n_bits + 63) // 64) * 8, 1)


def _rank_family_replica(payload, bit_words, idx, sb_words, stride, field_bits):
    """rank(idx) exactly as rank_support_v{,5}::rank computes it, reading
    only the serialized payload + raw data words (test oracle)."""
    sbits = sb_words * 64
    s = idx // sbits
    base = int(payload[2 * s])
    rel = int(payload[2 * s + 1])
    m = (idx % sbits) // (stride * 64)
    part = (rel >> (63 - field_bits * m)) & ((1 << field_bits) - 1)
    scan_from = s * sb_words + m * stride
    word = idx // 64
    cnt = 0
    for w in range(scan_from, word):
        cnt += bin(int(bit_words[w]) if w < len(bit_words) else 0).count("1")
    if idx % 64 and word < len(bit_words):
        cnt += bin(int(bit_words[word]) & ((1 << (idx % 64)) - 1)).count("1")
    return base + part + cnt


def rank_v_replica(payload, bit_words, idx):
    return _rank_family_replica(payload, bit_words, idx, 8, 1, 9)


def rank_v5_replica(payload, bit_words, idx):
    return _rank_family_replica(payload, bit_words, idx, 32, 6, 11)


# ---------------------------------------------------------------------------
# select_support_mcl<b, 1>  (select_support_mcl.hpp)
#
# Stream: u64 arg count; if nonzero: m_superblock (int_vector<0>, width
# logn = hi(capacity)+1, position of every 4096th argument), then a
# mini_or_long indicator bit_vector (empty when every superblock is a
# miniblock; otherwise bit=1 means miniblock), then per superblock either
# a "long" int_vector<0> of all absolute positions (span >= logn^4) or a
# 64-entry "mini" int_vector<0> of every-64th-argument offsets relative
# to the superblock start.
# ---------------------------------------------------------------------------

def select_mcl_fields(bools: np.ndarray, b: int) -> dict:
    args = np.flatnonzero(bools == bool(b)).astype(np.int64)
    cnt = len(args)
    fields = {"arg_cnt": cnt, "b": b}
    if cnt == 0:
        return fields
    n = len(bools)
    cap = ((n + 63) // 64) * 64
    logn = _hi(cap) + 1
    logn4 = (logn * logn) ** 2
    sb = (cnt + 4095) // 4096
    fields["logn"] = logn
    fields["superblock"] = args[::4096]
    longs = []
    minis = []
    long_flags = []
    for s in range(sb):
        first = int(args[s * 4096])
        last = int(args[min((s + 1) * 4096, cnt) - 1])
        is_long = (last - first) >= logn4
        long_flags.append(is_long)
        chunk = args[s * 4096 : (s + 1) * 4096]
        if is_long:
            longs.append(chunk)
            minis.append(None)
        else:
            offs = np.zeros(64, dtype=np.int64)
            sub = chunk[::64] - first
            offs[: len(sub)] = sub
            minis.append(offs)
            longs.append(None)
    fields["long_flags"] = np.array(long_flags, dtype=bool)
    fields["longs"] = longs
    fields["minis"] = minis
    return fields


def write_select_mcl(f, bools: np.ndarray, b: int) -> int:
    fl = select_mcl_fields(bools, b)
    written = 0
    f.write(struct.pack("<Q", fl["arg_cnt"]))
    written += 8
    if fl["arg_cnt"] == 0:
        return written
    logn = fl["logn"]
    written += write_int_vector0(f, fl["superblock"], logn)
    if fl["long_flags"].any():
        written += write_bit_vector(f, ~fl["long_flags"])  # 1 == miniblock
    else:
        written += write_bit_vector(f, np.zeros(0, dtype=bool))
    for s in range(len(fl["long_flags"])):
        if fl["long_flags"][s]:
            written += write_int_vector0(f, fl["longs"][s], logn)
        else:
            offs = fl["minis"][s]
            width = max(1, _hi(int(offs.max())) + 1)
            written += write_int_vector0(f, offs, width)
    return written


def read_select_mcl(f) -> dict:
    (cnt,) = struct.unpack("<Q", f.read(8))
    fl = {"arg_cnt": cnt}
    if cnt == 0:
        return fl
    superblock, _ = read_int_vector0(f)
    fl["superblock"] = superblock.astype(np.int64)
    sb = (cnt + 4095) // 4096
    indicator = read_bit_vector(f)
    if len(indicator) == 0:
        long_flags = np.zeros(sb, dtype=bool)
    else:
        long_flags = ~indicator
    fl["long_flags"] = long_flags
    longs, minis = [], []
    for s in range(sb):
        vals, _ = read_int_vector0(f)
        if long_flags[s]:
            longs.append(vals.astype(np.int64))
            minis.append(None)
        else:
            minis.append(vals.astype(np.int64))
            longs.append(None)
    fl["longs"] = longs
    fl["minis"] = minis
    return fl


def select_mcl_replica(fl: dict, bools: np.ndarray, b: int, i: int) -> int:
    """select(i) (1-based) as select_support_mcl::select would compute it
    from the serialized fields, scanning raw bits after the anchor."""
    assert 1 <= i <= fl["arg_cnt"]
    i0 = i - 1
    s = i0 >> 12
    if fl["long_flags"][s]:
        return int(fl["longs"][s][i0 & 0xFFF])
    j = (i0 & 0xFFF) >> 6
    pos = int(fl["superblock"][s]) + int(fl["minis"][s][j])
    need = i0 - ((s << 12) + (j << 6))  # args to skip after the anchor
    while True:
        if bool(bools[pos]) == bool(b):
            if need == 0:
                return pos
            need -= 1
        pos += 1


# ---------------------------------------------------------------------------
# rrr_vector<63, int_vector<>, 32>  (rrr_vector.hpp + rrr_helper.hpp)
#
# Stream: u64 size; m_bt int_vector<0> (width 6: per-63-bit-block
# popcount, one trailing dummy block when 63 | size); m_btnr bit_vector
# (concatenated offset codes, >= 64 bits); m_btnrp int_vector<0>
# (per-32-block-superblock bit offsets into btnr); m_rank int_vector<0>
# (per-superblock rank samples; the final entry always holds the total);
# m_invert bit_vector (per-superblock: block types/offsets stored
# complemented).  Offsets use the combinatorial number system of
# rrr_helper::bin_to_nr, LSB-first; space_for_bt(x) = 0 for x in {0,63}
# else floor(log2 C(63,x)) + 1.
# ---------------------------------------------------------------------------

_RRR_BS = 63
_RRR_K = 32
_C63 = [math.comb(_RRR_BS, i) for i in range(_RRR_BS + 1)]
# Pascal rows for bin_to_nr: _CTAB[n][k]
_CTAB = [[math.comb(nn, kk) for kk in range(_RRR_BS + 1)] for nn in range(_RRR_BS + 1)]


def rrr_space_for_bt(x: int) -> int:
    c = _C63[x]
    return 0 if c == 1 else _hi(c) + 1


def rrr_bin_to_nr(bin_val: int) -> int:
    """rrr_helper::bin_to_nr — combinatorial rank of a 63-bit block."""
    if bin_val == 0 or bin_val == (1 << _RRR_BS) - 1:
        return 0
    k = bin(bin_val).count("1")
    nr = 0
    nn = _RRR_BS
    while bin_val:
        if bin_val & 1:
            nr += _CTAB[nn - 1][k]
            k -= 1
        bin_val >>= 1
        nn -= 1
    return nr


def rrr_nr_to_bin(k: int, nr: int) -> int:
    """Inverse of rrr_bin_to_nr for a block with popcount k."""
    if k == 0:
        return 0
    if k == _RRR_BS:
        return (1 << _RRR_BS) - 1
    out = 0
    nn = _RRR_BS
    for pos in range(_RRR_BS):
        if k == 0:
            break
        t = _CTAB[nn - 1][k]
        if nr >= t:
            out |= 1 << pos
            nr -= t
            k -= 1
        nn -= 1
    return out


# C(62 - p, j) for the vectorized combinatorial rank/unrank: processing a
# block LSB-first, a set bit at position p with j ones still unplaced
# contributes C(62-p, j) (rrr_helper::bin_to_nr walks exactly this).
_CTAB62 = np.zeros((_RRR_BS, _RRR_BS + 1), dtype=np.int64)
for _p in range(_RRR_BS):
    for _j in range(min(_RRR_BS - 1 - _p, _RRR_BS) + 1):
        _CTAB62[_p, _j] = math.comb(_RRR_BS - 1 - _p, _j)
_SPACE_TAB = np.array([rrr_space_for_bt(x) for x in range(_RRR_BS + 1)], dtype=np.int64)


def _blocks_from_bools(bools: np.ndarray, n_alloc: int) -> np.ndarray:
    """[n_alloc, 63] bit matrix (zero-padded) of the 63-bit blocks."""
    padded = np.zeros(n_alloc * _RRR_BS, dtype=bool)
    padded[: len(bools)] = bools
    return padded.reshape(n_alloc, _RRR_BS)


def _bin_to_nr_vec(bits: np.ndarray) -> np.ndarray:
    """Vectorized rrr_helper::bin_to_nr over [n, 63] block bit rows."""
    b = bits.astype(np.int64)
    below = np.cumsum(b, axis=1) - b  # ones strictly below each position
    k_tot = b.sum(axis=1, keepdims=True)
    j = k_tot - below  # ones still unplaced when reaching position p
    contrib = _CTAB62[np.arange(_RRR_BS)[None, :], np.clip(j, 0, _RRR_BS)]
    nr = (contrib * b).sum(axis=1)
    # all-zeros / all-ones blocks encode nr 0 (and occupy no space)
    k = k_tot[:, 0]
    nr[(k == 0) | (k == _RRR_BS)] = 0
    return nr


def _nr_to_bin_vec(k: np.ndarray, nr: np.ndarray) -> np.ndarray:
    """Vectorized inverse: [n, 63] bit rows from (popcount, offset)."""
    n = len(k)
    out = np.zeros((n, _RRR_BS), dtype=bool)
    k_rem = k.astype(np.int64).copy()
    nr = nr.astype(np.int64).copy()
    for p in range(_RRR_BS):
        t = _CTAB62[p, np.clip(k_rem, 0, _RRR_BS)]
        # t == 0 iff k_rem > 62-p, i.e. every remaining position must be
        # set; nr >= 0 == t then forces the bit, matching the scalar walk
        take = (k_rem > 0) & (nr >= t)
        out[:, p] = take
        nr -= np.where(take, t, 0)
        k_rem -= take.astype(np.int64)
    return out


def _pack_varwidth_stream(values: np.ndarray, widths: np.ndarray, min_bits: int):
    """OR-scatter variable-width values into a little-endian u64 stream."""
    offs = np.concatenate([[0], np.cumsum(widths)])
    total = int(offs[-1])
    n_words = max((max(total, min_bits) + 63) // 64, 1)
    stream = np.zeros(n_words + 1, dtype=np.uint64)  # +1: spill word
    nz = widths > 0
    v = values[nz].astype(np.uint64)
    o = offs[:-1][nz]
    w = (o // 64).astype(np.int64)
    sh = (o % 64).astype(np.uint64)
    np.bitwise_or.at(stream, w, (v << sh) & np.uint64(0xFFFFFFFFFFFFFFFF))
    hi = np.where(sh > 0, v >> (np.uint64(64) - sh), np.uint64(0))
    np.bitwise_or.at(stream, w + 1, hi)
    return stream[:n_words], total


def _read_varwidth_stream(words: np.ndarray, offs: np.ndarray, widths: np.ndarray):
    """Gather variable-width values from a little-endian u64 stream."""
    # Two spill words: a width-0 entry may sit exactly at the end of the
    # stream on a 64-bit boundary (offs == n_words*64), where both the
    # `w` and `w+1` gathers land past the real words.
    padded = np.concatenate([words.astype(np.uint64), np.zeros(2, dtype=np.uint64)])
    w = (offs // 64).astype(np.int64)
    sh = (offs % 64).astype(np.uint64)
    lo = padded[w] >> sh
    hi = np.where(sh > 0, padded[w + 1] << (np.uint64(64) - sh), np.uint64(0))
    v = lo | hi
    mask = np.where(
        widths >= 64, np.uint64(0xFFFFFFFFFFFFFFFF), (np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1)
    )
    return v & mask


def rrr_encode(bools: np.ndarray) -> dict:
    n = len(bools)
    n_alloc = (n + _RRR_BS) // _RRR_BS  # dummy trailing block when 63 | n
    blocks = _blocks_from_bools(bools, n_alloc)
    true_rank = blocks.sum(axis=1).astype(np.int64)
    bt = true_rank.copy()
    nsb = (n_alloc + _RRR_K - 1) // _RRR_K
    invert = np.zeros(nsb, dtype=bool)
    # superblock inversion: only full-range superblocks (rrr_vector ctor)
    n_full = n_alloc // _RRR_K
    if n_full:
        bt_mat = bt[: n_full * _RRR_K].reshape(n_full, _RRR_K)
        inv_full = (bt_mat > _RRR_BS // 2).sum(axis=1) > _RRR_K // 2
        invert[:n_full] = inv_full
        flip = np.repeat(inv_full, _RRR_K)
        bt[: n_full * _RRR_K] = np.where(flip, _RRR_BS - bt[: n_full * _RRR_K], bt[: n_full * _RRR_K])
        blocks[: n_full * _RRR_K] ^= flip[:, None]
    spaces = _SPACE_TAB[bt]
    nrs = _bin_to_nr_vec(blocks)
    stream, total_btnr = _pack_varwidth_stream(nrs, spaces, min_bits=64)
    offs = np.concatenate([[0], np.cumsum(spaces)])
    btnrp = offs[0:n_alloc:_RRR_K].astype(np.int64)
    cum_rank = np.concatenate([[0], np.cumsum(true_rank)])
    ranks = cum_rank[0:n_alloc:_RRR_K].astype(np.int64)
    sum_rank = int(cum_rank[-1])
    n_samples = nsb + (1 if n % (_RRR_K * _RRR_BS) > 0 else 0)
    rank_samples = np.zeros(n_samples, dtype=np.int64)
    rank_samples[:nsb] = ranks
    rank_samples[-1] = sum_rank
    return {
        "size": n,
        "bt": bt,
        "btnr_words": stream,
        "btnr_bits": max(total_btnr, 64),
        "btnrp": btnrp,
        "btnrp_width": _hi(total_btnr) + 1,
        "rank": rank_samples,
        "rank_width": _hi(sum_rank) + 1,
        "invert": invert,
    }


def write_rrr(f, bools: np.ndarray) -> int:
    enc = rrr_encode(bools)
    written = 0
    f.write(struct.pack("<Q", enc["size"]))
    written += 8
    written += write_int_vector0(f, enc["bt"], 6)
    written += write_int_vector_words(f, enc["btnr_words"], enc["btnr_bits"], None)
    written += write_int_vector0(f, enc["btnrp"], enc["btnrp_width"])
    written += write_int_vector0(f, enc["rank"], enc["rank_width"])
    written += write_bit_vector(f, enc["invert"])
    return written


def read_rrr_fields(f) -> dict:
    (n,) = struct.unpack("<Q", f.read(8))
    bt, _ = read_int_vector0(f)
    btnr_words, btnr_bits, _ = read_int_vector_words(f, 1)
    btnrp, _ = read_int_vector0(f)
    rank, _ = read_int_vector0(f)
    invert = read_bit_vector(f)
    return {
        "size": n,
        "bt": bt.astype(np.int64),
        "btnr_words": btnr_words,
        "btnr_bits": btnr_bits,
        "btnrp": btnrp.astype(np.int64),
        "rank": rank.astype(np.int64),
        "invert": invert,
    }


def rrr_decode(fields: dict) -> np.ndarray:
    n = int(fields["size"])
    bt = np.asarray(fields["bt"], dtype=np.int64)
    n_alloc = len(bt)
    spaces = _SPACE_TAB[bt]
    offs = np.concatenate([[0], np.cumsum(spaces)])[:-1]
    nrs = _read_varwidth_stream(fields["btnr_words"], offs, spaces).astype(np.int64)
    blocks = _nr_to_bin_vec(bt, nrs)
    inv = np.zeros(n_alloc, dtype=bool)
    sb = np.arange(n_alloc) // _RRR_K
    valid = sb < len(fields["invert"])
    inv[valid] = np.asarray(fields["invert"], dtype=bool)[sb[valid]]
    blocks ^= inv[:, None]
    return blocks.reshape(-1)[:n]


def read_rrr(f) -> np.ndarray:
    return rrr_decode(read_rrr_fields(f))


def rrr_rank_replica(fields: dict, idx: int) -> int:
    """rank(idx) as rank_support_rrr::rank computes it from the stream."""
    bt = fields["bt"]
    br = BitReader(fields["btnr_words"])
    block = idx // _RRR_BS
    s = block // _RRR_K
    result = int(fields["rank"][s])
    pos = int(fields["btnrp"][s])
    inv = bool(fields["invert"][s]) if s < len(fields["invert"]) else False
    for i in range(s * _RRR_K, block):
        x = int(bt[i])
        result += (_RRR_BS - x) if inv else x
        pos += rrr_space_for_bt(x)
    off = idx % _RRR_BS
    if off:
        x = int(bt[block]) if block < len(bt) else 0
        space = rrr_space_for_bt(x)
        nr = br.read_at(pos, space) if space else 0
        v = rrr_nr_to_bin(x, nr)
        if inv:
            v = (~v) & ((1 << _RRR_BS) - 1)
        result += bin(v & ((1 << off) - 1)).count("1")
    return result


# ---------------------------------------------------------------------------
# sd_vector<>  (sd_vector.hpp)
#
# Stream: u64 size, u8 wl, m_low int_vector<0> (width wl: low bits of
# each 1-position), m_high bit_vector (unary bucket encoding: the j-th
# one sits at bucket(pos_j) + j), then select_support_mcl<1> and
# select_support_mcl<0> over m_high.  wl = logn - logm with
# logx = hi(x)+1 and logm decremented when equal.  |high| = m + 2^logm.
# sd_vector<>::select_0_type (select_support_sd<0>) carries no payload.
# ---------------------------------------------------------------------------

def sd_encode(bools: np.ndarray) -> dict:
    n = len(bools)
    ones = np.flatnonzero(bools).astype(np.int64)
    m = len(ones)
    logm = _hi(m) + 1
    logn = _hi(n) + 1
    if logm == logn:
        logm -= 1
    wl = logn - logm
    low = ones & ((1 << wl) - 1)
    high = np.zeros(m + (1 << logm), dtype=bool)
    idx = (ones >> wl) + np.arange(m)
    high[idx] = True
    return {"size": n, "wl": wl, "low": low, "high": high}


def write_sd(f, bools: np.ndarray) -> int:
    enc = sd_encode(bools)
    written = 0
    f.write(struct.pack("<Q", enc["size"]))
    f.write(struct.pack("<B", enc["wl"]))
    written += 9
    written += write_int_vector0(f, enc["low"], enc["wl"])
    written += write_bit_vector(f, enc["high"])
    written += write_select_mcl(f, enc["high"], 1)
    written += write_select_mcl(f, enc["high"], 0)
    return written


def read_sd(f) -> np.ndarray:
    (n,) = struct.unpack("<Q", f.read(8))
    (wl,) = struct.unpack("<B", f.read(1))
    low, _ = read_int_vector0(f)
    high = read_bit_vector(f)
    read_select_mcl(f)
    read_select_mcl(f)
    out = np.zeros(n, dtype=bool)
    ones_high = np.flatnonzero(high)
    for j in range(len(low)):
        bucket = int(ones_high[j]) - j
        out[(bucket << wl) | int(low[j])] = True
    return out


# ---------------------------------------------------------------------------
# mod_ef_vector<> + rank_support_mod_ef  (reference include/sbwt/MEF.hpp)
#
# Stream (MEF.hpp:238-253): u64 m_m, u8 m_wl, m_upper bit_vector, m_lower
# bit_vector, then rank_support_v payloads for upper and lower (the
# default t_rank_1 = bit_vector::rank_1_type = sdsl::rank_support_v<1,1>).
# rank_support_mod_ef itself serializes one u64 m_mask = 2^wl - 1
# (MEF.hpp:424-431).
# ---------------------------------------------------------------------------

def _compress_even_bits(x: np.ndarray) -> np.ndarray:
    """pext(x, 0x5555...) — gather the even-position bits of each uint64."""
    x = x & np.uint64(0x5555555555555555)
    x = (x | (x >> np.uint64(1))) & np.uint64(0x3333333333333333)
    x = (x | (x >> np.uint64(2))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    x = (x | (x >> np.uint64(4))) & np.uint64(0x00FF00FF00FF00FF)
    x = (x | (x >> np.uint64(8))) & np.uint64(0x0000FFFF0000FFFF)
    x = (x | (x >> np.uint64(16))) & np.uint64(0x00000000FFFFFFFF)
    return x


def mef_optimize_w(bools: np.ndarray) -> int:
    """Replica of mod_ef_vector::optimize_w (MEF.hpp:284-315) including the
    shrink() quirks (MEF.hpp:341-354: only words with bit index
    < size - 64 are pair-OR'd; the tail is truncated in place), so the
    chosen width — which is serialized — matches what the reference would
    pick for the same bits.  Vectorized over words."""
    size = len(bools)
    words = bits_to_words(bools)
    best = size
    wl = 0
    while size >= 64:
        wl += 1
        # words processed: bit indices 0, 64, ... strictly below size - 64
        P = 0 if size <= 64 else (size - 65) // 64 + 1
        x = words[:P]
        y = (x | (x >> np.uint64(1))) & np.uint64(0x5555555555555555)
        v = _compress_even_bits(y)  # 32-bit results, one per processed word
        new_words = words.copy()
        n_pairs = P // 2
        if n_pairs:
            new_words[:n_pairs] = v[0 : 2 * n_pairs : 2] | (
                v[1 : 2 * n_pairs : 2] << np.uint64(32)
            )
        if P % 2:  # odd tail: low half replaced, high half keeps old bits
            w = P // 2
            new_words[w] = (words[w] & np.uint64(0xFFFFFFFF00000000)) | v[P - 1]
        size //= 2
        n_words = (size + 63) // 64
        words = new_words[:n_words].copy()
        if size % 64:
            words[-1] &= np.uint64((1 << (size % 64)) - 1)
        top = size
        bot = int(_popcounts(words).sum()) * (1 << wl)
        if top + bot < best:
            best = top + bot
        else:
            wl -= 1
            return wl
    return wl


def mef_encode(bools: np.ndarray, wl: int | None = None) -> dict:
    """Replica of the mod_ef_vector(bit_vector) constructor (MEF.hpp:85-131)."""
    m = len(bools)
    if wl is None:
        wl = mef_optimize_w(bools)
    bucket = 1 << wl
    n_full = m // bucket
    upper = np.zeros(n_full + 1, dtype=bool)
    if n_full:
        full = bools[: n_full * bucket].reshape(n_full, bucket)
        upper[:n_full] = full.any(axis=1)
    upper[n_full] = True
    count = int(upper[:n_full].sum())
    lower = np.zeros((count + 1) * bucket, dtype=bool)
    if n_full:
        kept = bools[: n_full * bucket].reshape(n_full, bucket)[upper[:n_full]]
        lower[: count * bucket] = kept.reshape(-1)
    tail = m % bucket
    if tail:
        lower[count * bucket : count * bucket + tail] = bools[n_full * bucket :]
    return {"m": m, "wl": wl, "upper": upper, "lower": lower}


def write_mef(f, bools: np.ndarray) -> int:
    enc = mef_encode(bools)
    written = 0
    f.write(struct.pack("<Q", enc["m"]))
    f.write(struct.pack("<B", enc["wl"]))
    written += 9
    written += write_bit_vector(f, enc["upper"])
    written += write_bit_vector(f, enc["lower"])
    written += write_rank_support_v(f, enc["upper"])
    written += write_rank_support_v(f, enc["lower"])
    return written


def read_mef_fields(f) -> dict:
    (m,) = struct.unpack("<Q", f.read(8))
    (wl,) = struct.unpack("<B", f.read(1))
    upper = read_bit_vector(f)
    lower = read_bit_vector(f)
    skip_int_vector64(f)
    skip_int_vector64(f)
    return {"m": m, "wl": wl, "upper": upper, "lower": lower}


def mef_decode(enc: dict) -> np.ndarray:
    m, wl = int(enc["m"]), int(enc["wl"])
    bucket = 1 << wl
    out = np.zeros(m, dtype=bool)
    n_full = m // bucket
    kept_mask = np.asarray(enc["upper"][:n_full], dtype=bool)
    count = int(kept_mask.sum())
    if n_full:
        rows = out[: n_full * bucket].reshape(n_full, bucket)
        rows[kept_mask] = enc["lower"][: count * bucket].reshape(count, bucket)
        out[: n_full * bucket] = rows.reshape(-1)
    tail = m % bucket
    if tail:
        out[n_full * bucket :] = enc["lower"][count * bucket : count * bucket + tail]
    return out


def read_mef(f) -> np.ndarray:
    return mef_decode(read_mef_fields(f))


def write_mef_rank_support(f, wl: int) -> int:
    f.write(struct.pack("<Q", (1 << wl) - 1))
    return 8


def read_mef_rank_support(f) -> int:
    (mask,) = struct.unpack("<Q", f.read(8))
    return mask


def mef_rank_replica(enc: dict, idx: int) -> int:
    """rank(idx) per rank_support_mod_ef::rank (MEF.hpp:376-389)."""
    wl = int(enc["wl"])
    upper, lower = enc["upper"], enc["lower"]
    bucket_id = idx >> wl
    nz_block_id = int(np.cumsum(upper)[bucket_id - 1]) if bucket_id > 0 else 0
    lob = (idx & ((1 << wl) - 1)) if upper[bucket_id] else 0
    lo_idx = (nz_block_id << wl) + lob
    return int(lower[:lo_idx].sum())


# ---------------------------------------------------------------------------
# wt_blcd  (wt_pc.hpp with balanced_shape + byte_tree from wt_helper.hpp)
#
# Stream: u64 m_size, u64 m_sigma, the tree bit vector m_bv (plain
# bit_vector or rrr_vector<63>), its rank support payload (rank_support_v5
# for plain; rrr ranks are pointer-only and write nothing), select
# supports (select_support_scan / rrr selects write nothing), then the
# byte_tree: m_tree int_vector<64> (4 words per node in BFS order:
# [bv_pos, bv_pos_rank, child0, child1], UNDEF children at leaves),
# m_c_to_leaf int_vector<64>(256) (UNDEF for absent chars), m_path
# int_vector<64>(256) (path length in bits 56.., branch bits LSB-first
# from the root).
#
# balanced_shape assigns, over the sigma present characters in ascending
# byte order, fixed-length codes of ceil(log2 sigma) bits (the character
# rank written MSB-first).  Each internal node's bits are the next code
# bit of every symbol routed through it; node bit-runs are concatenated
# into m_bv in BFS order.
# ---------------------------------------------------------------------------

def wt_build_tree(present: list[int]):
    """Returns (nodes, c_to_leaf, path) for the balanced code trie.

    nodes: list of dicts {children: [id|None, id|None], chars: list of
    byte values routed through the node} in BFS order; node 0 is the root.
    """
    sigma = len(present)
    codes = {}
    if sigma <= 1:
        depth = 0
    else:
        depth = (sigma - 1).bit_length()
    for r, c in enumerate(sorted(present)):
        codes[c] = [(r >> (depth - 1 - d)) & 1 for d in range(depth)]
    # trie insert, BFS numbering
    root = {"children": [None, None], "char": None}
    tree = [root]

    def insert(code, c):
        cur = 0
        for bit in code:
            if tree[cur]["children"][bit] is None:
                tree.append({"children": [None, None], "char": None})
                tree[cur]["children"][bit] = len(tree) - 1
            cur = tree[cur]["children"][bit]
        tree[cur]["char"] = c

    for c in sorted(present):
        insert(codes[c], c)
    # renumber BFS
    order = [0]
    seen = {0}
    qi = 0
    while qi < len(order):
        node = tree[order[qi]]
        qi += 1
        for b in (0, 1):
            ch = node["children"][b]
            if ch is not None and ch not in seen:
                order.append(ch)
                seen.add(ch)
    remap = {old: new for new, old in enumerate(order)}
    nodes = []
    for old in order:
        nd = tree[old]
        nodes.append(
            {
                "children": [
                    remap[c] if c is not None else None for c in nd["children"]
                ],
                "char": nd["char"],
            }
        )
    return nodes, codes


def wt_encode(codes_bytes: np.ndarray) -> dict:
    """Encode a byte string as a balanced wavelet tree's components."""
    text = np.asarray(codes_bytes, dtype=np.uint8)
    present = sorted(set(int(c) for c in text))
    sigma = len(present)
    nodes, char_codes = wt_build_tree(present)
    # route symbols; collect per-internal-node bit runs in BFS order
    seqs = {0: text}
    bv_parts = []
    bv_pos = []
    bv_pos_rank = []
    total_bits = 0
    total_ones = 0
    for nid, nd in enumerate(nodes):
        seq = seqs.get(nid, np.zeros(0, dtype=np.uint8))
        if nd["char"] is not None:  # leaf
            bv_pos.append(None)
            bv_pos_rank.append(None)
            continue
        # depth of node = code position
        # compute branch bit for each symbol in seq
        depth = _node_depth(nodes, nid)
        bits = np.zeros(len(seq), dtype=bool)
        for c in set(int(x) for x in seq):
            bits[seq == c] = bool(char_codes[c][depth])
        bv_parts.append(bits)
        bv_pos.append(total_bits)
        bv_pos_rank.append(total_ones)
        total_bits += len(bits)
        total_ones += int(bits.sum())
        for b in (0, 1):
            ch = nd["children"][b]
            if ch is not None:
                seqs[ch] = seq[bits == bool(b)]
    bv = np.concatenate(bv_parts) if bv_parts else np.zeros(0, dtype=bool)
    m_tree = np.full(4 * len(nodes), UNDEF, dtype=np.uint64)
    for nid, nd in enumerate(nodes):
        if nd["char"] is None:
            m_tree[4 * nid] = bv_pos[nid]
            m_tree[4 * nid + 1] = bv_pos_rank[nid]
        else:
            m_tree[4 * nid] = total_bits
            m_tree[4 * nid + 1] = total_ones
        for b in (0, 1):
            ch = nd["children"][b]
            if ch is not None:
                m_tree[4 * nid + 2 + b] = ch
    c_to_leaf = np.full(256, UNDEF, dtype=np.uint64)
    for nid, nd in enumerate(nodes):
        if nd["char"] is not None:
            c_to_leaf[nd["char"]] = nid
    m_path = np.zeros(256, dtype=np.uint64)
    for c, code in char_codes.items():
        path = 0
        for d, bit in enumerate(code):
            path |= bit << d  # LSB-first consumption from the root
        m_path[c] = (np.uint64(len(code)) << np.uint64(56)) | np.uint64(path)
    return {
        "size": len(text),
        "sigma": sigma,
        "bv": bv,
        "tree": m_tree,
        "c_to_leaf": c_to_leaf,
        "path": m_path,
    }


def _node_depth(nodes, nid):
    # BFS ids: recompute depth by walking from root each call (trees are <= 16 nodes)
    from collections import deque

    dq = deque([(0, 0)])
    while dq:
        cur, d = dq.popleft()
        if cur == nid:
            return d
        for b in (0, 1):
            ch = nodes[cur]["children"][b]
            if ch is not None:
                dq.append((ch, d + 1))
    raise AssertionError("node not reachable")


def write_wt_blcd(f, codes_bytes: np.ndarray, compressed: bool) -> int:
    enc = wt_encode(codes_bytes)
    written = 0
    f.write(struct.pack("<Q", enc["size"]))
    f.write(struct.pack("<Q", enc["sigma"]))
    written += 16
    if compressed:
        written += write_rrr(f, enc["bv"])
        # rrr rank/select supports serialize nothing
    else:
        written += write_bit_vector(f, enc["bv"])
        written += write_rank_support_v5(f, enc["bv"])
        # select_support_scan serializes nothing
    written += write_int_vector64(f, enc["tree"])
    written += write_int_vector64(f, enc["c_to_leaf"])
    written += write_int_vector64(f, enc["path"])
    return written


def read_wt_fields(f, compressed: bool) -> dict:
    (size,) = struct.unpack("<Q", f.read(8))
    (sigma,) = struct.unpack("<Q", f.read(8))
    if compressed:
        bv = read_rrr(f)
    else:
        bv = read_bit_vector(f)
        skip_int_vector64(f)  # rank_support_v5 payload; recomputed
    tree = read_int_vector64(f)
    c_to_leaf = read_int_vector64(f)
    path = read_int_vector64(f)
    return {
        "size": size,
        "sigma": sigma,
        "bv": bv,
        "tree": tree,
        "c_to_leaf": c_to_leaf,
        "path": path,
    }


def wt_decode(enc: dict) -> np.ndarray:
    """Reconstruct the byte string from serialized wavelet tree fields."""
    size = int(enc["size"])
    out = np.zeros(size, dtype=np.uint8)
    if size == 0:
        return out
    tree = enc["tree"]
    n_nodes = len(tree) // 4
    leaf_char = {}
    for c in range(256):
        nid = int(enc["c_to_leaf"][c])
        if nid != UNDEF:
            leaf_char[nid] = c
    bv = enc["bv"]

    def fill(nid, idxs):
        if int(tree[4 * nid + 2]) == UNDEF and int(tree[4 * nid + 3]) == UNDEF:
            out[idxs] = leaf_char[nid]
            return
        pos = int(tree[4 * nid])
        bits = bv[pos : pos + len(idxs)]
        for b in (0, 1):
            ch = int(tree[4 * nid + 2 + b])
            if ch != UNDEF:
                fill(ch, idxs[bits == bool(b)])

    fill(0, np.arange(size))
    return out


def wt_rank_replica(enc: dict, i: int, c: int) -> int:
    """wt_pc::rank(i, c) from the serialized fields (test oracle)."""
    nid = int(enc["c_to_leaf"][c])
    if nid == UNDEF:
        return 0
    p = int(enc["path"][c])
    path_len = p >> 56
    bv = enc["bv"]
    tree = enc["tree"]
    result = i
    v = 0
    for _ in range(path_len):
        if result == 0:
            break
        pos = int(tree[4 * v])
        ones_before = int(tree[4 * v + 1])
        # rank within the node via the serialized bv_pos_rank field, the
        # way wt_pc::rank uses it (full-prefix rank minus ones before the
        # node) — so a wrong bv_pos_rank written by wt_encode fails here.
        r1 = int(bv[: pos + result].sum()) - ones_before
        result = r1 if (p & 1) else (result - r1)
        v = int(tree[4 * v + 2 + (p & 1)])
        p >>= 1
    return result
