"""Packed bit vectors with word-fused rank rows: host builders and the
plain PyTorch rank primitives.

A bit vector is stored as uint32 words interleaved with their exclusive
cumulative popcount, int32 rows ``(word, cum)``, so that

    rank(pos) = cum[pos >> 5] + popcount(word[pos >> 5] & ((1 << (pos & 31)) - 1))

reads one 8-byte row (the layout of sbwt_tpu/ops/bitvector.py). The wide
tier's rows are int32 ``(word, cum low half, cum high half)``, 12 bytes,
for counts past 2^31. The host helpers are numpy; the plain rank functions widen words to int64 and mask
them to 32 bits, because torch's uint32 support is partial and it has no
popcount (a SWAR popcount stands in).
"""
from __future__ import annotations

import numpy as np
import torch

WORD_BITS = 32
_LOW32 = 0xFFFFFFFF


def n_words_padded(n_bits: int) -> int:
    """Number of words including the pad word that makes rank(n) in-bounds."""
    return n_bits // WORD_BITS + 1


def pack_bits_host(bools: np.ndarray) -> np.ndarray:
    """Pack a bool array into uint32 words, LSB-first, with one pad word."""
    n = len(bools)
    W = n_words_padded(n)
    padded = np.zeros(W * WORD_BITS, dtype=bool)
    padded[:n] = bools
    b = padded.reshape(W, WORD_BITS).astype(np.uint32)
    shifts = np.arange(WORD_BITS, dtype=np.uint32)
    return (b << shifts).sum(axis=1, dtype=np.uint32)


def popcount_words_host(words: np.ndarray) -> np.ndarray:
    """SWAR popcount of uint32 words, int64 result."""
    v = words.copy()
    v = v - ((v >> np.uint32(1)) & np.uint32(0x55555555))
    v = (v & np.uint32(0x33333333)) + ((v >> np.uint32(2)) & np.uint32(0x33333333))
    v = (v + (v >> np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return ((v * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int64)


def rank_table_from_words(words: np.ndarray) -> np.ndarray:
    """Interleaved (bits, exclusive cum popcount) table, int32 [W, 2]."""
    pops = popcount_words_host(words)
    cum = np.concatenate([[0], np.cumsum(pops)[:-1]])
    if cum[-1] + pops[-1] >= 2**31:
        raise ValueError("bit vector too large for int32 rank (>=2^31 set bits)")
    tbl = np.empty((len(words), 2), dtype=np.int32)
    tbl[:, 0] = words.view(np.int32)
    tbl[:, 1] = cum.astype(np.int32)
    return tbl


def rank_table_from_words_wide(words: np.ndarray, window: int = 1 << 24) -> np.ndarray:
    """The table of a bit vector with 2^31 set bits or more: int32 [W, 3]
    rows (bits word, low 32 bits of the exclusive cum popcount, high 32).
    Built window by window with a running total, so the int64 transients
    stay at 8 bytes a word of one window, not of the whole vector."""
    W = len(words)
    tbl = np.empty((W, 3), dtype=np.int32)
    tbl[:, 0] = words.view(np.int32)
    total = 0
    for w0 in range(0, W, window):
        cum = np.cumsum(popcount_words_host(words[w0 : w0 + window]), dtype=np.int64)
        excl = total + cum
        excl[1:] = excl[:-1]
        excl[0] = total
        tbl[w0 : w0 + window, 1] = (excl & _LOW32).astype(np.uint32).view(np.int32)
        tbl[w0 : w0 + window, 2] = (excl >> 32).astype(np.int32)
        total += int(cum[-1])
    return tbl


def rank_table_host(bools: np.ndarray) -> np.ndarray:
    """The interleaved (bits, exclusive cum popcount) table of a bool array."""
    return rank_table_from_words(pack_bits_host(bools))


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int64 values in [0, 2^32)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _LOW32) >> 24


def word_u32(words: torch.Tensor) -> torch.Tensor:
    """int32 words as their unsigned 32-bit values, in int64."""
    return words.long() & _LOW32


def rank_get(tbl: torch.Tensor, pos: torch.Tensor, row0=0):
    """(rank(pos), bit at pos) of the [W, 2] rank table that starts at row
    row0 of tbl, from one row; int64."""
    pos = pos.long()
    row = tbl[row0 + (pos >> 5)]
    o = pos & 31
    word = word_u32(row[..., 0])
    r = row[..., 1].long() + popcount32(word & ((1 << o) - 1))
    return r, (word >> o) & 1


def rank_get_wide(tbl: torch.Tensor, pos: torch.Tensor, row0=0):
    """rank_get over the wide tier's [W, 3] rows. The count is
    (high << 32) | low with the low half taken as unsigned: sign-extending
    it would corrupt every count whose bit 31 is set."""
    pos = pos.long()
    row = tbl[row0 + (pos >> 5)]
    o = pos & 31
    word = word_u32(row[..., 0])
    cum = (row[..., 2].long() << 32) | word_u32(row[..., 1])
    return cum + popcount32(word & ((1 << o) - 1)), (word >> o) & 1


def rank(tbl: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Number of set bits strictly before pos, pos in [0, n]; int64."""
    return rank_get(tbl, pos)[0]
