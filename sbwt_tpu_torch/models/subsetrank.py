"""Subset-rank structures of the nine compressed variants.

The port of sbwt_tpu/models/subsetrank.py. Each structure answers
``rank(c, pos)``, the count of character c in subsets 0..pos-1
(SubsetMatrixRank.hh:30-37), and ``rank_pair(c, pos)`` =
(rank(c, pos), rank(c, pos + 1)) at about the cost of one rank, and
``contains(c, pos)``, whether subset pos holds c (host API only: no device
path asks it, in either package):

* ``MatrixRank``   — the four rows concatenated into one bit vector.
* ``SplitRank``    — X marks columns with != 1 out-edge; unary labels go
  to Y (a plain 4-symbol wavelet tree in the files, position-order rows on
  the device), the other columns' rows to plain Z.
* ``ConcatRank``   — all set members over {$, A, C, G, T} in a 5-symbol
  wavelet tree; set starts are the zeros of L, found by select0 from a
  sample of every 8th zero and a 64-bit window.
* ``SubsetWTRank`` — three 4-symbol wavelet trees (ACGT, AC, GT), held on
  the device in position order (plane rows, or level 0 and sparse vectors).

Host builders are numpy and ``payload()`` is byte-equal to the JAX one.
``rank`` and ``rank_pair`` are the plain PyTorch versions of the device
types in csrc/subset_rank.cuh (K17).

ConcatRank's select0 takes the high window word as ``z1 >> o`` for every
o; the JAX package zeroes it when o == 0, which loses the ninth zero of a
fully dense window (ROADMAP Queue 3, F1).
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import kernels
from ..ops import bitvector as bvt
from ..ops.bv import BV_CLASSES, MEFBV, as_int32
from ..ops.bitvector import popcount32
from ..ops.wavelet import WaveletTree

_LOW32 = 0xFFFFFFFF


def _pack_width_u32(vals: np.ndarray, width: int) -> np.ndarray:
    """Pack width-bit values into a little-endian uint32 word stream."""
    bits = ((vals[:, None] >> np.arange(width, dtype=np.int64)) & 1).astype(np.uint8).ravel()
    bits = np.concatenate([bits, np.zeros((-len(bits)) % 32, dtype=np.uint8)])
    return np.packbits(bits, bitorder="little").view(np.uint32).copy()


def _unpack_width_u32(words: np.ndarray, width: int, count: int) -> np.ndarray:
    bits = np.unpackbits(np.ascontiguousarray(words, dtype=np.uint32).view(np.uint8),
                         bitorder="little")[: count * width].reshape(count, width)
    return (bits.astype(np.int64) << np.arange(width, dtype=np.int64)).sum(axis=1)


def _row_bases(bits: np.ndarray) -> np.ndarray:
    """int32 [5]: the rank at the start of each char's block of the rows."""
    base = np.zeros(5, dtype=np.int32)
    base[1:] = np.cumsum(bits.sum(axis=1, dtype=np.int64))
    return base


def _concat_rows_build(bits: np.ndarray, kind: str, device):
    """One bit vector over the char-major concatenated rows, and the bases."""
    return BV_CLASSES[kind].build(np.concatenate([bits[c] for c in range(4)]), device), \
        _row_bases(bits)


def _sub(p: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in p.items() if k.startswith(prefix)}


def _device_of(module: nn.Module) -> torch.device:
    return next(module.buffers()).device


# ---------------------------------------------------------------------------
# Matrix
# ---------------------------------------------------------------------------


def _contains(struct, c, pos):
    """int64 0/1: whether subset pos holds char c, as rank(c, pos + 1) -
    rank(c, pos) from one rank_pair."""
    r1, r2 = struct.rank_pair(c, pos)
    return (r2 - r1).long()


class MatrixRank(nn.Module):
    """bv over [A | C | G | T] rows (length 4n); base int32 [5]."""

    def __init__(self, bv, base: np.ndarray, n: int, kind: str):
        super().__init__()
        self.bv = bv
        self._base = np.asarray(base, dtype=np.int32)
        self.register_buffer("base", torch.as_tensor(self._base.astype(np.int64),
                                                     device=_device_of(bv)))
        self.n, self.kind = int(n), kind

    @classmethod
    def from_bits(cls, bits: np.ndarray, kind: str, device="cpu") -> "MatrixRank":
        bv, base = _concat_rows_build(bits, kind, device)
        return cls(bv, base, bits.shape[1], kind)

    def rank(self, c, pos):
        c = torch.as_tensor(c, device=self.base.device).long()
        return self.bv.rank(c * self.n + torch.as_tensor(pos, device=c.device).long()) - self.base[c]

    def rank_pair(self, c, pos):
        c = torch.as_tensor(c, device=self.base.device).long()
        r1, r2 = self.bv.rank_pair(c * self.n + torch.as_tensor(pos, device=c.device).long())
        return r1 - self.base[c], r2 - self.base[c]

    def contains(self, c, pos):
        """int64 0/1: whether subset pos holds char c (the bit itself)."""
        c = torch.as_tensor(c, device=self.base.device).long()
        return self.bv.get(c * self.n + torch.as_tensor(pos, device=c.device).long()).long()

    def to_bits(self) -> np.ndarray:
        return self.bv.to_bools().reshape(4, self.n)

    def payload(self) -> dict:
        out = {"n": np.int64(self.n), "base": self._base.copy()}
        out.update({f"bv_{k}": v for k, v in self.bv.payload().items()})
        return out

    @classmethod
    def from_payload(cls, p: dict, kind: str, device="cpu") -> "MatrixRank":
        bv = BV_CLASSES[kind].from_payload(_sub(p, "bv_"), device)
        n = int(p["n"])
        # payloads from before the base array was stored pay one decode
        base = p["base"] if "base" in p else _row_bases(bv.to_bools().reshape(4, n))
        return cls(bv, base, n, kind)

    def size_in_bytes(self) -> int:
        return self.bv.size_in_bytes()

    def desc(self, dev):
        return kernels.MATRIX_DESCS[self.kind](self.bv.desc(dev), self.n, kernels.c_ints(self._base))


# ---------------------------------------------------------------------------
# Split
# ---------------------------------------------------------------------------


def _y_rows(sym: np.ndarray) -> np.ndarray:
    """int32 [n // 64 + 1, 8]: per 64 positions of a sigma-4 string, one
    32-byte row (hi bits 0-31, hi bits 32-63, lo bits 0-31, lo bits 32-63,
    H, L, B, 0): the symbols' hi bit (symbol >= 2) and lo bit (symbol & 1)
    in position order, and the counts before the row of hi, of lo and of
    symbol 3. The last row holds position n (a zero row where 64 divides n)."""
    n = len(sym)
    R = n // 64 + 1
    hi, lo = np.zeros(R * 64, dtype=bool), np.zeros(R * 64, dtype=bool)
    hi[:n], lo[:n] = sym >= 2, (sym & 1) == 1
    rows = np.zeros((R, 8), dtype=np.int32)
    for j, plane in enumerate((hi, lo, hi & lo)):
        per_row = plane.reshape(R, 64)
        if j < 2:
            rows[:, 2 * j : 2 * j + 2] = np.packbits(per_row, axis=1, bitorder="little").view(np.int32)
        rows[1:, 4 + j] = np.cumsum(per_row.sum(axis=1, dtype=np.int64))[:-1]
    return rows


def _y_symbols(rows: torch.Tensor, n: int) -> np.ndarray:
    """The n symbols that Y's rows hold."""
    words = np.ascontiguousarray(rows[:, :4].cpu().numpy()).view(np.uint8).reshape(len(rows), 2, 8)
    hi, lo = (np.unpackbits(words[:, i], axis=1, bitorder="little").ravel()[:n] for i in (0, 1))
    return 2 * hi.astype(np.int64) + lo


def _y_rank_get(rows: torch.Tensor, c, p):
    """(count of c among Y's symbols before p, whether the symbol at p is c)
    from p's row, as SplitRank<X>::y_rank_get reads it; int64."""
    row = rows[p >> 6].long()
    o = p & 63
    h, l, b = row[..., 4], row[..., 5], row[..., 6]
    base = torch.where(c == 3, b, torch.where(c == 2, h - b, torch.where(
        c == 1, l - b, ((p >> 6) << 6) - h - l + b)))
    flip_h = torch.where((c & 2) != 0, 0, _LOW32)
    flip_l = torch.where((c & 1) != 0, 0, _LOW32)
    count, bit = base, torch.zeros_like(base)
    for half in (0, 1):  # bits 0-31, then 32-63
        m = ((row[..., half] & _LOW32) ^ flip_h) & ((row[..., 2 + half] & _LOW32) ^ flip_l)
        o_half = (o - 32 * half).clamp(0, 32)
        count = count + popcount32(m & ((1 << o_half) - 1))
        bit = torch.where(o // 32 == half, (m >> (o & 31)) & 1, bit)
    return count, bit


class SplitRank(nn.Module):
    """X over n (1 = column with != 1 out-edge); Y the unary columns'
    labels; Z plain over the 4 * n_b rows of the others.

    Held in the device form of csrc/subset_rank.cuh: Y's symbols as
    position-order rows (``_y_rows``, 32 bytes a 64 positions), so that a
    char's count in Y is one row, read in the round after X's rank beside
    Z's row. The file form (``payload``, ``to_bits``, ``size_in_bytes``)
    holds Y as the plain sigma-4 wavelet tree of the JAX package, rebuilt
    on the host from the rows; ``device_bytes`` counts the device form."""

    def __init__(self, X, y_syms: np.ndarray, Z, z_base: np.ndarray, n: int, n_b: int,
                 x_kind: str, z_kind: str = "plain"):
        super().__init__()
        if z_kind != "plain":
            raise ValueError("split structures keep Z plain")
        self.X, self.Z = X, Z
        dev = _device_of(X)
        self.n_y = len(y_syms)
        # a fresh allocation: 32-byte aligned (a numpy buffer may not be)
        self.register_buffer("Y", torch.tensor(_y_rows(np.asarray(y_syms, dtype=np.int64)),
                                               device=dev))
        self._z_base = np.asarray(z_base, dtype=np.int32)
        self.register_buffer("z_base", torch.as_tensor(self._z_base.astype(np.int64), device=dev))
        self.n, self.n_b, self.x_kind, self.z_kind = int(n), int(n_b), x_kind, z_kind

    @classmethod
    def from_bits(cls, bits: np.ndarray, x_kind: str, z_kind: str = "plain",
                  device="cpu") -> "SplitRank":
        unary = bits.sum(axis=0) == 1
        x_bools = ~unary
        y_syms = (np.argmax(bits[:, unary], axis=0) if unary.any()
                  else np.empty(0, dtype=np.int64))
        Z, z_base = _concat_rows_build(bits[:, x_bools], z_kind, device)
        return cls(BV_CLASSES[x_kind].build(x_bools, device), y_syms, Z, z_base,
                   bits.shape[1], int(x_bools.sum()), x_kind, z_kind)

    def rank(self, c, pos):
        c = torch.as_tensor(c, device=self.z_base.device).long()
        pos = torch.as_tensor(pos, device=c.device).long()
        xr = self.X.rank(pos)
        return (_y_rank_get(self.Y, c, pos - xr)[0] + self.Z.rank(c * self.n_b + xr)
                - self.z_base[c])

    def rank_pair(self, c, pos):
        """X's bit at pos routes the +1 into exactly one of Y (unary) or Z
        (branching), so Y's row and Z's row serve both positions."""
        c = torch.as_tensor(c, device=self.z_base.device).long()
        pos = torch.as_tensor(pos, device=c.device).long()
        xr1, xr2 = self.X.rank_pair(pos)
        y, ybit = _y_rank_get(self.Y, c, pos - xr1)
        z1, z2 = self.Z.rank_pair(c * self.n_b + xr1)
        zb = self.z_base[c]
        return y + z1 - zb, torch.where(xr2 > xr1, y + z2, y + ybit + z1) - zb

    contains = _contains

    def y_symbols(self) -> np.ndarray:
        """Y's symbols, decoded on the host from the rows."""
        return _y_symbols(self.Y, self.n_y)

    def to_bits(self) -> np.ndarray:
        x_bools = self.X.to_bools()
        bits = np.zeros((4, self.n), dtype=bool)
        bits[self.y_symbols(), np.flatnonzero(~x_bools)] = True
        bits[:, np.flatnonzero(x_bools)] = self.Z.to_bools().reshape(4, self.n_b)
        return bits

    def payload(self) -> dict:
        out = {"n": np.int64(self.n), "n_b": np.int64(self.n_b), "z_base": self._z_base.copy()}
        Y = WaveletTree.build(self.y_symbols(), 4, "plain", "cpu")
        for name, part in (("X", self.X), ("Y", Y), ("Z", self.Z)):
            out.update({f"{name}_{k}": v for k, v in part.payload().items()})
        return out

    @classmethod
    def from_payload(cls, p: dict, x_kind: str, z_kind: str = "plain",
                     device="cpu") -> "SplitRank":
        X = BV_CLASSES[x_kind].from_payload(_sub(p, "X_"), device)
        y_syms = WaveletTree.from_payload(_sub(p, "Y_"), "plain", "cpu").to_symbols()
        Z = BV_CLASSES[z_kind].from_payload(_sub(p, "Z_"), device)
        n_b = int(p["n_b"])
        z_base = p["z_base"] if "z_base" in p else _row_bases(Z.to_bools().reshape(4, n_b))
        return cls(X, y_syms, Z, z_base, int(p["n"]), n_b, x_kind, z_kind)

    def size_in_bytes(self) -> int:
        """X, Z and Y's plain wavelet tree (two levels of n_y bits), as the
        JAX package reports them."""
        y_levels = 2 * bvt.n_words_padded(self.n_y) * 8
        return self.X.size_in_bytes() + y_levels + self.Z.size_in_bytes()

    def device_bytes(self) -> int:
        """The bytes of the device form: Y's rows in place of its tree."""
        return self.X.size_in_bytes() + self.Y.numel() * 4 + self.Z.size_in_bytes()

    def desc(self, dev):
        return kernels.SPLIT_DESCS[self.x_kind](self.X.desc(dev),
                                                kernels.ptr(self.Y, "split.Y", dev, 32),
                                                self.Z.desc(dev), self.n_b,
                                                kernels.c_ints(self._z_base))


# ---------------------------------------------------------------------------
# Concat
# ---------------------------------------------------------------------------


def _nth_set_bit(word, target):
    """0-based index of the target-th (1-based) set bit of 32-bit words, by
    a binary search on prefix popcounts; int64 lanes."""
    base = torch.zeros_like(word)
    for shift in (16, 8, 4, 2, 1):
        low = word & ((1 << shift) - 1)
        cnt = popcount32(low)
        go_hi = cnt < target
        word = torch.where(go_hi, word >> shift, low)
        target = torch.where(go_hi, target - cnt, target)
        base = base + torch.where(go_hi, shift, 0)
    return base


class ConcatRank(nn.Module):
    """wt over symbols 0 = '$', 1..4 = A, C, G, T; l_words int32 [W, 2]
    (word w, word w + 1) of L; samples int32: every 8th zero of L."""

    def __init__(self, wt: WaveletTree, l_words: np.ndarray, samples: np.ndarray, n: int,
                 wt_kind: str):
        super().__init__()
        self.wt = wt
        dev = _device_of(wt)
        self.register_buffer("l_words", as_int32(l_words, dev))
        self.register_buffer("samples", as_int32(samples, dev))
        self.n, self.wt_kind = int(n), wt_kind

    @classmethod
    def from_bits(cls, bits: np.ndarray, wt_kind: str, device="cpu") -> "ConcatRank":
        n = bits.shape[1]
        sizes_eff = np.maximum(bits.sum(axis=0), 1)  # an empty set emits '$'
        total = int(sizes_eff.sum())
        starts = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(sizes_eff, out=starts[1:])
        syms = np.zeros(total, dtype=np.int64)
        offs = starts[:-1].copy()
        for c in range(4):
            idx = np.flatnonzero(bits[c])
            syms[offs[idx]] = c + 1
            offs[idx] += 1
        # L: 0 at each set start, 1 elsewhere, then an end sentinel 0
        L = np.ones(total + 1, dtype=bool)
        L[starts[:-1]] = False
        L[total] = False
        l_words, samples = cls._scan_structs(L, total)
        return cls(WaveletTree.build(syms, 5, wt_kind, device), l_words, samples, n, wt_kind)

    def _window(self, i):
        """(sample s, rem, the 64 zero-mask bits of L from s as lo, hi)."""
        s = self.samples[i >> 3].long()
        row = self.l_words[s >> 5].long()
        o = s & 31
        z0, z1 = ~row[..., 0] & _LOW32, ~row[..., 1] & _LOW32
        lo = (z0 >> o) | torch.where(o > 0, (z1 << (32 - o)) & _LOW32, 0)
        return s, i & 7, lo, z1 >> o

    def _select(self, s, lo, hi, target):
        cnt_lo = popcount32(lo)
        use_hi = cnt_lo < target
        word = torch.where(use_hi, hi, lo)
        t = torch.where(use_hi, target - cnt_lo, target)
        return s + torch.where(use_hi, 32, 0) + _nth_set_bit(word, t)

    def select0(self, i):
        """Position of the zero of L with 0-based index i."""
        i = torch.as_tensor(i, device=self.samples.device).long()
        s, rem, lo, hi = self._window(i)
        return self._select(s, lo, hi, rem + 1)

    def select0_pair(self, i):
        """Positions of zeros i and i + 1 from one window: sets hold <= 4
        symbols, so zeros rem .. rem + 1 of the sample lie within 33 bits."""
        i = torch.as_tensor(i, device=self.samples.device).long()
        s, rem, lo, hi = self._window(i)
        return self._select(s, lo, hi, rem + 1), self._select(s, lo, hi, rem + 2)

    def rank(self, c, pos):
        c = torch.as_tensor(c, device=self.samples.device).long()
        return self.wt.rank(c + 1, self.select0(pos))

    def rank_pair(self, c, pos):
        c = torch.as_tensor(c, device=self.samples.device).long()
        s1, s2 = self.select0_pair(pos)
        return self.wt.rank(c + 1, s1), self.wt.rank(c + 1, s2)

    contains = _contains

    def to_bits(self) -> np.ndarray:
        syms = self.wt.to_symbols()
        words = np.ascontiguousarray(self.l_words[:, 0].cpu().numpy()).view(np.uint32)
        L = np.unpackbits(words.view(np.uint8), bitorder="little")[: len(syms) + 1].astype(bool)
        col = np.zeros(len(syms), dtype=np.int64)
        col[np.flatnonzero(~L)[:-1]] = 1  # set starts, without the end sentinel
        col = np.cumsum(col) - 1
        bits = np.zeros((4, self.n), dtype=bool)
        nz = syms > 0
        bits[syms[nz] - 1, col[nz]] = True
        return bits

    def payload(self) -> dict:
        out = {"n": np.int64(self.n)}
        if self.wt_kind == "rrr":
            # mef-concat stores L as Elias-Fano over its zeros (the
            # sd_vector of variants.hh:43-49); the scan structures are
            # rebuilt on load
            words = np.ascontiguousarray(self.l_words[:, 0].cpu().numpy()).view(np.uint32)
            total = self.wt.n
            L = np.unpackbits(words.view(np.uint8), bitorder="little")[: total + 1].astype(bool)
            zeros = np.flatnonzero(~L).astype(np.int64)
            m = len(zeros)
            wl = max(0, int(np.floor(np.log2(max(1, (total + 1) // m))))) if m else 0
            upper_len = m + ((total + 1) >> wl) + 1
            upper = np.zeros(upper_len, dtype=bool)
            upper[(zeros >> wl) + np.arange(m)] = True
            out["L_ef_upper"] = np.packbits(upper, bitorder="little")
            out["L_ef_low"] = (np.zeros(0, dtype=np.uint32) if wl == 0
                               else _pack_width_u32(zeros & ((1 << wl) - 1), wl))
            out["L_ef_meta"] = np.array([wl, m, total, upper_len], dtype=np.int64)
        else:
            out["l_words"] = self.l_words[:, 0].cpu().numpy()  # column 1 is derived
            out["samples"] = self.samples.cpu().numpy()
        out.update({f"wt_{k}": v for k, v in self.wt.payload().items()})
        return out

    @classmethod
    def from_payload(cls, p: dict, wt_kind: str, device="cpu") -> "ConcatRank":
        wt = WaveletTree.from_payload(_sub(p, "wt_"), wt_kind, device)
        if "L_ef_meta" in p:
            wl, m, total, upper_len = (int(x) for x in np.asarray(p["L_ef_meta"]))
            upper = np.unpackbits(np.asarray(p["L_ef_upper"], dtype=np.uint8),
                                  bitorder="little")[:upper_len].astype(bool)
            low = (np.zeros(m, dtype=np.int64) if wl == 0
                   else _unpack_width_u32(np.asarray(p["L_ef_low"]), wl, m))
            L = np.ones(total + 1, dtype=bool)
            L[((np.flatnonzero(upper) - np.arange(m)) << wl) | low] = False
            l_words, samples = cls._scan_structs(L, total)
        else:
            w0 = np.asarray(p["l_words"], dtype=np.int32)
            l_words = np.zeros((len(w0), 2), dtype=np.int32)
            l_words[:, 0] = w0
            l_words[:-1, 1] = w0[1:]
            samples = np.asarray(p["samples"], dtype=np.int32)
        return cls(wt, l_words, samples, int(p["n"]), wt_kind)

    @staticmethod
    def _scan_structs(L: np.ndarray, total: int):
        """The window rows and select0 samples of L."""
        W = total // 32 + 2
        padded = np.zeros(W * 32, dtype=bool)
        padded[: total + 1] = L
        words = np.packbits(padded.reshape(W, 32), axis=1, bitorder="little").view(np.uint32).ravel()
        l_words = np.zeros((W, 2), dtype=np.int32)
        l_words[:, 0] = words.view(np.int32)
        l_words[:-1, 1] = words[1:].view(np.int32)
        return l_words, np.flatnonzero(~L)[::8].astype(np.int32)

    def size_in_bytes(self) -> int:
        return self.wt.size_in_bytes() + (self.l_words.shape[0] + self.samples.numel()) * 4

    def desc(self, dev):
        return kernels.CONCAT_DESCS[self.wt_kind](
            self.wt.desc(dev), kernels.ptr(self.l_words, "concat.l_words", dev, 8),
            kernels.ptr(self.samples, "concat.samples", dev))


# ---------------------------------------------------------------------------
# Subset wavelet tree
# ---------------------------------------------------------------------------


_TREES = ("acgt", "ac", "gt")


def _sswt_symbols(bits: np.ndarray):
    """The three trees' symbols: acgt over 2 * (A or C) + (G or T); ac over
    2 * A + C of the AC-present columns; gt over 2 * G + T of the
    GT-present columns."""
    A, C, G, T = (bits[i] for i in range(4))
    acp, gtp = A | C, G | T
    return (2 * acp.astype(np.int64) + gtp, 2 * A[acp].astype(np.int64) + C[acp],
            2 * G[gtp].astype(np.int64) + T[gtp])


def _plane_rows(sym: np.ndarray) -> np.ndarray:
    """int32 [n // 32 + 1, 4]: per 32 positions (hi word, hi count before
    it, lo word, lo count before it) of the symbols' hi bit (level 0) and lo
    bit, both in position order."""
    return np.concatenate([bvt.rank_table_host(sym >= 2), bvt.rank_table_host((sym & 1) == 1)],
                          axis=1)


def _plane_counts(rows, pos):
    """(hi count, hi bit, lo count, lo bit) at pos from pos's row; int64."""
    rh, bh = bvt.rank_get(rows[:, 0:2], pos)
    rl, bl = bvt.rank_get(rows[:, 2:4], pos)
    return rh, bh, rl, bl


def _plane_bools(rows: torch.Tensor, n: int):
    """A tree's hi and lo bits as bool arrays of its n positions."""
    words = np.ascontiguousarray(rows[:, [0, 2]].cpu().numpy()).view(np.uint32)
    bits = [np.unpackbits(np.ascontiguousarray(words[:, i]).view(np.uint8),
                          bitorder="little")[:n].astype(bool) for i in range(2)]
    return bits[0], bits[1]


def _on(bv, device):
    """A bit vector built on the host, on device."""
    return type(bv).from_payload(bv.payload(), device)


def _wt4_pair_rank(l1, nodes, pos, r0):
    """(count of symbol 1, count of symbol 3) before pos of a sigma-4 tree
    from its level 1, given level 0's rank r0; nodes = (base, ones before)
    of the left node, then of the right."""
    base_l, rank_l, base_r, rank_r = (int(v) for v in nodes)
    return l1.rank(base_l + (pos - r0)) - rank_l, l1.rank(base_r + r0) - rank_r


def _wt4_pair_rank_pair(l1, nodes, p, padv, r, radv):
    """_wt4_pair_rank at p and at p + padv (padv in {0, 1}), given level
    0's ranks r and r + radv: (c1, c3, c1 at p + padv, c3 at p + padv)."""
    base_l, rank_l, base_r, rank_r = (int(v) for v in nodes)
    ca, cb = l1.rank_pair(base_l + (p - r))
    da, db = l1.rank_pair(base_r + r)
    return (ca - rank_l, da - rank_r,
            torch.where(padv - radv == 1, cb, ca) - rank_l, torch.where(radv == 1, db, da) - rank_r)


class SubsetWTRank(nn.Module):
    """acgt over 2 * (A or C) + (G or T); ac over 2 * A + C on the AC-present
    columns; gt over 2 * G + T on the GT-present columns (SubsetWT.hh:41-113).
    A symbol's hi bit marks {2, 3}, its lo bit {1, 3}.

    Held in the device form of csrc/subset_rank.cuh, where a char's count
    is two dependent rounds: the acgt tree's count at pos (hi for A and C,
    lo for G and T) gives x, then the ac or gt tree's count at x (hi for A
    and G, lo for C and T). Each tree gives both counts at one position:
    * plain: int32 [n_t // 32 + 1, 4] rows (hi word, hi count, lo word, lo
      count), the two levels' words and counts in position order;
    * rrr: level 0 (RRR) and, in place of level 1, sparse position-order
      vectors (MEF): e (symbol 0) and b (symbol 3) of acgt, b of ac and gt,
      with GT-present(p) = (p - r0) - e(p) + b(p) and C-present(x) = (x -
      a0) + b_ac(x), T-present likewise (ac and gt hold no symbol 0). Where
      the vectors take more bytes than the three level-1 vectors, or when
      ``sparse`` is False, level 1 is kept instead and the lo count is its
      two node ranks after r0.

    The file form (``payload``, ``to_bits``, ``size_in_bytes``) is the three
    wavelet trees as the JAX package holds them, rebuilt on the host from
    the device form; ``device_bytes`` counts the device form."""

    def __init__(self, symbols, kind: str, device="cpu", sparse: bool | None = None):
        super().__init__()
        syms = [np.asarray(s, dtype=np.int64) for s in symbols]
        self.n, self.kind, self.sizes = len(syms[0]), kind, [len(s) for s in syms]
        self.sparse = False
        if kind == "plain":
            for name, s in zip(_TREES, syms):
                self.register_buffer(name, as_int32(_plane_rows(s), device))
            self._file_bytes = self.device_bytes()  # the levels' rows, re-ordered
            return
        trees = [WaveletTree.build(s, 4, kind, "cpu") for s in syms]
        self._file_bytes = sum(t.size_in_bytes() for t in trees)
        self.l0 = nn.ModuleList([_on(t.levels[0], device) for t in trees])
        vecs = [MEFBV.build(v) for v in (syms[0] == 0, syms[0] == 3, syms[1] == 3, syms[2] == 3)]
        if sparse is None:
            sparse = (sum(v.size_in_bytes() for v in vecs)
                      <= sum(t.levels[1].size_in_bytes() for t in trees))
        self.sparse = bool(sparse)
        if self.sparse:
            self.e, self.b, self.b_ac, self.b_gt = (_on(v, device) for v in vecs)
            self._b = [self.b, self.b_ac, self.b_gt]
        else:
            self.l1 = nn.ModuleList([_on(t.levels[1], device) for t in trees])
            self._nodes = np.array([[t._host[0][1], t._host[1][1], t._host[0][2], t._host[1][2]]
                                    for t in trees], dtype=np.int32)

    @classmethod
    def from_bits(cls, bits: np.ndarray, kind: str, device="cpu",
                  sparse: bool | None = None) -> "SubsetWTRank":
        return cls(_sswt_symbols(bits), kind, device, sparse)

    @property
    def _device(self):
        return self.acgt.device if self.kind == "plain" else self.l0[0].meta.device

    def _lo(self, t, pos, r0):
        """Tree t's count of odd symbols before pos, given level 0's rank r0."""
        if not self.sparse:
            return sum(_wt4_pair_rank(self.l1[t], self._nodes[t], pos, r0))
        lo = pos - r0 + self._b[t].rank(pos)
        return lo - self.e.rank(pos) if t == 0 else lo

    def _lo_pair(self, t, p, padv, r, radv):
        """_lo at p and at p + padv (padv in {0, 1}), given level 0's ranks r
        and r + radv."""
        if not self.sparse:
            c1, c3, c1q, c3q = _wt4_pair_rank_pair(self.l1[t], self._nodes[t], p, padv, r, radv)
            return c1 + c3, c1q + c3q
        b1, b2 = self._b[t].rank_pair(p)
        lo1, lo2 = p - r + b1, p + padv - r - radv + torch.where(padv == 1, b2, b1)
        if t == 0:
            e1, e2 = self.e.rank_pair(p)
            lo1, lo2 = lo1 - e1, lo2 - torch.where(padv == 1, e2, e1)
        return lo1, lo2

    def _lanes(self, c, pos):
        dev = self._device
        return torch.broadcast_tensors(torch.as_tensor(c, device=dev).long(),
                                       torch.as_tensor(pos, device=dev).long())

    def _plane_rank_pair(self, c, pos):
        """plain: the acgt row at pos, then the ac or gt row at x; the rank
        at pos + 1 is the rank at pos plus the bit at each tree."""
        hi, hb, lo, lb = _plane_counts(self.acgt, pos)
        is_ac = c < 2
        x, adv = torch.where(is_ac, hi, lo), torch.where(is_ac, hb, lb)
        a = _plane_counts(self.ac, torch.where(is_ac, x, 0))
        g = _plane_counts(self.gt, torch.where(is_ac, 0, x))
        odd = (c & 1) == 1
        r = torch.where(is_ac, torch.where(odd, a[2], a[0]), torch.where(odd, g[2], g[0]))
        bit = torch.where(is_ac, torch.where(odd, a[3], a[1]), torch.where(odd, g[3], g[1]))
        return r, r + adv * bit

    def rank(self, c, pos):
        """SubsetWT::rank (SubsetWT.hh:94-113) over mixed chars."""
        c, pos = self._lanes(c, pos)
        if self.kind == "plain":
            return self._plane_rank_pair(c, pos)[0]
        is_ac = c < 2
        r0 = self.l0[0].rank(pos)
        x = torch.where(is_ac, r0, self._lo(0, pos, r0))
        acx, gtx = torch.where(is_ac, x, 0), torch.where(is_ac, 0, x)
        a0, g0 = self.l0[1].rank(acx), self.l0[2].rank(gtx)
        return torch.where(c == 0, a0, torch.where(c == 1, self._lo(1, acx, a0),
                           torch.where(c == 2, g0, self._lo(2, gtx, g0))))

    def rank_pair(self, c, pos):
        """Every tree argument at pos + 1 is the one at pos or its +1
        neighbour, so each tree answers both positions from one rank_pair."""
        c, pos = self._lanes(c, pos)
        if self.kind == "plain":
            return self._plane_rank_pair(c, pos)
        is_ac = c < 2
        r0a, r0b = self.l0[0].rank_pair(pos)
        lo1, lo2 = self._lo_pair(0, pos, torch.ones_like(pos), r0a, r0b - r0a)
        x = torch.where(is_ac, r0a, lo1)
        xadv = torch.where(is_ac, r0b, lo2) - x
        zero = torch.zeros_like(pos)
        acx, acadv = torch.where(is_ac, x, 0), torch.where(is_ac, xadv, zero)
        gtx, gtadv = torch.where(is_ac, 0, x), torch.where(is_ac, zero, xadv)
        ac0a, ac0b = self.l0[1].rank_pair(acx)
        ac_rq = torch.where(acadv == 1, ac0b, ac0a)
        gt0a, gt0b = self.l0[2].rank_pair(gtx)
        gt_rq = torch.where(gtadv == 1, gt0b, gt0a)
        ac1, ac1q = self._lo_pair(1, acx, acadv, ac0a, ac_rq - ac0a)
        gt1, gt1q = self._lo_pair(2, gtx, gtadv, gt0a, gt_rq - gt0a)
        r1 = torch.where(c == 0, ac0a, torch.where(c == 1, ac1, torch.where(c == 2, gt0a, gt1)))
        r2 = torch.where(c == 0, ac_rq, torch.where(c == 1, ac1q, torch.where(c == 2, gt_rq, gt1q)))
        return r1, r2

    contains = _contains

    def symbols(self):
        """The three trees' symbols, decoded on the host from the device form."""
        if self.kind == "plain":
            planes = [_plane_bools(getattr(self, name), n) for name, n in zip(_TREES, self.sizes)]
        else:
            his = [bv.to_bools() for bv in self.l0]
            if self.sparse:
                e, b, b_ac, b_gt = (v.to_bools() for v in (self.e, self.b, self.b_ac, self.b_gt))
                los = [(~his[0] & ~e) | (his[0] & b), ~his[1] | b_ac, ~his[2] | b_gt]
            else:
                los = []
                for hi, l1, (base_l, _, base_r, _) in zip(his, self.l1, self._nodes):
                    bools, lo = l1.to_bools(), np.zeros(len(hi), dtype=bool)
                    lo[~hi] = bools[base_l : base_l + int((~hi).sum())]
                    lo[hi] = bools[base_r : base_r + int(hi.sum())]
                    los.append(lo)
            planes = list(zip(his, los))
        return [2 * hi.astype(np.int64) + lo for hi, lo in planes]

    def to_bits(self) -> np.ndarray:
        acgt, ac, gt = self.symbols()
        acp, gtp = acgt >= 2, (acgt & 1) == 1
        bits = np.zeros((4, self.n), dtype=bool)
        bits[0, acp], bits[1, acp] = ac >= 2, (ac & 1) == 1
        bits[2, gtp], bits[3, gtp] = gt >= 2, (gt & 1) == 1
        return bits

    def payload(self) -> dict:
        out = {"n": np.int64(self.n)}
        for name, s in zip(_TREES, self.symbols()):
            wt = WaveletTree.build(s, 4, self.kind, "cpu")
            out.update({f"{name}_{k}": v for k, v in wt.payload().items()})
        return out

    @classmethod
    def from_payload(cls, p: dict, kind: str, device="cpu",
                     sparse: bool | None = None) -> "SubsetWTRank":
        syms = [WaveletTree.from_payload(_sub(p, f"{name}_"), kind, "cpu").to_symbols()
                for name in _TREES]
        return cls(syms, kind, device, sparse)

    def size_in_bytes(self) -> int:
        """The three wavelet trees' bytes, as the JAX package reports them."""
        return self._file_bytes

    def device_bytes(self) -> int:
        """The bytes of the device form."""
        if self.kind == "plain":
            return sum(getattr(self, name).numel() * 4 for name in _TREES)
        second = (self.e, self.b, self.b_ac, self.b_gt) if self.sparse else self.l1
        return sum(bv.size_in_bytes() for bv in (*self.l0, *second))

    def desc(self, dev):
        d = kernels.SUBSETWT_DESCS[self.kind]
        if self.kind == "plain":
            return d(*(kernels.ptr(getattr(self, name), f"subsetwt.{name}", dev, 16)
                       for name in _TREES))
        rrr3 = kernels.RRRDesc * 3
        if self.sparse:
            return d(rrr3(*(bv.desc(dev) for bv in self.l0)), self.e.desc(dev), self.b.desc(dev),
                     self.b_ac.desc(dev), self.b_gt.desc(dev), rrr3(), kernels.c_ints([0] * 12), 1)
        none = kernels.MEFDesc()
        return d(rrr3(*(bv.desc(dev) for bv in self.l0)), none, none, none, none,
                 rrr3(*(bv.desc(dev) for bv in self.l1)), kernels.c_ints(self._nodes.ravel()), 0)


# ---------------------------------------------------------------------------
# Variant registry (variants.hh:19-63)
# ---------------------------------------------------------------------------

VARIANT_STRUCTS = {
    "rrr-matrix": (MatrixRank, {"kind": "rrr"}),
    "mef-matrix": (MatrixRank, {"kind": "mef"}),
    "plain-split": (SplitRank, {"x_kind": "plain", "z_kind": "plain"}),
    "rrr-split": (SplitRank, {"x_kind": "rrr", "z_kind": "plain"}),
    "mef-split": (SplitRank, {"x_kind": "mef", "z_kind": "plain"}),
    "plain-concat": (ConcatRank, {"wt_kind": "plain"}),
    "mef-concat": (ConcatRank, {"wt_kind": "rrr"}),  # the reference's wt over rrr vectors
    "plain-subsetwt": (SubsetWTRank, {"kind": "plain"}),
    "rrr-subsetwt": (SubsetWTRank, {"kind": "rrr"}),
}


def build_struct(variant: str, bits: np.ndarray, device="cpu"):
    cls, kw = VARIANT_STRUCTS[variant]
    return cls.from_bits(bits, **kw, device=device)


def struct_from_payload(variant: str, payload: dict, device="cpu"):
    cls, kw = VARIANT_STRUCTS[variant]
    return cls.from_payload(payload, **kw, device=device)
