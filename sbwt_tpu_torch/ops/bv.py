"""Bit vectors with rank: plain, RRR-compressed and modified Elias-Fano.

The port of sbwt_tpu/ops/bv.py. Each class keeps the JAX package's int32
device layout, so that ``payload()`` is byte-equal to the JAX one and
``from_payload`` accepts a JAX payload:

* ``PlainBV`` — (word, exclusive cum popcount) rows, one row per rank.
* ``RRRBV``   — 15-bit blocks stored as (class, offset); a superblock row
  (cum rank, offset bit pointer, 16 four-bit classes in two words), a
  packed offset stream, and the shared 2^15-entry offset -> pattern LUT.
* ``MEFBV``   — 2^wl-bit buckets; ``upper`` marks the non-empty ones,
  ``lower`` holds them: rank = two plain ranks.

Host builders are numpy. ``rank``, ``rank_pair`` and ``get`` here are the
plain PyTorch versions (int64 lanes) of the device types in
csrc/bv.cuh (K15), which the LF kernels inline; ``desc`` gives the
descriptor those kernels read.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import kernels
from . import bitvector as bvt

_LOW32 = 0xFFFFFFFF


def as_int32(a, device) -> torch.Tensor:
    """An int32 tensor on device of an array (copied if not writable)."""
    return torch.as_tensor(np.require(a, np.int32, ["C", "W"]), device=device)


# ---------------------------------------------------------------------------
# Plain
# ---------------------------------------------------------------------------


class PlainBV(nn.Module):
    """tbl int32 [W, 2] (bits word, exclusive cum popcount)."""

    def __init__(self, tbl: torch.Tensor, n_bits: int):
        super().__init__()
        self.register_buffer("tbl", tbl)
        self.n_bits = int(n_bits)

    @classmethod
    def build(cls, bools: np.ndarray, device="cpu") -> "PlainBV":
        bools = np.asarray(bools, dtype=bool)
        return cls(as_int32(bvt.rank_table_host(bools), device), len(bools))

    def rank(self, pos):
        return bvt.rank(self.tbl, pos)

    def rank_pair(self, pos):
        """(rank(pos), rank(pos + 1)) from one row."""
        r, bit = bvt.rank_get(self.tbl, pos)
        return r, r + bit

    def get(self, pos):
        return bvt.rank_get(self.tbl, pos)[1]

    def to_bools(self) -> np.ndarray:
        words = np.ascontiguousarray(self.tbl[:, 0].cpu().numpy()).view(np.uint32)
        return np.unpackbits(words.view(np.uint8), bitorder="little")[: self.n_bits].astype(bool)

    def payload(self) -> dict:
        return {"tbl": self.tbl.cpu().numpy(), "n_bits": np.int64(self.n_bits)}

    @classmethod
    def from_payload(cls, p: dict, device="cpu") -> "PlainBV":
        return cls(as_int32(p["tbl"], device), int(p["n_bits"]))

    def size_in_bytes(self) -> int:
        return self.tbl.numel() * 4

    def desc(self, dev) -> kernels.PlainBVDesc:
        return kernels.PlainBVDesc(kernels.ptr(self.tbl, "bv.tbl", dev, 8))


# ---------------------------------------------------------------------------
# RRR over 15-bit blocks
# ---------------------------------------------------------------------------

BLK15 = 15  # bits per block: here the offset -> pattern decode is one LUT load
SBB15 = 16  # blocks per superblock; 16 four-bit classes fill two words

# (class, offset) <-> pattern over all 2^15 patterns: the offset of a
# pattern is its numeric rank among the patterns of its popcount class.
_P15 = np.arange(1 << BLK15, dtype=np.int64)
CLS15 = np.zeros(1 << BLK15, dtype=np.int64)
for _b in range(BLK15):
    CLS15 += (_P15 >> _b) & 1
_CLS_COUNT15 = np.bincount(CLS15, minlength=BLK15 + 1)
CLS_BASE15 = np.zeros(BLK15 + 2, dtype=np.int64)
CLS_BASE15[1:] = np.cumsum(_CLS_COUNT15)
_order = np.argsort(CLS15, kind="stable")
PATTERN15 = _order.astype(np.int32)  # class_base[c] + offset -> pattern
OFFSET15 = np.empty(1 << BLK15, dtype=np.int64)
OFFSET15[_order] = np.arange(1 << BLK15, dtype=np.int64) - CLS_BASE15[CLS15[_order]]
# offset width of each class: ceil(log2 C(15, c)), at most 13 bits
WIDTH15 = np.array(
    [max(1, int(np.ceil(np.log2(max(1, c))))) if c > 1 else 0 for c in _CLS_COUNT15[: BLK15 + 1]],
    dtype=np.int32,
)
# the widths as nibbles (classes 0..7, 8..15): csrc/bv.cuh hard-codes these
W15LO = sum(int(WIDTH15[c]) << (4 * c) for c in range(8))
W15HI = sum(int(WIDTH15[c]) << (4 * (c - 8)) for c in range(8, 16))

_LUT_CACHE: dict = {}


def _rrr_constants(device):
    """The shared pattern LUT int32 [2^15] and class bases int32 [16] on device."""
    key = str(torch.device(device))
    if key not in _LUT_CACHE:
        _LUT_CACHE[key] = (as_int32(PATTERN15, device), as_int32(CLS_BASE15[:16], device))
    return _LUT_CACHE[key]


class RRRBV(nn.Module):
    """meta int32 [n_sb, 4] = (cum rank, offset bit pointer, classes of
    blocks 0-7, classes of blocks 8-15); offs int32 packed offset stream;
    lut int32 [2^15] and base int32 [16] shared by every RRR vector, read
    by the plain version only (the device type decodes a pattern from its
    class and offset in registers, csrc/bv.cuh)."""

    def __init__(self, meta: torch.Tensor, offs: torch.Tensor, n_bits: int):
        super().__init__()
        lut, base = _rrr_constants(meta.device)
        self.register_buffer("meta", meta)
        self.register_buffer("offs", offs)
        self.register_buffer("lut", lut, persistent=False)
        self.register_buffer("base", base, persistent=False)
        self.n_bits = int(n_bits)

    @classmethod
    def build(cls, bools: np.ndarray, device="cpu") -> "RRRBV":
        bools = np.asarray(bools, dtype=bool)
        n = len(bools)
        B = max(1, (n + BLK15 - 1) // BLK15)
        padded = np.zeros(B * BLK15, dtype=bool)
        padded[:n] = bools
        # bit j of a block's pattern is bit blk * 15 + j
        pats = (padded.reshape(B, BLK15).astype(np.int64)
                << np.arange(BLK15, dtype=np.int64)).sum(axis=1)
        meta, offs = _rrr_arrays(CLS15[pats], OFFSET15[pats])
        return cls(as_int32(meta, device), as_int32(offs, device), n)

    def _pattern_at(self, pos):
        """(pattern of pos's block, offset o in it, rank before the block); int64."""
        pos = torch.as_tensor(pos, device=self.meta.device).long()
        blk = pos // BLK15
        j = blk & 15
        row = self.meta[blk >> 4].long()
        t = torch.arange(SBB15, device=pos.device)
        words = torch.where(t < 8, row[..., 2, None], row[..., 3, None]) & _LOW32
        six = (words >> (4 * (t & 7))) & 15  # [..., 16] classes
        below = t < j[..., None]
        width = torch.as_tensor(WIDTH15, device=pos.device).long()
        cls_sum = torch.where(below, six, 0).sum(dim=-1)
        w_sum = torch.where(below, width[six], 0).sum(dim=-1)
        my_cls = six.gather(-1, j[..., None])[..., 0]
        bitp = row[..., 1] + w_sum
        wi, sh = bitp >> 5, bitp & 31
        s0 = self.offs[wi].long() & _LOW32
        s1 = self.offs[wi + 1].long() & _LOW32
        raw = (s0 >> sh) | torch.where(sh > 0, (s1 << (32 - sh)) & _LOW32, 0)
        off = raw & ((1 << width[my_cls]) - 1)
        pat = self.lut[self.base[my_cls].long() + off].long()
        return pat, pos - blk * BLK15, row[..., 0] + cls_sum

    def rank(self, pos):
        pat, o, before = self._pattern_at(pos)
        return before + bvt.popcount32(pat & ((1 << o) - 1))

    def rank_pair(self, pos):
        """(rank(pos), rank(pos + 1)) from one decode: pos + 1 shares the
        block (the width-(o + 1) mask at o = 14 covers the whole pattern)."""
        pat, o, before = self._pattern_at(pos)
        m1 = (1 << o) - 1
        return before + bvt.popcount32(pat & m1), before + bvt.popcount32(pat & ((m1 << 1) | 1))

    def get(self, pos):
        pat, o, _ = self._pattern_at(pos)
        return (pat >> o) & 1

    def _host_blocks(self):
        """(classes, offsets) int64 [n_sb * 16] decoded from meta and offs."""
        meta = self.meta.cpu().numpy()
        n_sb = meta.shape[0]
        cls_words = np.ascontiguousarray(meta[:, 2:4]).view(np.uint32).astype(np.uint64)
        classes = np.zeros((n_sb, SBB15), dtype=np.int64)
        for j in range(SBB15):
            classes[:, j] = (cls_words[:, j // 8] >> np.uint64(4 * (j % 8))) & 15
        classes = classes.ravel()
        widths = WIDTH15[classes].astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(widths)])[:-1]
        stream = self.offs.cpu().numpy().view(np.uint32).astype(np.uint64)
        stream = np.concatenate([stream, np.zeros(2, dtype=np.uint64)])
        wi = starts // 32
        sh = (starts % 32).astype(np.uint64)
        raw = (stream[wi] >> sh) | np.where(sh > 0, stream[wi + 1] << (np.uint64(32) - sh),
                                            np.uint64(0))
        offsets = raw & ((np.uint64(1) << widths.astype(np.uint64)) - np.uint64(1))
        return classes, offsets.astype(np.int64)

    def to_bools(self) -> np.ndarray:
        classes, offsets = self._host_blocks()
        n_blocks = max(1, (self.n_bits + BLK15 - 1) // BLK15)
        pats = PATTERN15[CLS_BASE15[classes[:n_blocks]] + offsets[:n_blocks]]
        bits = (pats[:, None] >> np.arange(BLK15, dtype=np.int64)) & 1
        return bits.astype(bool).ravel()[: self.n_bits]

    def payload(self) -> dict:
        return {"meta15": self.meta.cpu().numpy(), "offs15": self.offs.cpu().numpy(),
                "n_bits": np.int64(self.n_bits)}

    @classmethod
    def from_payload(cls, p: dict, device="cpu") -> "RRRBV":
        if "meta15" not in p:
            raise ValueError("legacy 63-bit-block RRR payloads are not supported by the port")
        return cls(as_int32(p["meta15"], device), as_int32(p["offs15"], device), int(p["n_bits"]))

    def size_in_bytes(self) -> int:
        # the pattern LUT is a shared constant, not part of the vector
        return (self.meta.numel() + self.offs.numel()) * 4

    def desc(self, dev) -> kernels.RRRDesc:
        # the device type decodes patterns in registers: no LUT
        return kernels.RRRDesc(kernels.ptr(self.meta, "rrr.meta", dev, 16),
                               kernels.ptr(self.offs, "rrr.offs", dev))


def _rrr_arrays(classes: np.ndarray, offsets: np.ndarray):
    """(meta int32 [n_sb, 4], offs int32) of the blocks' classes and offsets."""
    B = len(classes)
    # one pad superblock, so that blk = n_bits // 15 always has a meta row
    n_sb = (B + SBB15 - 1) // SBB15 + 1
    cls_pad = np.zeros(n_sb * SBB15, dtype=np.int64)
    cls_pad[:B] = classes
    widths = WIDTH15[cls_pad].astype(np.int64)
    bit_pos = np.concatenate([[0], np.cumsum(widths)])
    total_bits = int(bit_pos[-1])
    cum = np.concatenate([[0], np.cumsum(cls_pad)]).astype(np.int64)
    if cum[-1] >= 2**31 or total_bits >= 2**31:
        raise ValueError("RRR vector too large for int32 device rank")
    # each offset (<= 13 bits) touches at most two words
    stream = np.zeros(total_bits // 32 + 2, dtype=np.uint64)
    starts = bit_pos[: n_sb * SBB15]
    offs64 = np.zeros(n_sb * SBB15, dtype=np.uint64)
    offs64[:B] = offsets.astype(np.uint64)
    w = starts // 32
    sh = (starts % 32).astype(np.uint64)
    np.bitwise_or.at(stream, w, (offs64 << sh) & np.uint64(_LOW32))
    np.bitwise_or.at(stream, w + 1, np.where(sh > 0, offs64 >> (np.uint64(32) - sh), np.uint64(0)))
    offs = stream.astype(np.uint32).view(np.int32)

    meta = np.zeros((n_sb, 4), dtype=np.int32)
    meta[:, 0] = cum[np.arange(n_sb) * SBB15]
    meta[:, 1] = bit_pos[np.arange(n_sb) * SBB15]
    cls_mat = cls_pad.reshape(n_sb, SBB15)
    packed = np.zeros((n_sb, 2), dtype=np.uint64)
    for j in range(SBB15):
        packed[:, j // 8] |= cls_mat[:, j].astype(np.uint64) << np.uint64(4 * (j % 8))
    meta[:, 2:4] = (packed & np.uint64(_LOW32)).astype(np.uint32).view(np.int32)
    return meta, offs


# ---------------------------------------------------------------------------
# Modified Elias-Fano
# ---------------------------------------------------------------------------


class MEFBV(nn.Module):
    """mod_ef_vector (MEF.hpp:85-131): with b = pos >> wl and
    u = rank(upper, b), rank(pos) = rank(lower, (u << wl) + t), where
    t = pos mod 2^wl if bucket b is kept and 0 otherwise."""

    def __init__(self, upper: PlainBV, lower: PlainBV, n_bits: int, wl: int):
        super().__init__()
        self.upper = upper
        self.lower = lower
        self.n_bits = int(n_bits)
        self.wl = int(wl)

    @classmethod
    def build(cls, bools: np.ndarray, device="cpu", wl: int | None = None) -> "MEFBV":
        bools = np.asarray(bools, dtype=bool)
        n = len(bools)
        if wl is None:
            wl = best_mef_width(bools)
        bs = 1 << wl
        n_buckets = max(1, (n + bs - 1) // bs)
        padded = np.zeros(n_buckets * bs, dtype=bool)
        padded[:n] = bools
        buckets = padded.reshape(n_buckets, bs)
        nonempty = buckets.any(axis=1)
        return cls(PlainBV.build(nonempty, device), PlainBV.build(buckets[nonempty].ravel(), device),
                   n, wl)

    def _lower_pos(self, pos):
        pos = torch.as_tensor(pos, device=self.upper.tbl.device).long()
        u, keep = bvt.rank_get(self.upper.tbl, pos >> self.wl)
        t = pos & ((1 << self.wl) - 1)
        return (u << self.wl) + torch.where(keep == 1, t, 0), keep

    def rank(self, pos):
        return self.lower.rank(self._lower_pos(pos)[0])

    def rank_pair(self, pos):
        """(rank(pos), rank(pos + 1)): the bit at pos is lower's bit at
        lpos when bucket b is kept, and 0 otherwise."""
        lpos, keep = self._lower_pos(pos)
        r1, r2 = self.lower.rank_pair(lpos)
        return r1, torch.where(keep == 1, r2, r1)

    def get(self, pos):
        lpos, keep = self._lower_pos(pos)
        return torch.where(keep == 1, self.lower.get(lpos), 0)

    def to_bools(self) -> np.ndarray:
        up = self.upper.to_bools()
        low = self.lower.to_bools()
        bs = 1 << self.wl
        out = np.zeros(len(up) * bs, dtype=bool)
        kept = np.flatnonzero(up)
        out.reshape(len(up), bs)[kept] = low[: len(kept) * bs].reshape(len(kept), bs)
        return out[: self.n_bits]

    def payload(self) -> dict:
        return {
            "upper_tbl": self.upper.tbl.cpu().numpy(), "upper_n": np.int64(self.upper.n_bits),
            "lower_tbl": self.lower.tbl.cpu().numpy(), "lower_n": np.int64(self.lower.n_bits),
            "n_bits": np.int64(self.n_bits), "wl": np.int64(self.wl),
        }

    @classmethod
    def from_payload(cls, p: dict, device="cpu") -> "MEFBV":
        return cls(PlainBV(as_int32(p["upper_tbl"], device), int(p["upper_n"])),
                   PlainBV(as_int32(p["lower_tbl"], device), int(p["lower_n"])),
                   int(p["n_bits"]), int(p["wl"]))

    def size_in_bytes(self) -> int:
        return self.upper.size_in_bytes() + self.lower.size_in_bytes()

    def desc(self, dev) -> kernels.MEFDesc:
        return kernels.MEFDesc(self.upper.desc(dev), self.lower.desc(dev), self.wl)


def best_mef_width(bools: np.ndarray) -> int:
    """Bucket width minimizing upper + lower bits (the optimum that
    MEF.hpp:284-354 reaches by iterated pair-OR shrinking)."""
    n = len(bools)
    if n == 0:
        return 3
    best_wl, best_cost = 3, None
    for wl in range(3, 17):
        bs = 1 << wl
        n_buckets = (n + bs - 1) // bs
        padded = np.zeros(n_buckets * bs, dtype=bool)
        padded[:n] = bools
        cost = n_buckets + int(padded.reshape(n_buckets, bs).any(axis=1).sum()) * bs
        if best_cost is None or cost < best_cost:
            best_wl, best_cost = wl, cost
        if bs >= n:
            break
    return best_wl


BV_CLASSES = {"plain": PlainBV, "rrr": RRRBV, "mef": MEFBV}
