"""Port parity: bit vectors with rank (K15's plain versions).

The JAX package's PlainBV, RRRBV and MEFBV and the port's, built from the
same numpy-seeded bools: host payloads byte-equal, and rank, rank_pair and
get equal at every position (exact integers). The sizes are those of
tests/test_rank_pair.py plus two that cross many RRR superblocks (240
bits) and MEF buckets. The port's structure carried over from the JAX
payload answers the same.
"""
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sbwt_tpu.ops import bv as jbv
from sbwt_tpu_torch.kernels import CSRC
from sbwt_tpu_torch.ops import bv as tbv
from torch_state import bv_from_jax

SIZES = [(1, 0.5), (97, 0.3), (2048, 0.25), (700, 0.02), (5000, 0.5), (6000, 0.97)]


def _bools(n, density, seed):
    return np.random.default_rng(seed).random(n) < density


def assert_payload_equal(got: dict, ref: dict):
    assert list(got) == list(ref)
    for key in ref:
        a, b = np.asarray(got[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key


@pytest.mark.parametrize("kind", ["plain", "rrr", "mef"])
@pytest.mark.parametrize("n,density", SIZES)
def test_bv_matches_jax(kind, n, density):
    bools = _bools(n, density, n + int(density * 100))
    ref = jbv.BV_CLASSES[kind].build(bools)
    got = tbv.BV_CLASSES[kind].build(bools)
    assert_payload_equal(got.payload(), ref.payload())
    assert got.size_in_bytes() == ref.size_in_bytes()
    np.testing.assert_array_equal(got.to_bools(), bools)
    pos = np.arange(n + 1, dtype=np.int32)
    want_rank = np.asarray(jax.jit(ref.rank)(jnp.asarray(pos)))
    want_r1, want_r2 = (np.asarray(a) for a in jax.jit(ref.rank_pair)(jnp.asarray(pos[:n])))
    want_get = np.asarray(jax.jit(ref.get)(jnp.asarray(pos[:n])))
    for bv in (got, bv_from_jax(ref)):
        tpos = torch.from_numpy(pos).long()
        np.testing.assert_array_equal(bv.rank(tpos).numpy(), want_rank)
        r1, r2 = bv.rank_pair(tpos[:n])
        np.testing.assert_array_equal(r1.numpy(), want_r1)
        np.testing.assert_array_equal(r2.numpy(), want_r2)
        np.testing.assert_array_equal(bv.get(tpos[:n]).numpy(), want_get)
    np.testing.assert_array_equal(want_rank, np.concatenate([[0], np.cumsum(bools)]))


def test_mef_width_matches_jax():
    for n, density in SIZES:
        bools = _bools(n, density, 3)
        assert tbv.best_mef_width(bools) == jbv._best_mef_width(bools)


def test_rrr_tables_match_jax_and_device_constants():
    np.testing.assert_array_equal(tbv.PATTERN15, jbv._PATTERN15)
    np.testing.assert_array_equal(tbv.WIDTH15, jbv._WIDTH15)
    np.testing.assert_array_equal(tbv.CLS_BASE15, jbv._CLS_BASE15)
    assert (tbv.W15LO, tbv.W15HI) == (int(jbv._W15LO), int(jbv._W15HI))
    header = (CSRC / "bv.cuh").read_text()
    lo = int(re.search(r"kW15Lo = (0x[0-9A-F]+)u", header).group(1), 16)
    hi = int(re.search(r"kW15Hi = (0x[0-9A-F]+)u", header).group(1), 16)
    assert (lo, hi) == (tbv.W15LO, tbv.W15HI)


def test_legacy_rrr_payload_is_refused():
    with pytest.raises(ValueError, match="legacy"):
        tbv.RRRBV.from_payload({"meta": np.zeros((1, 5), np.int32), "offs": np.zeros(1, np.int32),
                                "n_bits": np.int64(0)})


# ---------------------------------------------------------------------------
# The device's RRR decode (csrc/bv.cuh), transcribed into numpy with the
# header's own constants: the combinatorial number system walk that takes
# the place of the pattern LUT, the table K14 stages from it, and the
# byte-wise class and width sums.
# ---------------------------------------------------------------------------


def _header_const(name: str) -> int:
    header = (CSRC / "bv.cuh").read_text()
    return int(re.search(rf"{name} = (0x[0-9A-F]+)u", header).group(1), 16)


C14LO, C14HI = _header_const("kC14Lo"), _header_const("kC14Hi")
W8LO, W8HI = _header_const("kW8Lo"), _header_const("kW8Hi")
LOW4, LOW4BASE = _header_const("kLow4"), _header_const("kLow4Base")
_NIBBLES = 0x0F0F0F0F0F0F0F0F


def _binom14(c):
    """bv.cuh binom14: C(14, c) from the 12-bit fields, 0 at c = 15."""
    j = np.where(c < 8, c, np.where(c < 15, 14 - c, 0))
    f = np.where(j < 5, C14LO >> (12 * j), C14HI >> (12 * np.maximum(j - 5, 0)))
    return np.where(c < 15, f & 0xFFF, 0)


def _decode(cls, off):
    """bv.cuh rrr15_decode: the pattern of class cls at offset off."""
    k, x, off = cls.copy(), _binom14(cls), off.copy()
    pat = np.zeros_like(cls)
    for b in range(14, 3, -1):
        one = off >= x
        down = x * k // b
        off = np.where(one, off - x, off)
        pat |= one.astype(np.int64) << b
        x = np.where(one, down, x - down)
        k = k - one
    u = np.uint64
    i = ((u(LOW4BASE) >> (u(8) * (k & 7).astype(u))) & u(0xFF)).astype(np.int64) + off
    return pat | ((u(LOW4) >> (u(4) * (i & 15).astype(u))) & u(15)).astype(np.int64)


def _binom15(c: int) -> int:
    return int(_binom14(np.array(c))) + (int(_binom14(np.array(c - 1))) if c > 0 else 0)


def _stage_patterns(threads: int):
    """bv.cuh stage_patterns over a block of `threads`: (table, bases)."""
    tbl = np.zeros(1 << 15, dtype=np.int64)
    for t in range(threads):
        for j0 in range(32 * t, 1 << 15, 32 * threads):
            cls, start, end, acc = 0, 0, 1, 1
            for c in range(1, 16):
                base = acc
                acc += _binom15(c)
                if j0 >= base:
                    cls, start, end = c, base, acc
            v = int(_decode(np.array([cls]), np.array([j0 - start]))[0])
            for j in range(j0, j0 + 32):
                if j == end:
                    cls += 1
                    end += _binom15(cls)
                    v = (1 << cls) - 1
                tbl[j] = v & 0xFFFF
                u = v | ((v - 1) & 0xFFFFFFFF)
                nu = ~u & 0xFFFFFFFF
                low = (nu & (-nu & 0xFFFFFFFF)) - 1
                v = ((u + 1) | (low >> ((v & -v).bit_length()))) & 0xFFFFFFFF if v else 0
    bases = [sum(_binom15(c) for c in range(t)) for t in range(16)]
    return tbl, np.array(bases)


def _byte_perm(x: int, y: int, s):
    """CUDA's __byte_perm: byte n of the result is byte s[4n + 2 : 4n] of y:x."""
    src = np.uint64((y << 32) | x)
    out = np.zeros_like(s, dtype=np.uint64)
    for n in range(4):
        sel = (s >> np.uint64(4 * n)) & np.uint64(7)
        out |= ((src >> (np.uint64(8) * sel)) & np.uint64(0xFF)) << np.uint64(8 * n)
    return out


def _block_sums(all_cls, j):
    """bv.cuh RRR15Of::block_in over the 64-bit class word of a superblock:
    (sum of the classes below block j, sum of their offset widths, class j)."""
    u = np.uint64
    mask = np.where(j > 0, np.uint64(0xFFFFFFFFFFFFFFFF) >> (u(64) - u(4) * j.astype(u)), u(0))
    below = all_cls & mask
    b = (below & u(_NIBBLES)) + ((below >> u(4)) & u(_NIBBLES))
    s = ((b & u(0xFFFFFFFF)) + (b >> u(32))) & u(0xFFFFFFFF)
    cls_sum = ((s * u(0x01010101)) & u(0xFFFFFFFF)) >> u(24)
    hi = (below >> u(3)) & u(0x1111111111111111)
    f = below ^ ((hi << u(4)) - hi)
    lo32, hi32 = f & u(0xFFFFFFFF), f >> u(32)
    t = sum(_byte_perm(W8LO, W8HI, w) for w in (lo32, lo32 >> u(16), hi32, hi32 >> u(16)))
    w_sum = ((t * u(0x01010101)) & u(0xFFFFFFFF)) >> u(24)
    mine = (all_cls >> (u(4) * j.astype(u))) & u(15)
    return cls_sum.astype(np.int64), w_sum.astype(np.int64), mine.astype(np.int64)


def test_rrr_decode_constants_match_comb():
    """The binomials and byte widths bv.cuh hard-codes, against math.comb."""
    import math

    assert [(C14LO >> (12 * j)) & 0xFFF for j in range(5)] == [math.comb(14, j) for j in range(5)]
    assert C14LO >> 60 == 0
    assert [(C14HI >> (12 * j)) & 0xFFF for j in range(3)] == [math.comb(14, j) for j in (5, 6, 7)]
    assert C14HI >> 36 == 0
    np.testing.assert_array_equal(_binom14(np.arange(16)),
                                  [math.comb(14, c) for c in range(16)])
    assert [_binom15(c) for c in range(16)] == [math.comb(15, c) for c in range(16)]
    # the 4-bit patterns by class, then in numeric order, and the classes' starts
    low4 = sorted(range(16), key=lambda q: (bin(q).count("1"), q))
    assert [(LOW4 >> (4 * i)) & 15 for i in range(16)] == low4
    assert [(LOW4BASE >> (8 * j)) & 0xFF for j in range(5)] == [
        sum(math.comb(4, c) for c in range(j)) for j in range(5)]
    assert LOW4BASE >> 40 == 0
    widths = [(W8LO >> (8 * c)) & 0xFF for c in range(4)] + [(W8HI >> (8 * c)) & 0xFF
                                                               for c in range(4)]
    assert widths == list(tbv.WIDTH15[:8])
    # the fold of classes 8..15 onto 7..0
    np.testing.assert_array_equal(tbv.WIDTH15, tbv.WIDTH15[::-1])
    assert list(tbv.WIDTH15) == [max(0, math.ceil(math.log2(math.comb(15, c)))) for c in range(16)]


@pytest.mark.parametrize("cls", range(16))
def test_rrr_device_decode_matches_tables(cls):
    """The register decode at every offset of one class, classes 0 and 15
    (width 0) among them: the pattern is PATTERN15's, and OFFSET15 maps it
    back."""
    lo, hi = int(tbv.CLS_BASE15[cls]), int(tbv.CLS_BASE15[cls + 1])
    off = np.arange(hi - lo)
    assert (off < (1 << int(tbv.WIDTH15[cls]))).all()
    want = tbv.PATTERN15[lo:hi].astype(np.int64)  # class_base[c] + offset -> pattern
    np.testing.assert_array_equal(tbv.OFFSET15[want], off)
    np.testing.assert_array_equal(_decode(np.full(hi - lo, cls), off), want)


@pytest.mark.parametrize("threads", [1024, 512, 96])
def test_rrr_staged_table_matches_tables(threads):
    """The table a K14 block stages (runs of 32 entries a thread, unranked
    once, then Gosper's hack within a class) is PATTERN15, and its class
    bases are CLS_BASE15's, whatever the block's size."""
    tbl, bases = _stage_patterns(threads)
    np.testing.assert_array_equal(tbl, tbv.PATTERN15)
    np.testing.assert_array_equal(bases, tbv.CLS_BASE15[:16])


@pytest.mark.parametrize("j", range(16))
def test_rrr_device_block_sums_match_loop(j):
    """The byte-wise sums of bv.cuh's block_in against the per-block loop
    they replace, over random superblock class words (every class 0..15)."""
    rng = np.random.default_rng(j)
    nib = rng.integers(0, 16, size=(4096, 16))
    nib[0], nib[1] = 15, 0  # all class 15, all class 0
    all_cls = (nib.astype(np.uint64) << (np.uint64(4) * np.arange(16, dtype=np.uint64))).sum(
        axis=1, dtype=np.uint64)
    cls_sum, w_sum, mine = _block_sums(all_cls, np.full(len(nib), j))
    np.testing.assert_array_equal(cls_sum, nib[:, :j].sum(axis=1))
    np.testing.assert_array_equal(w_sum, tbv.WIDTH15[nib[:, :j]].sum(axis=1))
    np.testing.assert_array_equal(mine, nib[:, j])
