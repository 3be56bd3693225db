// K15: bit vectors with rank on the device: plain, RRR over 15-bit blocks,
// and modified Elias-Fano. Each type has
//   rank(pos)       number of set bits before pos, pos in [0, n]
//   rank_pair(pos)  (rank(pos), rank(pos + 1)), pos in [0, n)
//   get(pos)        the bit at pos
//   bits(pos, len, &r)  bits pos .. pos + len - 1 (len in [0, 32]) in the
//                   low len bits, the rest zero, and rank(pos) into r;
//                   reads only the rows that hold those bits and rank(pos)
//                   (succ1's whole-table decode, succ_table.cuh)
// over the int32 layouts of sbwt_tpu/ops/bv.py (built on the host by
// sbwt_tpu_torch/ops/bv.py). The types are plain descriptors of device
// pointers, passed to a kernel by value; Python mirrors them with ctypes
// (sbwt_tpu_torch/kernels).
//
// Replaces the XLA code of sbwt_tpu/ops/bv.py: PlainBV (:63, with
// ops/bitvector.py rank/rank_pair/rank_get), RRRBV._pattern_at / rank /
// rank_pair / get (:285-348) and MEFBV.rank / rank_pair / get (:500-532).
//
// Bound on the H100: dependent loads. A plain rank is one 8-byte row; an
// RRR rank is a 16-byte superblock row, then one word of the offset stream
// (two where the offset straddles them), and the pattern is decoded in
// registers or read from shared memory (no pattern table in device memory:
// the JAX package's 128 KB LUT cost a third round of loads a rank); MEF is
// two plain ranks in a row. rank_pair
// answers both positions from the one decode, because pos + 1 lies in
// pos's word / block / bucket or is the next one's first bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sbwt {

// The low n bits set, n in [0, 32]
__device__ __forceinline__ unsigned low_mask(int n) { return n >= 32 ? ~0u : (1u << n) - 1u; }

// The low bits of v, in order, at the set bits of m (x86's pdep)
__device__ __forceinline__ unsigned deposit(unsigned v, unsigned m) {
    unsigned r = 0;
    while (m) {
        const unsigned low = m & (0u - m);
        if (v & 1u) r |= low;
        v >>= 1;
        m ^= low;
    }
    return r;
}

// ---------------------------------------------------------------------------
// Plain: int2 [W] (bits word, exclusive cum popcount)
// ---------------------------------------------------------------------------

struct PlainBV {
    const int2* tbl;

    // (rank(pos), bit at pos) from one row
    __device__ __forceinline__ int rank_get(int pos, int* bit) const {
        const int2 row = tbl[pos >> 5];
        const unsigned o = (unsigned)pos & 31u;
        *bit = (int)(((unsigned)row.x >> o) & 1u);
        return row.y + __popc((unsigned)row.x & ((1u << o) - 1u));
    }
    __device__ __forceinline__ int rank(int pos) const {
        int bit;
        return rank_get(pos, &bit);
    }
    __device__ __forceinline__ int2 rank_pair(int pos) const {
        int bit;
        const int r = rank_get(pos, &bit);
        return make_int2(r, r + bit);
    }
    __device__ __forceinline__ int get(int pos) const {
        int bit;
        rank_get(pos, &bit);
        return bit;
    }
    // the next row only where the bits cross into it
    __device__ __forceinline__ unsigned bits(int pos, int len, int* r) const {
        const int2 row = tbl[pos >> 5];
        const unsigned o = (unsigned)pos & 31u;
        *r = row.y + __popc((unsigned)row.x & ((1u << o) - 1u));
        unsigned v = (unsigned)row.x >> o;
        if ((int)o + len > 32) v |= (unsigned)tbl[(pos >> 5) + 1].x << (32u - o);
        return v & low_mask(len);
    }
};

// ---------------------------------------------------------------------------
// RRR over 15-bit blocks (sbwt_tpu/ops/bv.py RRRBV)
//   meta int4 [n_sb]: (cum rank, offset bit pointer, classes of blocks 0-7,
//                      classes of blocks 8-15), 4 bits per class
//   offs uint32 stream of the blocks' offsets, width WIDTH15[class] each
// A block's pattern comes from (class, offset) with no table in device
// memory: the offset of a class-k pattern is its rank among the class's
// patterns in numeric order, which is the combinatorial number system,
// off = sum of C(b_i, i) over its set bits b_1 < ... < b_k. So the pattern
// is found greedily from bit 14 down, in registers (rrr15_decode): bit b
// is set iff what is left of off is at least C(b, k), k the ones not yet
// placed. RRR15 decodes so; RRR15Staged reads the pattern from a table of
// all 2^15 that the kernel staged in shared memory (stage_patterns), which
// K1's fill and partial_search do for SubsetWTRank<RRR15> (subset_rank.cuh
// StagedRank).
// ---------------------------------------------------------------------------

// offset width of each class, ceil(log2 C(15, c)), as nibbles: classes
// 0-7 in the low constant, 8-15 in the high one (sbwt_tpu_torch/ops/bv.py
// W15LO / W15HI, checked by the tests)
constexpr unsigned kW15Lo = 0xDDCB9740u;
constexpr unsigned kW15Hi = 0x0479BCDDu;
// the widths of classes 0-7 as bytes, 0-3 and 4-7: a byte permute looks up
// four at once (width15(c) = width15(15 - c))
constexpr unsigned kW8Lo = 0x09070400u;
constexpr unsigned kW8Hi = 0x0D0D0C0Bu;
// C(14, j), j = 0..7, as 12-bit fields: j = 0..4 in the low constant, 5..7
// in the high one (checked against math.comb by the tests)
constexpr unsigned long long kC14Lo = 0x3E916C05B00E001ull;
constexpr unsigned long long kC14Hi = 0xD68BBB7D2ull;

__device__ __forceinline__ unsigned width15(unsigned cls) {
    return ((cls < 8u ? kW15Lo : kW15Hi) >> (4u * (cls & 7u))) & 15u;
}

// C(14, c) for c in [0, 15] (C(14, 15) = 0)
__device__ __forceinline__ unsigned binom14(unsigned c) {
    const unsigned j = c < 8u ? c : (c < 15u ? 14u - c : 0u);
    const unsigned long long f = j < 5u ? kC14Lo >> (12u * j) : kC14Hi >> (12u * (j - 5u));
    return c < 15u ? (unsigned)f & 0xFFFu : 0u;
}

// The 4-bit patterns by class, then in numeric order, as nibbles, and
// where each class starts among them, as bytes (checked by the tests)
constexpr unsigned long long kLow4 = 0xFEDB7CA965384210ull;
constexpr unsigned long long kLow4Base = 0xF0B050100ull;

// The class-cls pattern at offset off. x = C(b, k) at each step; the next
// is C(b - 1, k - 1) = x k / b where bit b is set, else C(b - 1, k) =
// x - x k / b (Pascal's rule). b is a constant of the unrolled loop, so
// the division is a multiply. Bits 3..0 are the k ones left at the offset
// left, among the 4-bit patterns: one lookup in kLow4. The walk runs to
// bit 4 for every rank: stopping at the bit a rank needs was slower on an
// H100 (the lanes of a warp stop at different bits; PERF.md).
__device__ __forceinline__ unsigned rrr15_decode(unsigned cls, unsigned off) {
    unsigned k = cls, x = binom14(cls), pat = 0;
#pragma unroll
    for (int b = 14; b >= 4; --b) {
        const bool one = off >= x;
        const unsigned down = x * k / (unsigned)b;
        if (one) {
            off -= x;
            pat |= 1u << b;
        }
        x = one ? down : x - down;
        k -= one ? 1u : 0u;
    }
    const unsigned i = (unsigned)(kLow4Base >> (8u * (k & 7u))) + off;
    return pat | ((unsigned)(kLow4 >> (4u * (i & 15u))) & 15u);
}

// Sum of the nibbles of v
__device__ __forceinline__ int nibble_sum(unsigned long long v) {
    const unsigned long long b = (v & 0x0F0F0F0F0F0F0F0Full) + ((v >> 4) & 0x0F0F0F0F0F0F0F0Full);
    return (int)((((unsigned)b + (unsigned)(b >> 32)) * 0x01010101u) >> 24);  // bytes <= 60
}

// Sum of the offset widths of the classes in the nibbles of v: a class c
// >= 8 is folded onto 15 - c (flip its nibble), then each 16 bits of
// classes look up four byte widths at once
__device__ __forceinline__ int width_sum(unsigned long long v) {
    const unsigned long long hi = (v >> 3) & 0x1111111111111111ull;
    const unsigned long long f = v ^ ((hi << 4) - hi);
    const unsigned lo32 = (unsigned)f, hi32 = (unsigned)(f >> 32);
    const unsigned t = __byte_perm(kW8Lo, kW8Hi, lo32) + __byte_perm(kW8Lo, kW8Hi, lo32 >> 16) +
                       __byte_perm(kW8Lo, kW8Hi, hi32) + __byte_perm(kW8Lo, kW8Hi, hi32 >> 16);
    return (int)((t * 0x01010101u) >> 24);  // bytes <= 52
}

// The staged pattern table: entry base[c] + offset of class c as uint16,
// then base[0..15] as ints, at the start of the kernel's dynamic shared
// memory
constexpr int kPatternTableBytes = 65536 + 64;
extern __shared__ __align__(16) unsigned char pattern_table[];

// C(15, c) for c in [0, 15]
__device__ __forceinline__ unsigned binom15(unsigned c) {
    return binom14(c) + (c > 0u ? binom14(c - 1u) : 0u);
}

// Fills the pattern table, class by class in numeric order: each thread
// unranks the first entry of its run of 32 in registers and steps to the
// next pattern of the class by Gosper's hack, to the first of the next
// class where its class ends. The caller syncs the block.
__device__ __forceinline__ void stage_patterns() {
    uint16_t* tbl = reinterpret_cast<uint16_t*>(pattern_table);
    for (int j0 = 32 * (int)threadIdx.x; j0 < 32768; j0 += 32 * (int)blockDim.x) {
        unsigned cls = 0, start = 0, end = 1, acc = 1;  // entries [start, end) of class cls
#pragma unroll
        for (unsigned c = 1; c < 16; ++c) {
            const unsigned base = acc;
            acc += binom15(c);
            if ((unsigned)j0 >= base) {
                cls = c;
                start = base;
                end = acc;
            }
        }
        unsigned v = rrr15_decode(cls, (unsigned)j0 - start);
        for (int j = j0; j < j0 + 32; ++j) {
            if ((unsigned)j == end) {
                end += binom15(++cls);
                v = (1u << cls) - 1u;
            }
            tbl[j] = (uint16_t)v;
            const unsigned t = v | (v - 1u);
            v = v ? (t + 1u) | (((~t & (0u - ~t)) - 1u) >> __ffs((int)v)) : 0u;
        }
    }
    if (threadIdx.x < 16) {
        unsigned start = 0;
        for (unsigned c = 0; c < threadIdx.x; ++c) start += binom15(c);
        reinterpret_cast<int*>(pattern_table + 65536)[threadIdx.x] = (int)start;
    }
}

struct RegisterPatterns {
    __device__ __forceinline__ static unsigned pattern(unsigned cls, unsigned off) {
        return rrr15_decode(cls, off);
    }
};
struct StagedPatterns {
    __device__ __forceinline__ static unsigned pattern(unsigned cls, unsigned off) {
        const int base = reinterpret_cast<const int*>(pattern_table + 65536)[cls];
        return reinterpret_cast<const uint16_t*>(pattern_table)[base + (int)off];
    }
};

template <class Patterns>
struct RRR15Of {
    const int4* meta;
    const unsigned* offs;

    __device__ __forceinline__ static unsigned class_of(const int4& row, unsigned t) {
        return ((t < 8u ? (unsigned)row.z : (unsigned)row.w) >> (4u * (t & 7u))) & 15u;
    }
    // The offset of width w at bit bitp of the stream: the second word is
    // read only where the offset reaches into it
    __device__ __forceinline__ unsigned offset_at(int bitp, unsigned w) const {
        const unsigned sh = (unsigned)bitp & 31u;
        const unsigned s0 = offs[bitp >> 5];
        const unsigned s1 = sh + w > 32u ? offs[(bitp >> 5) + 1] : 0u;
        // a shift by 32 is undefined: sh == 0 takes s0 alone (bv.py:313)
        return ((s0 >> sh) | (sh ? s1 << (32u - sh) : 0u)) & ((1u << w) - 1u);
    }
    // Block j of a superblock row: its class, its offset's bit pointer and
    // the rank before it, by byte-wise sums over the blocks before it
    __device__ __forceinline__ static unsigned block_in(const int4& row, unsigned j, int* bitp,
                                                        int* before) {
        const unsigned long long all =
            ((unsigned long long)(unsigned)row.w << 32) | (unsigned long long)(unsigned)row.z;
        const unsigned long long below = j ? all & (~0ull >> (64u - 4u * j)) : 0ull;
        *bitp = row.y + width_sum(below);
        *before = row.x + nibble_sum(below);
        return (unsigned)(all >> (4u * j)) & 15u;
    }
    // The pattern of pos's block, with pos's offset o in it and the rank
    // before the block
    __device__ __forceinline__ unsigned pattern_at(int pos, unsigned* o, int* before) const {
        const int blk = pos / 15;
        int bitp;
        const unsigned cls = block_in(meta[blk >> 4], (unsigned)blk & 15u, &bitp, before);
        *o = (unsigned)(pos - blk * 15);
        return Patterns::pattern(cls, offset_at(bitp, width15(cls)));
    }
    __device__ __forceinline__ int rank(int pos) const {
        unsigned o;
        int before;
        const unsigned pat = pattern_at(pos, &o, &before);
        return before + __popc(pat & ((1u << o) - 1u));
    }
    // pos + 1 shares pos's block: the width-(o + 1) mask at o = 14 covers
    // the whole pattern, whose popcount plus `before` is the next block's
    __device__ __forceinline__ int2 rank_pair(int pos) const {
        unsigned o;
        int before;
        const unsigned pat = pattern_at(pos, &o, &before);
        const unsigned m1 = (1u << o) - 1u;
        return make_int2(before + __popc(pat & m1), before + __popc(pat & ((m1 << 1) | 1u)));
    }
    __device__ __forceinline__ int get(int pos) const {
        unsigned o;
        int before;
        return (int)((pattern_at(pos, &o, &before) >> o) & 1u);
    }
    // The blocks that hold the bits, up to four: one class-sum pass over
    // pos's superblock gives the first block's offset pointer, and the
    // offsets of the blocks after it follow in the stream, so their loads
    // do not wait on each other.
    __device__ __forceinline__ unsigned bits(int pos, int len, int* r) const {
        const int blk = pos / 15;
        const unsigned o = (unsigned)(pos - blk * 15);
        int4 row = meta[blk >> 4];
        int bitp, before;
        unsigned cls = block_in(row, (unsigned)blk & 15u, &bitp, &before);
        const int nb = len > 0 ? ((int)o + len - 1) / 15 + 1 : 1;
        unsigned long long acc = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            if (t >= nb) break;
            const unsigned jb = (unsigned)(blk + t) & 15u;
            if (t > 0) {
                if (jb == 0u) {
                    row = meta[(blk + t) >> 4];
                    bitp = row.y;
                }
                cls = class_of(row, jb);
            }
            const unsigned w = width15(cls);
            acc |= (unsigned long long)Patterns::pattern(cls, offset_at(bitp, w)) << (15 * t);
            bitp += (int)w;
        }
        *r = before + __popc((unsigned)acc & ((1u << o) - 1u));
        return (unsigned)(acc >> o) & low_mask(len);
    }
};

struct RRR15 : RRR15Of<RegisterPatterns> {};
struct RRR15Staged : RRR15Of<StagedPatterns> {};

// ---------------------------------------------------------------------------
// Modified Elias-Fano (MEF.hpp:85-131, 376-389): buckets of 2^wl bits;
// upper marks the kept (non-empty) ones, lower holds them
// ---------------------------------------------------------------------------

struct MEF {
    PlainBV upper;
    PlainBV lower;
    int wl;

    // lower's position for pos, and whether pos's bucket is kept
    __device__ __forceinline__ int lower_pos(int pos, int* keep) const {
        const int u = upper.rank_get(pos >> wl, keep);
        return (u << wl) + (*keep ? (pos & ((1 << wl) - 1)) : 0);
    }
    __device__ __forceinline__ int rank(int pos) const {
        int keep;
        return lower.rank(lower_pos(pos, &keep));
    }
    // the bit at pos is lower's bit at lpos when the bucket is kept, else 0
    __device__ __forceinline__ int2 rank_pair(int pos) const {
        int keep;
        const int2 r = lower.rank_pair(lower_pos(pos, &keep));
        return make_int2(r.x, keep ? r.y : r.x);
    }
    __device__ __forceinline__ int get(int pos) const {
        int keep;
        const int lpos = lower_pos(pos, &keep);
        return keep ? lower.get(lpos) : 0;
    }
    // The kept buckets among those the bits touch are consecutive in lower
    // from lower_pos(pos): one run of lower's bits, spread back over the
    // touched buckets with zeros where a bucket is not kept.
    __device__ __forceinline__ unsigned bits(int pos, int len, int* r) const {
        const int bs = 1 << wl, o = pos & (bs - 1);
        const int nbk = len > 0 ? ((o + len - 1) >> wl) + 1 : 1;  // buckets touched, <= 32
        int u;
        const unsigned kept = upper.bits(pos >> wl, nbk, &u);
        int total = 0;
        for (int t = 0, done = 0; t < nbk; ++t) {
            const int seg = min(t == 0 ? bs - o : bs, len - done);
            if ((kept >> t) & 1u) total += seg;
            done += seg;
        }
        const unsigned run = lower.bits((u << wl) + ((kept & 1u) ? o : 0), total, r);
        unsigned v = 0;
        for (int t = 0, done = 0, src = 0; t < nbk; ++t) {
            const int seg = min(t == 0 ? bs - o : bs, len - done);
            if ((kept >> t) & 1u) {
                v |= ((src < 32 ? run >> src : 0u) & low_mask(seg)) << done;
                src += seg;
            }
            done += seg;
        }
        return v;
    }
};

}  // namespace sbwt
