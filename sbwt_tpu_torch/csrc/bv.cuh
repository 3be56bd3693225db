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
// RRR rank is a 16-byte superblock row, then two words of the offset
// stream, then one load from the 128 KB pattern LUT (left in global
// memory, where L2 holds it); MEF is two plain ranks in a row. rank_pair
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
//   lut  int [2^15]: base[class] + offset -> 15-bit pattern
// ---------------------------------------------------------------------------

// offset width of each class, ceil(log2 C(15, c)), as nibbles: classes
// 0-7 in the low constant, 8-15 in the high one (sbwt_tpu_torch/ops/bv.py
// W15LO / W15HI, checked by the tests)
constexpr unsigned kW15Lo = 0xDDCB9740u;
constexpr unsigned kW15Hi = 0x0479BCDDu;

__device__ __forceinline__ unsigned width15(unsigned cls) {
    return ((cls < 8u ? kW15Lo : kW15Hi) >> (4u * (cls & 7u))) & 15u;
}

struct RRR15 {
    const int4* meta;
    const unsigned* offs;
    const int* lut;
    const int* base;

    // The pattern of pos's block, with pos's offset o in it and the rank
    // before the block.
    __device__ __forceinline__ unsigned pattern_at(int pos, unsigned* o, int* before) const {
        const int blk = pos / 15;
        const int4 row = meta[blk >> 4];
        const unsigned j = (unsigned)blk & 15u;
        int cls_sum = 0, w_sum = 0;
        unsigned mine = 0;
#pragma unroll
        for (unsigned t = 0; t < 16u; ++t) {
            const unsigned cls = ((t < 8u ? (unsigned)row.z : (unsigned)row.w) >> (4u * (t & 7u))) & 15u;
            if (t < j) {
                cls_sum += (int)cls;
                w_sum += (int)width15(cls);
            }
            if (t == j) mine = cls;
        }
        const int bitp = row.y + w_sum;
        const unsigned sh = (unsigned)bitp & 31u;
        const unsigned s0 = offs[bitp >> 5];
        const unsigned s1 = offs[(bitp >> 5) + 1];
        // a shift by 32 is undefined: sh == 0 takes s0 alone (bv.py:313)
        const unsigned raw = (s0 >> sh) | (sh ? s1 << (32u - sh) : 0u);
        const unsigned off = raw & ((1u << width15(mine)) - 1u);
        *o = (unsigned)(pos - blk * 15);
        *before = row.x + cls_sum;
        return (unsigned)lut[base[mine] + (int)off];
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
        const int before = row.x;
        const unsigned j = (unsigned)blk & 15u;
        int cls_sum = 0, bitp = row.y;
#pragma unroll
        for (unsigned t = 0; t < 16u; ++t) {
            const unsigned cls = class_of(row, t);
            if (t < j) {
                cls_sum += (int)cls;
                bitp += (int)width15(cls);
            }
        }
        const int nb = len > 0 ? ((int)o + len - 1) / 15 + 1 : 1;
        unsigned long long acc = 0;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            if (t >= nb) break;
            const unsigned jb = (unsigned)(blk + t) & 15u;
            if (t > 0 && jb == 0u) {
                row = meta[(blk + t) >> 4];
                bitp = row.y;
            }
            const unsigned cls = class_of(row, jb);
            const unsigned sh = (unsigned)bitp & 31u;
            const unsigned s0 = offs[bitp >> 5];
            const unsigned s1 = offs[(bitp >> 5) + 1];
            const unsigned raw = (s0 >> sh) | (sh ? s1 << (32u - sh) : 0u);
            const unsigned off = raw & ((1u << width15(cls)) - 1u);
            acc |= (unsigned long long)(unsigned)lut[base[cls] + (int)off] << (15 * t);
            bitp += (int)width15(cls);
        }
        *r = before + cls_sum + __popc((unsigned)acc & ((1u << o) - 1u));
        return (unsigned)(acc >> o) & low_mask(len);
    }
    __device__ __forceinline__ static unsigned class_of(const int4& row, unsigned t) {
        return ((t < 8u ? (unsigned)row.z : (unsigned)row.w) >> (4u * (t & 7u))) & 15u;
    }
};

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
