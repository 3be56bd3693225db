// Device helpers shared by the SBWT kernels: the fused (word, cum) rank
// row, the suffix-group left walk, the position types of the two tiers and
// one row of an arity-A successor table.
//
// Layouts are those of the JAX package (sbwt_tpu/models/matrix.py):
//   rank_tbl int2 [4 * n_words]: (bits word, exclusive cum popcount), char-major
//   sgs_tbl  int2 [n_words]:     (suffix-group-start word w, word w - 1)
//   C        pos  [4]:           cumulative char counts, C[0] = 1
// A position (a column, an interval bound, an answer) is int32 on the
// narrow tier (n < 2^31 columns) and int64 on the wide tier
// (sbwt_tpu/models/wide.py); every rank type names its own as pos_t. Row
// addresses are formed in 64 bits on both.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sbwt {

constexpr int kBlock = 256;

__host__ __device__ __forceinline__ unsigned grid_for(int64_t n) {
    return (unsigned)((n + kBlock - 1) / kBlock);
}

__device__ __forceinline__ bool is_base(int c) { return (unsigned)c < 4u; }

// Two positions as one value: an interval (l, r), a precalc row, or
// (rank(pos), rank(pos + 1)).
template <class P>
struct pair_of;
template <>
struct pair_of<int> {
    using type = int2;
};
template <>
struct pair_of<int64_t> {
    using type = longlong2;
};
template <class P>
using pair_t = typename pair_of<P>::type;

template <class P>
__device__ __forceinline__ pair_t<P> make_pair_of(P x, P y) {
    pair_t<P> v;
    v.x = x;
    v.y = y;
    return v;
}

// (rank of pos within its row, bit at pos) of one (word, cum) row.
__device__ __forceinline__ int rank_in_row(int2 row, int pos, int* bit) {
    const unsigned o = (unsigned)pos & 31u;
    *bit = (int)(((unsigned)row.x >> o) & 1u);
    return row.y + __popc((unsigned)row.x & ((1u << o) - 1u));
}

// Number of c bits in columns 0..pos-1: one 8-byte row and a masked popcount.
__device__ __forceinline__ int rank_c(const int2* __restrict__ rank_tbl,
                                      int64_t n_words, int c, int pos) {
    const int2 row = rank_tbl[(int64_t)c * n_words + (pos >> 5)];
    const unsigned o = (unsigned)pos & 31u;
    return row.y + __popc((unsigned)row.x & ((1u << o) - 1u));
}

// (rank_c(c, pos), bit c at pos) from the same row.
__device__ __forceinline__ int extend_rank(const int2* __restrict__ rank_tbl,
                                           int64_t n_words, int c, int pos,
                                           int* bit) {
    return rank_in_row(rank_tbl[(int64_t)c * n_words + (pos >> 5)], pos, bit);
}

// Greatest marked column <= col (SBWT.hh:563), from row col >> 5 of the
// suffix-group table. A suffix group has at most four columns, so the mark
// is within 3 and inside the (w, w - 1) pair: seen as one 64-bit window,
// bit o of word w is window bit 32 + o.
template <class P>
__device__ __forceinline__ P sg_start_in(int2 row, P col) {
    const uint64_t win = ((uint64_t)(unsigned)row.x << 32) | (unsigned)row.y;
    const int j = 32 + (int)(col & 31);
    for (int d = 0; d < 3; ++d) {
        if ((win >> (j - d)) & 1u) return col - d;
    }
    return col - 3;
}

// A table cut into row shards, one pointer each, passed by value: the
// widest model axis of a mesh (sbwt_tpu_torch/parallel/sharded.py). Shard s
// is picked by selects over the unrolled list, so the kernel reads the
// pointers from its parameters and never indexes them dynamically.
constexpr int kMaxShards = 8;

template <class T>
__device__ __forceinline__ const T* shard_ptr(const T* const (&shard)[kMaxShards], int s) {
    const T* t = shard[0];
#pragma unroll
    for (int i = 1; i < kMaxShards; ++i) {
        if (s == i) t = shard[i];
    }
    return t;
}

// Successors after 1, 2 and 3 chars, as one table row gives them.
template <class P>
struct Succ3 {
    P x, y, z;
};

template <class P>
__device__ __forceinline__ P component(const Succ3<P>& v, int j) {
    return j == 0 ? v.x : (j == 1 ? v.y : v.z);
}

// Successor columns after 1..take chars from col (take <= arity), read
// from one row of the arity-A table (sbwt_tpu/ops/turbo.py _step). Chars
// are used & 3; the caller decides their validity. The result holds the
// answer after j + 1 chars in component j, with -1 propagated.
//   arity 1, narrow: int4 [n]          row col, selected by the char
//   arity 1, wide:   longlong2 [n * 2] row col is two halves; the char
//                                      picks the half, then the entry
//   arity 2: int2 [n * 16]  row col * 16 + c1 * 4 + c2: (s1, s2)
//   arity 3: int4 [n * 64]  row col * 64 + c1 * 16 + c2 * 4 + c3: (s1, s2, s3, 0)
// The wide tier has arity 1 only (sbwt_tpu/ops/turbo.py:406-409).
template <class P>
__device__ __forceinline__ Succ3<P> table_row(const void* __restrict__ tbl, int arity, P col,
                                              const int8_t* chars, int take) {
    if constexpr (sizeof(P) == 8) {
        const int c = chars[0] & 3;
        const longlong2 half = static_cast<const longlong2*>(tbl)[col * 2 + (c >> 1)];
        return Succ3<P>{(c & 1) ? half.y : half.x, -1, -1};
    } else {
        if (arity == 1) {
            const int4 row = static_cast<const int4*>(tbl)[col];
            const int c = chars[0] & 3;
            return Succ3<P>{c == 0 ? row.x : (c == 1 ? row.y : (c == 2 ? row.z : row.w)), -1, -1};
        }
        int sub = 0;
        for (int j = 0; j < arity; ++j) sub = sub * 4 + (j < take ? (chars[j] & 3) : 0);
        if (arity == 2) {
            const int2 row = static_cast<const int2*>(tbl)[(int64_t)col * 16 + sub];
            return Succ3<P>{row.x, row.y, -1};
        }
        const int4 row = static_cast<const int4*>(tbl)[(int64_t)col * 64 + sub];
        return Succ3<P>{row.x, row.y, row.z};
    }
}

}  // namespace sbwt
