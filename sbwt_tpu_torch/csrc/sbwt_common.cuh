// Device helpers shared by the SBWT kernels: the fused (word, cum) rank
// row, the suffix-group left walk, one LF interval step and one row of an
// arity-A successor table.
//
// Layouts are those of the JAX package (sbwt_tpu/models/matrix.py):
//   rank_tbl int2 [4 * n_words]: (bits word, exclusive cum popcount), char-major
//   sgs_tbl  int2 [n_words]:     (suffix-group-start word w, word w - 1)
//   C        int  [4]:           cumulative char counts, C[0] = 1
// Positions are int32 (the narrow engine: n < 2^31 columns); row addresses
// are formed in 64 bits.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace sbwt {

constexpr int kBlock = 256;

__host__ __device__ __forceinline__ unsigned grid_for(int64_t n) {
    return (unsigned)((n + kBlock - 1) / kBlock);
}

__device__ __forceinline__ bool is_base(int c) { return (unsigned)c < 4u; }

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
    const int2 row = rank_tbl[(int64_t)c * n_words + (pos >> 5)];
    const unsigned o = (unsigned)pos & 31u;
    *bit = (int)(((unsigned)row.x >> o) & 1u);
    return row.y + __popc((unsigned)row.x & ((1u << o) - 1u));
}

// Greatest marked column <= col (SBWT.hh:563). A suffix group has at most
// four columns, so the mark is within 3 and inside the (w, w - 1) pair:
// seen as one 64-bit window, bit o of word w is window bit 32 + o.
__device__ __forceinline__ int sg_start(const int2* __restrict__ sgs_tbl, int col) {
    const int2 row = sgs_tbl[col >> 5];
    const uint64_t win = ((uint64_t)(unsigned)row.x << 32) | (unsigned)row.y;
    const int j = 32 + (col & 31);
    for (int d = 0; d < 3; ++d) {
        if ((win >> (j - d)) & 1u) return col - d;
    }
    return col - 3;
}

// Out-edge c of col's suffix group: its successor column, or -1.
__device__ __forceinline__ int successor(const int2* __restrict__ rank_tbl,
                                         int64_t n_words,
                                         const int2* __restrict__ sgs_tbl,
                                         const int* Cl, int col, int c) {
    int bit;
    const int r = extend_rank(rank_tbl, n_words, c, sg_start(sgs_tbl, col), &bit);
    return bit ? Cl[c] + r : -1;
}

// One LF step of [l, r] by char c (SBWT.hh:430-433). Returns false, and
// leaves (l, r) as they were, when the interval empties.
__device__ __forceinline__ bool lf_step(const int2* __restrict__ rank_tbl,
                                        int64_t n_words, const int* Cl, int c,
                                        int& l, int& r) {
    const int l2 = Cl[c] + rank_c(rank_tbl, n_words, c, l);
    const int r2 = Cl[c] + rank_c(rank_tbl, n_words, c, r + 1) - 1;
    if (l2 > r2) return false;
    l = l2;
    r = r2;
    return true;
}

__device__ __forceinline__ int component(int4 v, int j) {
    return j == 0 ? v.x : (j == 1 ? v.y : (j == 2 ? v.z : v.w));
}

// Successor columns after 1..take chars from col (take <= arity), read
// from one row of the arity-A table (sbwt_tpu/ops/turbo.py _step). Chars
// are used & 3; the caller decides their validity. The result holds the
// answer after j + 1 chars in component j, with -1 propagated.
//   arity 1: int4 [n]       row col, selected by the char
//   arity 2: int2 [n * 16]  row col * 16 + c1 * 4 + c2: (s1, s2)
//   arity 3: int4 [n * 64]  row col * 64 + c1 * 16 + c2 * 4 + c3: (s1, s2, s3, 0)
__device__ __forceinline__ int4 table_row(const int* __restrict__ tbl, int arity,
                                          int col, const int8_t* chars, int take) {
    if (arity == 1) {
        const int4 row = reinterpret_cast<const int4*>(tbl)[col];
        return make_int4(component(row, chars[0] & 3), -1, -1, -1);
    }
    int sub = 0;
    for (int j = 0; j < arity; ++j) sub = sub * 4 + (j < take ? (chars[j] & 3) : 0);
    if (arity == 2) {
        const int2 row =
            reinterpret_cast<const int2*>(tbl)[(int64_t)col * 16 + sub];
        return make_int4(row.x, row.y, -1, -1);
    }
    return reinterpret_cast<const int4*>(tbl)[(int64_t)col * 64 + sub];
}

}  // namespace sbwt
