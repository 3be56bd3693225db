// K2 succ1 as a template over the rank type R of subset_rank.cuh: the
// out-edges of columns, one thread per column, or, over all columns of a
// compressed rank type, by warp over whole-table spans (succ1_span_kernel),
// or, on the wide tier, one thread a column with the column's rows
// requested in one round (succ1_wide_kernel).
//
// Replaces the XLA programs of sbwt_tpu/ops/turbo.py _succ1 (:294) over a
// MatrixIndex or any variant's GenericIndex, and, for WideMatrix, K18c: the
// _chunk of build_turbo_wide (:209-221) with its chunked fori_loop fill
// and its split into low and high int32 tables, which exist because the
// TPU has no 64-bit lanes; here a successor is one pos_t. Given a list of
// columns it is sbwt_tpu/ops/search.py forward_batch (:136) for all four
// chars of each.
//
// Bound on the H100: the rank and suffix-group rows read (neighbouring
// threads read neighbouring rows, so each row is fetched once) and the
// 4 * B positions written. With row_major a thread writes its four
// successors side by side, [B, 4]: the arity-1 table of the wide tier as it
// is queried, with no transpose after it.
//
// Over all columns a compressed rank type's four rank pairs a column, each
// a chain of dependent loads from scratch (subset_rank.cuh), repeat almost
// all of the neighbouring column's work: the columns come in order, and
// the successor by c is C[c] + rank(c, s) with s = sg_start(col), a prefix
// count. So succ1_span_kernel gives a warp kSuccSpan consecutive columns,
// 32 a lane: each lane decodes its 32 columns' subsets (the rank type's
// subsets, one bits call a bit vector or tree node), four lanes take the
// span's four ranks at its start, and a warp prefix sum of the lanes'
// member counts gives each lane's ranks. Then the warp writes the span 32
// columns a step, each lane one column, every store coalesced: a column's
// rank by c is its step's rank plus the members below s in the step's word
// (or, where s lies in the step before, minus those from s on in that
// step's word); only where the span's first group began before the span do
// its columns take rank_pair.
#pragma once

#include "lf_stream.cuh"

namespace sbwt {

// Whether succ1 over all columns of R runs by span: the nine compressed
// types. PlainMatrix's one row a rank is within 2x of its bound one thread a
// column; the wide tier has its own kernel (SuccRound) and the sharded type
// stays as it is.
template <class R>
struct SuccSpan {
    static constexpr bool value = false;
};
template <class BV>
struct SuccSpan<MatrixRank<BV>> {
    static constexpr bool value = true;
};
template <class XBV>
struct SuccSpan<SplitRank<XBV>> {
    static constexpr bool value = true;
};
template <class BV>
struct SuccSpan<ConcatRank<BV>> {
    static constexpr bool value = true;
};
template <class BV>
struct SuccSpan<SubsetWTRank<BV>> {
    static constexpr bool value = true;
};

// Whether succ1 of R loads a column's rows in one round
// (succ1_wide_kernel): the wide tier, whose columns in the giant's use are
// random over a 6.4 GB table, so that each load is a trip to device memory.
template <class R>
struct SuccRound {
    static constexpr bool value = false;
};
template <>
struct SuccRound<WideMatrix> {
    static constexpr bool value = true;
};

// Launch shape, by a sweep on an H100 (tools/succ_ab.py; PERF.md): 16
// warps a block beat 4, 8 and 32 on every type; two spans a warp, one
// after the other, lost on the RRR-based trees.
constexpr int kSuccWarps = 16;   // warps a block of succ1_span_kernel
constexpr int kSuccSpan = 1024;  // columns a warp: 32 steps of 32

// out[c, i] (or out[i, c]) = successor of column i's suffix group by c, or -1.
template <class R>
__global__ void succ1_kernel(R rk, LFArgs a) {
    using P = typename R::pos_t;
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.B) return;
    const CArray<P> Cl(a.C);
    const P col = a.aux != nullptr ? static_cast<const P*>(a.aux)[i] : (P)i;
    const P s = sg_start_r(rk, a.sgs_tbl, col);
    P* out = static_cast<P*>(a.out);
    for (int c = 0; c < 4; ++c) {
        const auto q = rk.rank_pair(c, s);
        const P succ = q.y > q.x ? Cl[c] + q.x : (P)-1;
        out[a.row_major ? i * 4 + c : (int64_t)c * a.B + i] = succ;
    }
}

// succ1 over all columns 0..B-1 (aux == nullptr) of a compressed rank type,
// a warp a span of kSuccSpan columns.
template <class R>
__global__ void __launch_bounds__(kSuccWarps * 32) succ1_span_kernel(R rk, LFArgs a) {
    constexpr unsigned kAll = 0xFFFFFFFFu;
    const int lane = threadIdx.x & 31;
    const int64_t span0 = ((int64_t)blockIdx.x * kSuccWarps + (threadIdx.x >> 5)) * kSuccSpan;
    if (span0 >= a.B) return;  // the whole warp
    const int n = (int)a.B, p0 = (int)span0;
    const int mine = p0 + 32 * lane;  // the lane's 32 columns
    const int len = max(0, min(32, n - mine));
    unsigned w[4] = {0u, 0u, 0u, 0u};
    int2 sg = make_int2(0, 0);
    if (len > 0) {
        sg = sg_row(rk, a.sgs_tbl, mine >> 5);
        rk.subsets(mine, len, w);
    }
    const int r_lane = lane < 4 ? rk.rank(lane, p0) : 0;
    int base[4];  // rank of each char at the lane's first column
#pragma unroll
    for (int c = 0; c < 4; ++c) {
        const int cnt = __popc(w[c]);
        int incl = cnt;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const int t = __shfl_up_sync(kAll, incl, d);
            if (lane >= d) incl += t;
        }
        base[c] = __shfl_sync(kAll, r_lane, c) + incl - cnt;
    }
    const CArray<int> Cl(a.C);
    int* out = static_cast<int*>(a.out);
    const int steps = min(32, (n - p0 + 31) / 32);
    for (int k = 0; k < steps; ++k) {
        const int step0 = p0 + 32 * k, col = step0 + lane;
        const int2 row = make_int2(__shfl_sync(kAll, sg.x, k), __shfl_sync(kAll, sg.y, k));
        const int d = (col < n ? sg_start_in(row, col) : col) - step0;  // -3 .. 31
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const unsigned wk = __shfl_sync(kAll, w[c], k);
            const unsigned wp = __shfl_sync(kAll, w[c], (k + 31) & 31);
            const int bk = __shfl_sync(kAll, base[c], k);
            int r, bit;
            if (d >= 0) {
                r = bk + __popc(wk & ((1u << d) - 1u));
                bit = (int)((wk >> d) & 1u);
            } else if (k > 0) {  // the group began in the step before
                const unsigned h = wp >> (32 + d);
                r = bk - __popc(h);
                bit = (int)(h & 1u);
            } else {  // ... before the span
                const int2 q = rk.rank_pair(c, step0 + d);
                r = q.x;
                bit = q.y > q.x;
            }
            if (col < n) out[a.row_major ? (int64_t)col * 4 + c : (int64_t)c * n + col] = bit ? Cl[c] + r : -1;
        }
    }
}

// Row r of the wide rank table as (bits word, cum). A row is 12 bytes:
// three 4-byte loads beat one aligned 8-byte and one 4-byte load, which
// needs the row's parity to pick the pair (tools/succ_ab.py; PERF.md).
struct WideRow {
    unsigned word;
    int64_t cum;
};

__device__ __forceinline__ WideRow wide_row(const int* __restrict__ tbl, int64_t r) {
    const int* row = tbl + 3 * r;
    return WideRow{(unsigned)row[0], ((int64_t)row[2] << 32) | (unsigned)row[1]};
}

// succ1 of the wide tier, one thread a column. A column's suffix group
// starts within 3 columns before it, so almost always in the column's own
// word w: the suffix-group row and the four rank rows of word w are
// requested together, in one round of loads (succ1_kernel waits for the
// suffix-group row before it asks for any rank row). Where the group began
// in word w - 1 (col & 31 < 3 only), rank(s) is word w's cum less the bits
// of word w - 1 from s on, so only those four words are loaded again.
// Padding lanes read column 0 and store nothing. Two and four columns a
// thread, to keep more loads in flight, were slower on an H100.
template <class R>
__global__ void __launch_bounds__(kBlock) succ1_wide_kernel(R rk, LFArgs a) {
    static_assert(SuccRound<R>::value, "succ1_wide_kernel reads WideMatrix rows");
    const int64_t i = (int64_t)blockIdx.x * kBlock + threadIdx.x;
    const int64_t col =
        i >= a.B ? 0 : (a.aux != nullptr ? static_cast<const int64_t*>(a.aux)[i] : i);
    const int64_t w = col >> 5;
    const int2 sg = sg_row(rk, a.sgs_tbl, w);
    WideRow row[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) row[c] = wide_row(rk.rank_tbl, c * rk.n_words + w);
    const int64_t s = sg_start_in(sg, col);
    const unsigned o = (unsigned)s & 31u;
    const CArray<int64_t> Cl(a.C);
    int64_t succ[4];
    if ((s >> 5) == w) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const unsigned word = row[c].word;
            succ[c] = (word >> o) & 1u ? Cl[c] + row[c].cum + __popc(word & ((1u << o) - 1u))
                                       : (int64_t)-1;
        }
    } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const unsigned h = (unsigned)rk.rank_tbl[3 * (c * rk.n_words + w - 1)] >> o;
            succ[c] = h & 1u ? Cl[c] + row[c].cum - __popc(h) : (int64_t)-1;
        }
    }
    if (i >= a.B) return;
    int64_t* out = static_cast<int64_t*>(a.out);
    if (a.row_major) {
        longlong2* dst = reinterpret_cast<longlong2*>(out + i * 4);
        dst[0] = make_longlong2(succ[0], succ[1]);
        dst[1] = make_longlong2(succ[2], succ[3]);
    } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) out[c * a.B + i] = succ[c];
    }
}

// forward (SBWT.hh:369-381) of a list of columns by one char each:
// out[i] = the successor of column aux[i] by char codes[i] & 3, or -1. One
// rank pair a lane (successor, lf_stream.cuh), where succ1 over the same
// columns takes four.
template <class R>
__global__ void forward_kernel(R rk, LFArgs a) {
    using P = typename R::pos_t;
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.B) return;
    const CArray<P> Cl(a.C);
    static_cast<P*>(a.out)[i] =
        successor(rk, a.sgs_tbl, Cl, static_cast<const P*>(a.aux)[i], a.codes[i] & 3);
}

}  // namespace sbwt
