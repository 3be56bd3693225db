// K17: subset rank of the ten variants on the device, K18a, the
// plain-matrix rank of the wide (int64) tier, and K20a, the plain-matrix
// rank over row shards (ShardedMatrix). Each type has
//   pos_t              the type of a position: int, or int64_t for WideMatrix
//   rank(c, pos)       count of char c in subsets 0..pos-1, pos in [0, n]
//   rank_pair(c, pos)  (rank(c, pos), rank(c, pos + 1)), pos in [0, n)
//   subsets(pos, len, w)  (the nine compressed types) bit j of w[c] is
//                      whether char c is in column pos + j's subset, for j
//                      < len (len in 1..32), the other bits zero: succ1's
//                      whole-table decode (succ_table.cuh), a run of
//                      columns from one bits call a bit vector or tree node
// and is a plain descriptor passed to a kernel by value (mirrored in
// Python by sbwt_tpu_torch/kernels). Chars are 0..3. An interval's two
// ranks come from the free function rank_interval(rk, c, i, j). The kernels read a
// suffix-group row through sg_row(rk, sgs_tbl, w): the flat table of the
// launch's arguments, unless the rank type holds its own (ShardedMatrix).
//
// Replaces the XLA code of sbwt_tpu/models/subsetrank.py: MatrixRank
// (:92-104), SplitRank (:179-203), ConcatRank with _select0 /
// _select0_pair (:309-391) and SubsetWTRank with the _wt4_* helpers
// (:504-631); PlainMatrix is the fused-row rank of
// sbwt_tpu/models/matrix.py:40-86 (sbwt_common.cuh), and WideMatrix the
// rank_c / extend_rank of sbwt_tpu/models/wide.py:60-86.
//
// Bound on the H100: the dependent loads of the bit-vector ranks inside
// (bv.cuh, wavelet.cuh): one for PlainMatrix, one for MatrixRank, X then
// Y's two levels and Z for SplitRank, a sample and a window row then three
// levels for ConcatRank, and up to six for SubsetWTRank. rank_pair shares
// every load between the two positions; ConcatRank's two set starts, up to
// 4 symbols apart, share one walk of the tree (WaveletTree::rank_span).
//
// ConcatRank's select0 takes the window's high word as z1 >> o for every
// o. The JAX package zeroes it when o == 0 (subsetrank.py:321, :363),
// which loses the ninth zero of a fully dense window (ROADMAP Queue 3,
// F1); it is not ported.
#pragma once

#include <cstring>

#include "sbwt_common.cuh"
#include "wavelet.cuh"

namespace sbwt {

__device__ __forceinline__ int pick4(const int (&a)[5], int c) {
    return c == 0 ? a[0] : (c == 1 ? a[1] : (c == 2 ? a[2] : a[3]));
}

// Row w of the suffix-group table (sbwt_common.cuh sg_start_in)
template <class R>
__device__ __forceinline__ int2 sg_row(const R&, const int2* __restrict__ sgs_tbl, int64_t w) {
    return sgs_tbl[w];
}

// plain-matrix: the fused (word, cum) rows of sbwt_common.cuh
struct PlainMatrix {
    using pos_t = int;
    const int2* rank_tbl;
    long long n_words;

    __device__ __forceinline__ int rank(int c, int pos) const {
        return rank_c(rank_tbl, n_words, c, pos);
    }
    __device__ __forceinline__ int2 rank_pair(int c, int pos) const {
        int bit;
        const int r = extend_rank(rank_tbl, n_words, c, pos, &bit);
        return make_int2(r, r + bit);
    }
};

// The plain-matrix rows of the wide tier, int32 [4 * n_words, 3]: (bits
// word, low and high half of the exclusive cum popcount). The JAX layout is
// kept, so a row is 12 bytes, not 16-byte aligned, and is read as three
// 4-byte loads. The low half is unsigned: sign-extending it would corrupt
// every count whose bit 31 is set.
struct WideMatrix {
    using pos_t = int64_t;
    const int* rank_tbl;
    long long n_words;

    __device__ __forceinline__ int64_t rank_get(int c, int64_t pos, int* bit) const {
        const int* row = rank_tbl + 3 * ((int64_t)c * n_words + (pos >> 5));
        const unsigned word = (unsigned)row[0];
        const int64_t cum = ((int64_t)row[2] << 32) | (int64_t)(unsigned)row[1];
        const unsigned o = (unsigned)pos & 31u;
        *bit = (int)((word >> o) & 1u);
        return cum + __popc(word & ((1u << o) - 1u));
    }
    __device__ __forceinline__ int64_t rank(int c, int64_t pos) const {
        int bit;
        return rank_get(c, pos, &bit);
    }
    // rank(pos + 1) = rank(pos) + bit(pos), also at o = 31, where pos + 1
    // lies in the next word
    __device__ __forceinline__ longlong2 rank_pair(int c, int64_t pos) const {
        int bit;
        const int64_t r = rank_get(c, pos, &bit);
        return make_longlong2(r, r + bit);
    }
};

// rrr-matrix, mef-matrix: one bit vector over the rows [A | C | G | T]
template <class BV>
struct MatrixRank {
    using pos_t = int;
    BV bv;
    int n;
    int base[5];  // rank at the start of each char's row

    __device__ __forceinline__ int rank(int c, int pos) const {
        return bv.rank(c * n + pos) - pick4(base, c);
    }
    __device__ __forceinline__ int2 rank_pair(int c, int pos) const {
        const int2 r = bv.rank_pair(c * n + pos);
        const int b = pick4(base, c);
        return make_int2(r.x - b, r.y - b);
    }
    __device__ __forceinline__ void subsets(int pos, int len, unsigned (&w)[4]) const {
        int r;
#pragma unroll
        for (int c = 0; c < 4; ++c) w[c] = bv.bits(c * n + pos, len, &r);
    }
};

// plain-split, rrr-split, mef-split: X marks columns with != 1 out-edge;
// Y (plain, sigma 4) holds the unary columns' labels, Z (plain) the other
// columns' rows, char-major over n_b columns
template <class XBV>
struct SplitRank {
    using pos_t = int;
    XBV X;
    WaveletTree<PlainBV> Y;
    PlainBV Z;
    int n_b;
    int z_base[5];

    __device__ __forceinline__ int rank(int c, int pos) const {
        const int xr = X.rank(pos);
        return Y.rank(c, pos - xr) + Z.rank(c * n_b + xr) - pick4(z_base, c);
    }
    // X's bit at pos routes the +1 into exactly one of Y or Z
    __device__ __forceinline__ int2 rank_pair(int c, int pos) const {
        const int2 x = X.rank_pair(pos);
        const int2 y = Y.rank_pair(c, pos - x.x);
        const int2 z = Z.rank_pair(c * n_b + x.x);
        const int zb = pick4(z_base, c);
        return make_int2(y.x + z.x - zb, (x.y > x.x ? y.x + z.y : y.y + z.x) - zb);
    }
    // X's bits split the run: its set bits take Z's run from rank xr, the
    // others Y's symbols from pos - xr
    __device__ __forceinline__ void subsets(int pos, int len, unsigned (&w)[4]) const {
        int xr;
        const unsigned xw = X.bits(pos, len, &xr);
        const int nx = __popc(xw), ny = len - nx;
        const unsigned yw = ~xw & low_mask(len);
        const Planes4 y = planes4(tree4(Y), pos - xr, ny);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            int r;
            const unsigned z = Z.bits(c * n_b + xr, nx, &r);
            const unsigned eq = ((c & 2) ? y.hi : ~y.hi) & ((c & 1) ? y.lo : ~y.lo) & low_mask(ny);
            w[c] = deposit(z, xw) | deposit(eq, yw);
        }
    }
};

// 0-based index of the n-th (1-based) set bit of w, n <= popcount(w)
__device__ __forceinline__ int nth_set_bit(unsigned w, int n) {
    int base = 0;
#pragma unroll
    for (int shift = 16; shift >= 1; shift >>= 1) {
        const unsigned low = w & ((1u << shift) - 1u);
        const int cnt = __popc(low);
        if (cnt < n) {
            w >>= shift;
            n -= cnt;
            base += shift;
        } else {
            w = low;
        }
    }
    return base;
}

// plain-concat, mef-concat: set members over {$, A, C, G, T} in a sigma-5
// tree; the zeros of L mark set starts (and the end)
template <class BV>
struct ConcatRank {
    using pos_t = int;
    WaveletTree<BV> wt;
    const int2* l_words;  // (L word w, L word w + 1)
    const int* samples;   // position of every 8th zero of L

    // The 64 zero-mask bits of L from the sample below zero i, as (lo, hi),
    // with the sample's position s and i's rank among its 8 zeros.
    __device__ __forceinline__ void window(int i, int* s, int* rem, unsigned* lo,
                                           unsigned* hi) const {
        *s = samples[i >> 3];
        *rem = i & 7;
        const int2 row = l_words[*s >> 5];
        const unsigned o = (unsigned)*s & 31u;
        const unsigned z0 = ~(unsigned)row.x, z1 = ~(unsigned)row.y;
        *lo = (z0 >> o) | (o ? z1 << (32u - o) : 0u);
        *hi = z1 >> o;
    }
    __device__ __forceinline__ static int select_in(int s, unsigned lo, unsigned hi, int target) {
        const int cnt_lo = __popc(lo);
        return cnt_lo < target ? s + 32 + nth_set_bit(hi, target - cnt_lo)
                               : s + nth_set_bit(lo, target);
    }
    __device__ __forceinline__ int rank(int c, int pos) const {
        int s, rem;
        unsigned lo, hi;
        window(pos, &s, &rem, &lo, &hi);
        return wt.rank(c + 1, select_in(s, lo, hi, rem + 1));
    }
    // zeros pos and pos + 1 come from one window: sets hold <= 4 symbols,
    // so they lie within 33 bits of the sample, at most 4 apart, and one
    // walk of the tree ranks both (rank_span)
    __device__ __forceinline__ int2 rank_pair(int c, int pos) const {
        int s, rem;
        unsigned lo, hi;
        window(pos, &s, &rem, &lo, &hi);
        const int x = select_in(s, lo, hi, rem + 1);
        return wt.rank_span(c + 1, x, select_in(s, lo, hi, rem + 2) - x);
    }
    // From the start of column pos's set (a select), 32 symbols at a time:
    // L's zeros in the chunk mark the sets, the tree's symbols in it
    // (planes5) the members; up to the start of the set after the run's
    // last, which no chunk passes (sets hold <= 4 symbols: <= 5 chunks)
    __device__ __forceinline__ void subsets(int pos, int len, unsigned (&w)[4]) const {
        int s, rem;
        unsigned lo, hi;
        window(pos, &s, &rem, &lo, &hi);
        int x = select_in(s, lo, hi, rem + 1);
        w[0] = w[1] = w[2] = w[3] = 0u;
        for (int seen = 0;;) {  // seen: sets started before the chunk
            const int2 row = l_words[x >> 5];
            const unsigned zm = ~__funnelshift_r((unsigned)row.x, (unsigned)row.y, (unsigned)x & 31u);
            const int cz = __popc(zm), need = len + 1 - seen;
            const int m = cz >= need ? nth_set_bit(zm, need) : 32;  // symbols of the run here
            if (m > 0) {
                unsigned e[4];
                planes5(wt, x, m, e);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    for (unsigned v = e[c]; v; v &= v - 1u) {
                        const int b = __ffs(v) - 1;
                        w[c] |= 1u << (seen + __popc(zm & low_mask(b + 1)) - 1);
                    }
                }
            }
            if (cz >= need) break;
            seen += cz;
            x += 32;
        }
    }
};

// plain-subsetwt, rrr-subsetwt (SubsetWT.hh:41-113): acgt over
// 2 * (A or C) + (G or T); ac over 2 * A + C of the AC-present columns;
// gt over 2 * G + T of the GT-present columns.
template <class BV>
struct SubsetWTRank {
    using pos_t = int;
    WaveletTree<BV> acgt, ac, gt;

    using Tree4 = sbwt::Tree4<BV>;  // wavelet.cuh

    // (count of symbol 1, count of symbol 3) before pos, given level 0's
    // rank r at pos
    __device__ __forceinline__ static int2 pair_rank(const Tree4& t, int pos, int r) {
        return make_int2(t.l1.rank(t.base_l + (pos - r)) - t.rank_l,
                         t.l1.rank(t.base_r + r) - t.rank_r);
    }
    // pair_rank at p and at p + padv (padv in {0, 1}), given level 0's
    // ranks r at p and r + radv at p + padv: (c1, c3, c1', c3')
    __device__ __forceinline__ static int4 pair_rank_pair(const Tree4& t, int p, int padv, int r,
                                                          int radv) {
        const int2 a = t.l1.rank_pair(t.base_l + (p - r));
        const int2 b = t.l1.rank_pair(t.base_r + r);
        return make_int4(a.x - t.rank_l, b.x - t.rank_r,
                         (padv - radv == 1 ? a.y : a.x) - t.rank_l,
                         (radv == 1 ? b.y : b.x) - t.rank_r);
    }

    __device__ __forceinline__ int rank(int c, int pos) const {
        const Tree4 root = tree4(acgt);
        const int r = root.l0.rank(pos);
        int x = r;
        if (c >= 2) {
            const int2 q = pair_rank(root, pos, r);
            x = q.x + q.y;
        }
        const Tree4 t = c < 2 ? tree4(ac) : tree4(gt);
        const int r0 = t.l0.rank(x);
        if ((c & 1) == 0) return r0;  // A or G: level 0 of its tree
        const int2 q = pair_rank(t, x, r0);
        return q.x + q.y;
    }

    __device__ __forceinline__ int2 rank_pair(int c, int pos) const {
        const Tree4 root = tree4(acgt);
        const int2 r = root.l0.rank_pair(pos);
        int x = r.x, xq = r.y;
        if (c >= 2) {
            const int4 q = pair_rank_pair(root, pos, 1, r.x, r.y - r.x);
            x = q.x + q.y;
            xq = q.z + q.w;
        }
        const int xadv = xq - x;
        const Tree4 t = c < 2 ? tree4(ac) : tree4(gt);
        const int2 t0 = t.l0.rank_pair(x);
        const int t_rq = xadv == 1 ? t0.y : t0.x;
        if ((c & 1) == 0) return make_int2(t0.x, t_rq);
        const int4 q = pair_rank_pair(t, x, xadv, t0.x, t_rq - t0.x);
        return make_int2(q.x + q.y, q.z + q.w);
    }
    // acgt's planes are the AC- and GT-present marks of the run; each marks
    // a run of the ac or gt tree, from the count of its marks before pos,
    // whose planes are A and C, or G and T
    __device__ __forceinline__ void subsets(int pos, int len, unsigned (&w)[4]) const {
        const Planes4 root = planes4(tree4(acgt), pos, len);
        const Planes4 a = planes4(tree4(ac), root.r0, __popc(root.hi));
        const Planes4 g = planes4(tree4(gt), root.c1 + root.c3, __popc(root.lo));
        w[0] = deposit(a.hi, root.hi);
        w[1] = deposit(a.lo, root.hi);
        w[2] = deposit(g.hi, root.lo);
        w[3] = deposit(g.lo, root.lo);
    }
};

// The rank type that K14 (lf_stream.cuh) and succ1's span kernel
// (succ_table.cuh) run over R: R itself, or for SubsetWTRank<RRR15> its twin
// with RRR15Staged in place of RRR15 (bv.cuh), the same descriptor read by
// a kernel that stages the pattern table in shared memory first. Its four
// RRR ranks chained a step made the register decode's latency K14's: on an
// H100 the table won 33% there and 7% in the span kernel, and ran 0-39%
// slower on the other RRR types (one block an SM; PERF.md).
template <class R>
struct StagedRank {
    using type = R;
};
template <>
struct StagedRank<SubsetWTRank<RRR15>> {
    using type = SubsetWTRank<RRR15Staged>;
};
// Whether a kernel over R must stage the pattern table first
template <class R>
struct StagesPatterns {
    static constexpr bool value = false;
};
template <>
struct StagesPatterns<SubsetWTRank<RRR15Staged>> {
    static constexpr bool value = true;
};

// The descriptor of R read as its twin K (same layout)
template <class K, class R>
__host__ __forceinline__ K as_rank(const R& rk) {
    static_assert(sizeof(K) == sizeof(R), "a rank type's twin reads its descriptor");
    K out;
    memcpy(&out, &rk, sizeof out);
    return out;
}

// K20a, plain-matrix over row shards: the rank table int2 [4 * n_words]
// and the suffix-group table int2 [n_words], each zero-padded to a
// multiple of the model axis and cut into equal row shards that may lie
// on other cards of the mesh (read over NVLink with peer access on).
// Replaces sbwt_tpu/parallel/sharded.py TPIndexView (:105-140): there
// each device gathers the rows of its own shard, zeroes the others and a
// psum over `model` adds them up, so exactly one term is non-zero; here
// the thread loads the row from its owning shard (shard = idx / rows,
// local = idx - shard * rows), the same function with one load.
struct ShardedMatrix {
    using pos_t = int;
    const int2* rank_shard[kMaxShards];
    const int2* sgs_shard[kMaxShards];
    long long n_words;
    int rank_rows;  // rows per shard
    int sgs_rows;

    __device__ __forceinline__ int2 rank_row(int idx) const {
        const int s = idx / rank_rows;
        return shard_ptr(rank_shard, s)[idx - s * rank_rows];
    }
    __device__ __forceinline__ int2 sg_row(int w) const {
        const int s = w / sgs_rows;
        return shard_ptr(sgs_shard, s)[w - s * sgs_rows];
    }
    __device__ __forceinline__ int rank(int c, int pos) const {
        int bit;
        return rank_in_row(rank_row(c * (int)n_words + (pos >> 5)), pos, &bit);
    }
    __device__ __forceinline__ int2 rank_pair(int c, int pos) const {
        int bit;
        const int r = rank_in_row(rank_row(c * (int)n_words + (pos >> 5)), pos, &bit);
        return make_int2(r, r + bit);
    }
};

__device__ __forceinline__ int2 sg_row(const ShardedMatrix& rk, const int2*, int64_t w) {
    return rk.sg_row((int)w);
}

// (rank(c, i), rank(c, j)), i <= j in [0, n]: an interval's two LF ranks
// (lf_stream.cuh). By default both chains, side by side; the plain-matrix
// rows read one row where i and j share it (i >> 5 == j >> 5), and
// otherwise load both rows before using either.
template <class R, class P = typename R::pos_t>
__device__ __forceinline__ pair_t<P> rank_interval(const R& rk, int c, P i, P j) {
    return make_pair_of<P>(rk.rank(c, i), rk.rank(c, j));
}

__device__ __forceinline__ int2 rank_interval(const PlainMatrix& rk, int c, int i, int j) {
    const int2* rows = rk.rank_tbl + (int64_t)c * rk.n_words;
    const int2 ri = rows[i >> 5];
    const int2 rj = (i >> 5) == (j >> 5) ? ri : rows[j >> 5];
    int bit;
    return make_int2(rank_in_row(ri, i, &bit), rank_in_row(rj, j, &bit));
}

__device__ __forceinline__ longlong2 rank_interval(const WideMatrix& rk, int c, int64_t i,
                                                   int64_t j) {
    const int* rows = rk.rank_tbl + 3 * (int64_t)c * rk.n_words;
    const int* ri = rows + 3 * (i >> 5);
    const int* rj = rows + 3 * (j >> 5);
    const bool same = (i >> 5) == (j >> 5);
    const unsigned wi = (unsigned)ri[0], lo_i = (unsigned)ri[1];
    const int hi_i = ri[2];
    const unsigned wj = same ? wi : (unsigned)rj[0], lo_j = same ? lo_i : (unsigned)rj[1];
    const int hi_j = same ? hi_i : rj[2];
    const unsigned oi = (unsigned)i & 31u, oj = (unsigned)j & 31u;
    return make_longlong2((((int64_t)hi_i << 32) | lo_i) + __popc(wi & ((1u << oi) - 1u)),
                          (((int64_t)hi_j << 32) | lo_j) + __popc(wj & ((1u << oj) - 1u)));
}

__device__ __forceinline__ int2 rank_interval(const ShardedMatrix& rk, int c, int i, int j) {
    const int base = c * (int)rk.n_words;
    const int2 ri = rk.rank_row(base + (i >> 5));
    const int2 rj = (i >> 5) == (j >> 5) ? ri : rk.rank_row(base + (j >> 5));
    int bit;
    return make_int2(rank_in_row(ri, i, &bit), rank_in_row(rj, j, &bit));
}

}  // namespace sbwt
