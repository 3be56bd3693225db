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
// Y's row beside Z's for SplitRank, a sample and a window row then three
// levels for ConcatRank, and two trees' rows for SubsetWTRank (plain: two
// 16-byte rows; rrr: an RRR rank beside up to two MEF ranks, twice: four
// memory rounds, against up to eight down the wavelet trees' levels).
// rank_pair shares every load between the two positions; ConcatRank's two
// set starts, up to 4 symbols apart, share one walk of the tree
// (WaveletTree::rank_span).
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
// Y holds the unary columns' labels (sigma 4), Z (plain) the other
// columns' rows, char-major over n_b columns. Y is held in position order,
// one 32-byte row a 64 positions, two int4: (hi bits 0-31, hi bits 32-63,
// lo bits 0-31, lo bits 32-63) and (H, L, B, 0), the counts before the
// row of hi (symbol >= 2), of lo (symbol & 1) and of symbol 3
// (models/subsetrank.py _y_rows). So a char's count in Y before p is one
// row: m marks the row's positions that hold c (the hi and lo planes, each
// flipped where c's bit is 0), and the count is c's count before the row
// (B for 3, H - B for 2, L - B for 1, q - H - L + B for 0, q the row's
// first position) plus m's bits below p. The char picks by selects, so
// every lane of a warp runs one path. A rank or rank_pair is X's rank,
// then Y's row beside Z's row: 2 rounds over plain X, 3 over RRR15 or MEF
// (the wavelet tree's two levels after X made them 3 and 4). The row's
// two 16-byte loads go out together to one sector: the rows' base is
// 32-byte aligned, checked where the descriptor is made.
template <class XBV>
struct SplitRank {
    using pos_t = int;
    XBV X;
    const int4* Y;  // [n_Y / 64 + 1][2]: a row for every p in [0, n_Y]
    PlainBV Z;
    int n_b;
    int z_base[5];

    __device__ __forceinline__ static unsigned long long word64(int lo, int hi) {
        return ((unsigned long long)(unsigned)hi << 32) | (unsigned)lo;
    }
    // The count of c among Y's symbols before p, and whether the symbol at
    // p is c, from p's row
    __device__ __forceinline__ int y_rank_get(int c, int p, int* bit) const {
        const int4* row = Y + 2 * (p >> 6);
        const int4 w = row[0], cnt = row[1];
        const unsigned long long m = (word64(w.x, w.y) ^ ((c & 2) ? 0ull : ~0ull)) &
                                     (word64(w.z, w.w) ^ ((c & 1) ? 0ull : ~0ull));
        const unsigned o = (unsigned)p & 63u;
        *bit = (int)((m >> o) & 1ull);
        const int before = c == 3 ? cnt.z
                                  : (c == 2 ? cnt.x - cnt.z
                                            : (c == 1 ? cnt.y - cnt.z
                                                      : (p & ~63) - cnt.x - cnt.y + cnt.z));
        return before + __popcll(m & ((1ull << o) - 1ull));
    }

    __device__ __forceinline__ int rank(int c, int pos) const {
        const int xr = X.rank(pos);
        int bit;
        return y_rank_get(c, pos - xr, &bit) + Z.rank(c * n_b + xr) - pick4(z_base, c);
    }
    // X's bit at pos routes the +1 into exactly one of Y or Z
    __device__ __forceinline__ int2 rank_pair(int c, int pos) const {
        const int2 x = X.rank_pair(pos);
        int ybit;
        const int y = y_rank_get(c, pos - x.x, &ybit);
        const int2 z = Z.rank_pair(c * n_b + x.x);
        const int zb = pick4(z_base, c);
        return make_int2(y + z.x - zb, (x.y > x.x ? y + z.y : y + ybit + z.x) - zb);
    }
    // Y's hi and lo planes of positions p .. p + len - 1 (len in [0, 32]):
    // p's row, and the next row only where the run crosses into it
    __device__ __forceinline__ void y_planes(int p, int len, unsigned* hi, unsigned* lo) const {
        const int4* row = Y + 2 * (p >> 6);
        const int4 w = row[0];
        const unsigned o = (unsigned)p & 63u;
        unsigned long long h = word64(w.x, w.y) >> o, l = word64(w.z, w.w) >> o;
        if ((int)o + len > 64) {
            const int4 next = row[2];
            h |= word64(next.x, next.y) << (64u - o);
            l |= word64(next.z, next.w) << (64u - o);
        }
        *hi = (unsigned)h & low_mask(len);
        *lo = (unsigned)l & low_mask(len);
    }
    // X's bits split the run: its set bits take Z's run from rank xr, the
    // others Y's symbols from pos - xr
    __device__ __forceinline__ void subsets(int pos, int len, unsigned (&w)[4]) const {
        int xr;
        const unsigned xw = X.bits(pos, len, &xr);
        const int nx = __popc(xw), ny = len - nx;
        const unsigned yw = ~xw & low_mask(len);
        unsigned hi, lo;
        y_planes(pos - xr, ny, &hi, &lo);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            int r;
            const unsigned z = Z.bits(c * n_b + xr, nx, &r);
            const unsigned eq = ((c & 2) ? hi : ~hi) & ((c & 1) ? lo : ~lo) & low_mask(ny);
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
// gt over 2 * G + T of the GT-present columns. A symbol's hi bit marks
// {2, 3}, its lo bit {1, 3}. A char's count is two dependent rounds: the
// acgt tree's count at pos gives x (its hi count, the AC-present columns,
// for A and C; its lo count, the GT-present ones, for G and T), then the
// ac or gt tree's count at x (hi for A and G, lo for C and T). The char
// picks the tree and the count by selects, so a warp's lanes run one path
// whatever their chars. A tree's hi and lo counts at one position come
// from one round because both are held in position order: the wavelet
// tree's level 1 holds the lo bit permuted by the hi bit (SubsetWT's
// node-local ranks), a second round at two unrelated places.
template <class BV>
struct SubsetWTRank;

// plain-subsetwt: each tree as int4 rows, one per 32 positions: (hi word,
// hi count before it, lo word, lo count before it), the words and counts
// of the wavelet tree's two levels in position order, the same bytes. A
// rank or rank_pair is two 16-byte loads.
template <>
struct SubsetWTRank<PlainBV> {
    using pos_t = int;
    const int4* acgt;
    const int4* ac;
    const int4* gt;

    // The lo (else hi) count before pos from pos's row, and the bit at pos
    __device__ __forceinline__ static int count_at(const int4& row, bool lo, int pos, int* bit) {
        const unsigned w = (unsigned)(lo ? row.z : row.x);
        const unsigned o = (unsigned)pos & 31u;
        *bit = (int)((w >> o) & 1u);
        return (lo ? row.w : row.y) + __popc(w & ((1u << o) - 1u));
    }
    // rank(p + 1) = rank(p) + the bit at p, at each tree from its row
    __device__ __forceinline__ int2 rank_pair(int c, int pos) const {
        int adv, bit;
        const int x = count_at(acgt[pos >> 5], c >= 2, pos, &adv);
        const int4* t = c < 2 ? ac : gt;
        const int r = count_at(t[x >> 5], (c & 1) != 0, x, &bit);
        return make_int2(r, r + (adv & bit));
    }
    __device__ __forceinline__ int rank(int c, int pos) const { return rank_pair(c, pos).x; }

    // A tree's hi and lo bits of positions pos .. pos + len - 1 (len in
    // [0, 32]) and its hi and lo counts before pos; the next row only where
    // the run crosses into it
    __device__ __forceinline__ static void planes(const int4* t, int pos, int len, unsigned* hi,
                                                  unsigned* lo, int* rh, int* rl) {
        const int4 row = t[pos >> 5];
        const unsigned o = (unsigned)pos & 31u, below = (1u << o) - 1u;
        *rh = row.y + __popc((unsigned)row.x & below);
        *rl = row.w + __popc((unsigned)row.z & below);
        unsigned h = (unsigned)row.x >> o, l = (unsigned)row.z >> o;
        if ((int)o + len > 32) {
            const int4 next = t[(pos >> 5) + 1];
            h |= (unsigned)next.x << (32u - o);
            l |= (unsigned)next.z << (32u - o);
        }
        *hi = h & low_mask(len);
        *lo = l & low_mask(len);
    }
    // acgt's planes are the AC- and GT-present marks of the run; each marks
    // a run of the ac or gt tree, from the count of its marks before pos,
    // whose planes are A and C, or G and T
    __device__ __forceinline__ void subsets(int pos, int len, unsigned (&w)[4]) const {
        unsigned hi, lo, ah, al, gh, gl;
        int rh, rl, ra, rg;
        planes(acgt, pos, len, &hi, &lo, &rh, &rl);
        planes(ac, rh, __popc(hi), &ah, &al, &ra, &rg);
        planes(gt, rl, __popc(lo), &gh, &gl, &ra, &rg);
        w[0] = deposit(ah, hi);
        w[1] = deposit(al, hi);
        w[2] = deposit(gh, lo);
        w[3] = deposit(gl, lo);
    }
};

// rrr-subsetwt: each tree's level 0 (RRR: r0, the count of symbols {2, 3})
// and, in place of level 1, sparse vectors in position order (MEF: two
// plain row loads a rank) from which the lo count follows at the same
// position:
//   acgt  GT-present(p) = (p - r0(p)) - e(p) + b(p), e the empty columns
//         (symbol 0), b those with both an A/C and a G/T edge (symbol 3);
//   ac    C-present(x) = (x - a0(x)) + b_ac(x), b_ac the columns with A
//         and C; gt likewise T-present(x) = (x - g0(x)) + b_gt(x)
//         (neither holds a symbol 0).
// So a rank is two rounds, each an RRR rank with up to two MEF ranks beside
// it: four memory rounds. A lane with no use for an MEF rank reads it at
// position 0 (one cached row a warp), so that every lane runs one path.
// Where the vectors would take more bytes than the three level-1 vectors
// (many empty or two-sided columns; the host decides per index), sparse is
// 0 and level 1 is kept: the lo count is then level 1's two node ranks
// after r0, the wavelet tree's chain. The flag is uniform across a launch.
template <class BV>
struct SubsetWTRank {
    using pos_t = int;
    BV l0[3];              // level 0 of acgt, ac, gt
    MEF e, b, b_ac, b_gt;  // sparse != 0
    BV l1[3];              // sparse == 0: level 1 of acgt, ac, gt
    int node[3][4];        // sparse == 0: (base, ones before) of each tree's left and right node
    int sparse;

    using Tree4 = sbwt::Tree4<BV>;  // wavelet.cuh

    __device__ __forceinline__ Tree4 tree(int t) const {
        return Tree4{l0[t], l1[t], node[t][0], node[t][1], node[t][2], node[t][3]};
    }
    // (count of symbol 1, count of symbol 3) before pos, given level 0's
    // rank r at pos (level 1)
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
        const bool hi_side = c < 2, odd = (c & 1) != 0;
        const int r0 = l0[0].rank(pos);
        if (sparse) {
            const int q = hi_side ? 0 : pos;
            const int er = e.rank(q), br = b.rank(q);
            const int x = hi_side ? r0 : pos - r0 - er + br;
            const BV t0 = hi_side ? l0[1] : l0[2];
            const MEF bt = hi_side ? b_ac : b_gt;
            const int a0 = t0.rank(x), bx = bt.rank(odd ? x : 0);
            return odd ? x - a0 + bx : a0;
        }
        int x = r0;
        if (!hi_side) {
            const int2 q = pair_rank(tree(0), pos, r0);
            x = q.x + q.y;
        }
        const Tree4 t = hi_side ? tree(1) : tree(2);
        const int a0 = t.l0.rank(x);
        if (!odd) return a0;
        const int2 q = pair_rank(t, x, a0);
        return q.x + q.y;
    }

    __device__ __forceinline__ int2 rank_pair(int c, int pos) const {
        const bool hi_side = c < 2, odd = (c & 1) != 0;
        const int2 r = l0[0].rank_pair(pos);
        if (sparse) {
            const int q = hi_side ? 0 : pos;
            const int2 er = e.rank_pair(q), br = b.rank_pair(q);
            const int x = hi_side ? r.x : pos - r.x - er.x + br.x;
            const int xq = hi_side ? r.y : pos + 1 - r.y - er.y + br.y;
            const bool adv = xq != x;
            const BV t0 = hi_side ? l0[1] : l0[2];
            const MEF bt = hi_side ? b_ac : b_gt;
            const int2 a = t0.rank_pair(x), bb = bt.rank_pair(odd ? x : 0);
            const int aq = adv ? a.y : a.x;
            return odd ? make_int2(x - a.x + bb.x, xq - aq + (adv ? bb.y : bb.x))
                       : make_int2(a.x, aq);
        }
        int x = r.x, xq = r.y;
        if (!hi_side) {
            const int4 q = pair_rank_pair(tree(0), pos, 1, r.x, r.y - r.x);
            x = q.x + q.y;
            xq = q.z + q.w;
        }
        const int xadv = xq - x;
        const Tree4 t = hi_side ? tree(1) : tree(2);
        const int2 t0 = t.l0.rank_pair(x);
        const int t_rq = xadv == 1 ? t0.y : t0.x;
        if (!odd) return make_int2(t0.x, t_rq);
        const int4 q = pair_rank_pair(t, x, xadv, t0.x, t_rq - t0.x);
        return make_int2(q.x + q.y, q.z + q.w);
    }

    // acgt's planes are the AC- and GT-present marks of the run; each marks
    // a run of the ac or gt tree, from the count of its marks before pos,
    // whose planes are A and C, or G and T. Sparse: a lo plane is rebuilt
    // from the vectors' bits, (~hi & ~e) | (hi & b) over acgt, ~hi | b over
    // ac and gt.
    __device__ __forceinline__ void subsets(int pos, int len, unsigned (&w)[4]) const {
        unsigned hi, lo, ah, al, gh, gl;
        if (sparse) {
            int r0, er, br, ra, rg, rb;
            hi = l0[0].bits(pos, len, &r0);
            const unsigned ev = e.bits(pos, len, &er), bv = b.bits(pos, len, &br);
            lo = (~hi & ~ev & low_mask(len)) | (hi & bv);
            const int nh = __popc(hi), nl = __popc(lo), rl = pos - r0 - er + br;
            ah = l0[1].bits(r0, nh, &ra);
            gh = l0[2].bits(rl, nl, &rg);
            al = (~ah | b_ac.bits(r0, nh, &rb)) & low_mask(nh);
            gl = (~gh | b_gt.bits(rl, nl, &rb)) & low_mask(nl);
        } else {
            const Planes4 root = planes4(tree(0), pos, len);
            const Planes4 a = planes4(tree(1), root.r0, __popc(root.hi));
            const Planes4 g = planes4(tree(2), root.c1 + root.c3, __popc(root.lo));
            hi = root.hi;
            lo = root.lo;
            ah = a.hi;
            al = a.lo;
            gh = g.hi;
            gl = g.lo;
        }
        w[0] = deposit(ah, hi);
        w[1] = deposit(al, hi);
        w[2] = deposit(gh, lo);
        w[3] = deposit(gl, lo);
    }
};

// The rank type that K1's fill at p = 12 and partial_search's
// one-thread-a-lane form (rank_ops.cuh) run over R: R itself, or for
// SubsetWTRank<RRR15> its twin with RRR15Staged in place of RRR15 (bv.cuh),
// the same descriptor read by a kernel that stages the pattern table in
// shared memory first. On an H100 the table won 2.1x in that fill and 28%
// in partial_search, whose lanes take many steps each; it lost 15% in
// kmer_search, 24% in K14 and 23% in succ1's span kernel, and 0-39% on the
// other RRR types (tools/lf_ab.py, search_ab.py, succ_ab.py; PERF.md).
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
