// K16: balanced wavelet tree over sigma <= 5 symbols (depth <= 3), generic
// over the bit-vector type of bv.cuh.
//
// Replaces the XLA code of sbwt_tpu/ops/wavelet.py WaveletTree.rank (:134)
// and rank_pair (:151). All nodes of one depth share one level bit vector,
// so a symbol rank is one bit-vector rank per level. Instead of the JAX
// package's path tables and node arrays, the descriptor carries, for each
// symbol and depth, the step it takes: (its node's bit offset in the
// level, the ones before that node, the go-right bit, valid). The symbol is
// a runtime value, so the step is picked by a select over the five
// symbols, which keeps every read a constant offset into the by-value
// descriptor.
//
// Bound on the H100: one dependent bit-vector rank per level (2 or 3);
// rank_pair costs the same, since p and q = p + 1 stay equal or adjacent
// down the tree (q - p in {0, 1}), so each level's rank_pair serves both;
// rank_span likewise for q - p up to 31, by one bits call a level
// (ConcatRank's two set starts, at most 4 apart).
//
// planes4 and planes5 decode the symbols of a run of up to 32 consecutive
// positions at once, for succ1's whole-table decode (succ_table.cuh): a
// node's run of the positions starts at the rank that its parent's bits
// call gives, and holds as many as the parent sent that way; a child's
// bits go back to the parent's positions by deposit. So a run costs one
// bits call a node, not one rank chain a position.
#pragma once

#include "bv.cuh"

namespace sbwt {

constexpr int kMaxSigma = 5;
constexpr int kMaxDepth = 3;

template <class BV>
struct WaveletTree {
    BV level[kMaxDepth];
    int step[kMaxSigma][kMaxDepth][4];  // (node base, node rank, go right, valid)
    int depth;

    __device__ __forceinline__ int pick(int sym, int d, int f) const {
        int v = step[0][d][f];
#pragma unroll
        for (int s = 1; s < kMaxSigma; ++s) v = sym == s ? step[s][d][f] : v;
        return v;
    }

    // count of sym in positions [0, pos)
    __device__ __forceinline__ int rank(int sym, int pos) const {
#pragma unroll
        for (int d = 0; d < kMaxDepth; ++d) {
            if (d >= depth || !pick(sym, d, 3)) break;  // the path ended
            const int r1 = level[d].rank(pick(sym, d, 0) + pos) - pick(sym, d, 1);
            pos = pick(sym, d, 2) ? r1 : pos - r1;
        }
        return pos;
    }

    // (rank(sym, pos), rank(sym, pos + 1))
    __device__ __forceinline__ int2 rank_pair(int sym, int pos) const {
        int p = pos, q = pos + 1;
#pragma unroll
        for (int d = 0; d < kMaxDepth; ++d) {
            if (d >= depth || !pick(sym, d, 3)) break;
            const int2 r = level[d].rank_pair(pick(sym, d, 0) + p);
            const int nrank = pick(sym, d, 1);
            const int rp = r.x - nrank;
            const int rq = (q == p ? r.x : r.y) - nrank;
            if (pick(sym, d, 2)) {
                p = rp;
                q = rq;
            } else {
                p -= rp;
                q -= rq;
            }
        }
        return make_int2(p, q);
    }

    // (rank(sym, pos), rank(sym, pos + len)), len in [0, 31], in one walk:
    // at each level one bits call from p gives rank(p) and the run's bits,
    // and rank(q) = rank(p) + their popcount; the node-local span only
    // narrows on the way down (q - p <= len)
    __device__ __forceinline__ int2 rank_span(int sym, int pos, int len) const {
        int p = pos, q = pos + len;
#pragma unroll
        for (int d = 0; d < kMaxDepth; ++d) {
            if (d >= depth || !pick(sym, d, 3)) break;
            int r;
            const unsigned v = level[d].bits(pick(sym, d, 0) + p, q - p, &r);
            const int rp = r - pick(sym, d, 1), rq = rp + __popc(v);
            if (pick(sym, d, 2)) {
                p = rp;
                q = rq;
            } else {
                p -= rp;
                q -= rq;
            }
        }
        return make_int2(p, q);
    }
};

// What a sigma-4 tree's rank reads: level 0 counts symbols {2, 3}; its
// children, node ids 1 and 2, sit in level 1. A value copy, so that picking
// one of several trees by a char selects registers.
template <class BV>
struct Tree4 {
    BV l0, l1;
    int base_l, rank_l, base_r, rank_r;
};

// The symbols of positions pos .. pos + len - 1 (len in [0, 32]) of a
// sigma-4 tree as two bit planes: hi (symbol >= 2) and lo (symbol & 1);
// and the counts before pos of symbols {2, 3} (r0), 1 (c1) and 3 (c3).
struct Planes4 {
    unsigned hi, lo;
    int r0, c1, c3;
};

template <class BV>
__device__ __forceinline__ Planes4 planes4(const Tree4<BV>& t, int pos, int len) {
    Planes4 q;
    q.hi = t.l0.bits(pos, len, &q.r0);
    const int nh = __popc(q.hi);
    int rl, rr;
    const unsigned lo_l = t.l1.bits(t.base_l + (pos - q.r0), len - nh, &rl);
    const unsigned lo_r = t.l1.bits(t.base_r + q.r0, nh, &rr);
    q.c1 = rl - t.rank_l;
    q.c3 = rr - t.rank_r;
    q.lo = deposit(lo_l, ~q.hi & low_mask(len)) | deposit(lo_r, q.hi);
    return q;
}

// Where each of symbols 1..4 of a sigma-5 tree (ConcatRank's) is among
// positions pos .. pos + len - 1: m[s - 1]. The tree splits {0, 1, 2 | 3, 4}
// at the root, {0, 1 | 2} and {3 | 4} at depth 1, {0 | 1} at depth 2
// (sbwt_tpu_torch/ops/wavelet.py _build_shape), so the nodes are those of
// symbols 0 and 3 at depth 1 and of symbol 0 at depth 2.
template <class BV>
__device__ __forceinline__ void planes5(const WaveletTree<BV>& wt, int pos, int len,
                                        unsigned (&m)[4]) {
    int r0, rl, rr, rll;
    const unsigned right = wt.level[0].bits(pos, len, &r0);  // symbols 3, 4
    const unsigned left = ~right & low_mask(len);
    const int nr = __popc(right), nl = len - nr;
    const int pl = pos - r0;  // the left node's elements before the run
    const unsigned sym2 = wt.level[1].bits(wt.step[0][1][0] + pl, nl, &rl);
    const unsigned sym4 = wt.level[1].bits(wt.step[3][1][0] + r0, nr, &rr);
    const int pll = pl - (rl - wt.step[0][1][1]);
    const unsigned sym1 = wt.level[2].bits(wt.step[0][2][0] + pll, nl - __popc(sym2), &rll);
    m[0] = deposit(deposit(sym1, ~sym2 & low_mask(nl)), left);
    m[1] = deposit(sym2, left);
    m[2] = deposit(~sym4 & low_mask(nr), right);
    m[3] = deposit(sym4, right);
}

}  // namespace sbwt
