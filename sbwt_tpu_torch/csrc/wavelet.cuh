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
// down the tree (q - p in {0, 1}), so each level's rank_pair serves both.
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
};

}  // namespace sbwt
