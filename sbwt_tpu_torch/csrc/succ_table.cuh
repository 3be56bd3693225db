// K2 succ1 as a template over the rank type R of subset_rank.cuh: the
// out-edges of columns, one thread per column.
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
#pragma once

#include "lf_stream.cuh"

namespace sbwt {

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

}  // namespace sbwt
