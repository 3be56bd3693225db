// The launch switch of the kernels that are templates over the rank type:
// K14 and K1 with partial_search (lf_stream.cuh), K2's succ1
// (succ_table.cuh) and K4 (turbo_stream.cuh). An instance file
// (lf_stream.cu, lf_split.cu, lf_concat.cu, lf_subsetwt.cu, lf_wide.cu,
// lf_sharded.cu) calls launch_rank_op<R> for each rank type of its family,
// which instantiates all six kernels for R, K4 over the flat table.
#pragma once

#include "lf_stream.cuh"
#include "succ_table.cuh"
#include "turbo_stream.cuh"

namespace sbwt {

template <class R>
int launch_rank_op(int op, const void* rank_desc, const LFArgs* args, void* stream) {
    const R rk = *static_cast<const R*>(rank_desc);
    const LFArgs a = *args;
    const cudaStream_t s = (cudaStream_t)stream;
    const unsigned grid = grid_for(a.B);
    switch (op) {
        case kLFStream:
            lf_stream_kernel<R><<<grid, kBlock, 0, s>>>(rk, a);
            break;
        case kPrecalcFill:
            precalc_fill_kernel<R><<<grid, kBlock, 0, s>>>(rk, a);
            break;
        case kKmerSearch:
            kmer_search_kernel<R><<<grid, kBlock, 0, s>>>(rk, a);
            break;
        case kPartialSearch:
            partial_search_kernel<R><<<grid, kBlock, 0, s>>>(rk, a);
            break;
        case kSucc1:
            succ1_kernel<R><<<grid, kBlock, 0, s>>>(rk, a);
            break;
        case kTurboStream:
            // the wide tier's table has arity 1 only
            if (a.arity < 1 || a.arity > (sizeof(typename R::pos_t) == 8 ? 1 : 3)) {
                return (int)cudaErrorInvalidValue;
            }
            return launch_turbo_stream(rk, a, FlatTable{}, s);
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace sbwt
