// Instances of the rank-templated kernels (rank_ops.cuh: K14, K1,
// partial_search, succ1, K4) for the concat variants
// (mef-concat is the reference's wavelet tree over RRR vectors).
#include "rank_ops.cuh"

extern "C" int sbwt_lf_concat(int device, int op, int variant, const void* rank,
                              const void* args, void* stream) {
    using namespace sbwt;
    cudaSetDevice(device);
    const LFArgs* a = static_cast<const LFArgs*>(args);
    switch (variant) {
        case 6: return launch_rank_op<ConcatRank<PlainBV>>(op, rank, a, stream);
        case 7: return launch_rank_op<ConcatRank<RRR15>>(op, rank, a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
