// Instances of the rank-templated kernels (rank_ops.cuh: K14, K1,
// partial_search, succ1, K4) for the subset wavelet
// tree variants.
#include "rank_ops.cuh"

extern "C" int sbwt_lf_subsetwt(int device, int op, int variant, const void* rank,
                                const void* args, void* stream) {
    using namespace sbwt;
    cudaSetDevice(device);
    const LFArgs* a = static_cast<const LFArgs*>(args);
    switch (variant) {
        case 8: return launch_rank_op<SubsetWTRank<PlainBV>>(op, rank, a, stream);
        case 9: return launch_rank_op<SubsetWTRank<RRR15>>(op, rank, a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
