// Instances of the rank-templated kernels (rank_ops.cuh: K14, K1,
// partial_search, succ1, K4) for the split variants.
#include "rank_ops.cuh"

extern "C" int sbwt_lf_split(int device, int op, int variant, const void* rank,
                             const void* args, void* stream) {
    using namespace sbwt;
    cudaSetDevice(device);
    const LFArgs* a = static_cast<const LFArgs*>(args);
    switch (variant) {
        case 3: return launch_rank_op<SplitRank<PlainBV>>(op, rank, a, stream);
        case 4: return launch_rank_op<SplitRank<RRR15>>(op, rank, a, stream);
        case 5: return launch_rank_op<SplitRank<MEF>>(op, rank, a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
