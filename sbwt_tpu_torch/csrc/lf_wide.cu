// The rank-templated kernels (rank_ops.cuh) at 64-bit positions: K18, the
// instance of the wide tier's plain-matrix rank (WideMatrix).
#include "rank_ops.cuh"

extern "C" int sbwt_lf_wide(int device, int op, int variant, const void* rank,
                            const void* args, void* stream) {
    using namespace sbwt;
    cudaSetDevice(device);
    if (variant != 10) return (int)cudaErrorInvalidValue;
    return launch_rank_op<WideMatrix>(op, rank, static_cast<const LFArgs*>(args), stream);
}
