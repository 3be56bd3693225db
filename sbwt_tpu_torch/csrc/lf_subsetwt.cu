// K14 and K1 (lf_stream.cuh) instances of the subset wavelet
// tree variants.
#include "lf_stream.cuh"

extern "C" int sbwt_lf_subsetwt(int device, int op, int variant, const void* rank,
                                const void* args, void* stream) {
    using namespace sbwt;
    cudaSetDevice(device);
    const LFArgs* a = static_cast<const LFArgs*>(args);
    switch (variant) {
        case 8: return launch_lf<SubsetWTRank<PlainBV>>(op, rank, a, stream);
        case 9: return launch_lf<SubsetWTRank<RRR15>>(op, rank, a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
