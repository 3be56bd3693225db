// K14 and K1 (lf_stream.cuh) instances of the concat variants
// (mef-concat is the reference's wavelet tree over RRR vectors).
#include "lf_stream.cuh"

extern "C" int sbwt_lf_concat(int device, int op, int variant, const void* rank,
                              const void* args, void* stream) {
    using namespace sbwt;
    cudaSetDevice(device);
    const LFArgs* a = static_cast<const LFArgs*>(args);
    switch (variant) {
        case 6: return launch_lf<ConcatRank<PlainBV>>(op, rank, a, stream);
        case 7: return launch_lf<ConcatRank<RRR15>>(op, rank, a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
