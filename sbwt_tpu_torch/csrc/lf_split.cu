// K14 and K1 (lf_stream.cuh) instances of the split variants.
#include "lf_stream.cuh"

extern "C" int sbwt_lf_split(int device, int op, int variant, const void* rank,
                             const void* args, void* stream) {
    using namespace sbwt;
    cudaSetDevice(device);
    const LFArgs* a = static_cast<const LFArgs*>(args);
    switch (variant) {
        case 3: return launch_lf<SplitRank<PlainBV>>(op, rank, a, stream);
        case 4: return launch_lf<SplitRank<RRR15>>(op, rank, a, stream);
        case 5: return launch_lf<SplitRank<MEF>>(op, rank, a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}
