// K14 and K1 (lf_stream.cuh) instances of the matrix variants:
// plain-matrix, rrr-matrix and mef-matrix; and the descriptor sizes that
// the Python loader checks its ctypes mirrors against.
#include "lf_stream.cuh"

extern "C" int sbwt_lf_matrix(int device, int op, int variant, const void* rank,
                              const void* args, void* stream) {
    using namespace sbwt;
    cudaSetDevice(device);
    const LFArgs* a = static_cast<const LFArgs*>(args);
    switch (variant) {
        case 0: return launch_lf<PlainMatrix>(op, rank, a, stream);
        case 1: return launch_lf<MatrixRank<RRR15>>(op, rank, a, stream);
        case 2: return launch_lf<MatrixRank<MEF>>(op, rank, a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// sizeof of each variant's rank descriptor, in kernels.VARIANTS order, then LFArgs
extern "C" int sbwt_lf_desc_sizes(long long* out) {
    using namespace sbwt;
    const long long sizes[] = {
        sizeof(PlainMatrix), sizeof(MatrixRank<RRR15>), sizeof(MatrixRank<MEF>),
        sizeof(SplitRank<PlainBV>), sizeof(SplitRank<RRR15>), sizeof(SplitRank<MEF>),
        sizeof(ConcatRank<PlainBV>), sizeof(ConcatRank<RRR15>),
        sizeof(SubsetWTRank<PlainBV>), sizeof(SubsetWTRank<RRR15>), sizeof(LFArgs),
    };
    for (int i = 0; i < (int)(sizeof(sizes) / sizeof(sizes[0])); ++i) out[i] = sizes[i];
    return 0;
}
