// Instances of the rank-templated kernels (rank_ops.cuh: K14, K1,
// partial_search, succ1, K4) for the matrix variants:
// plain-matrix, rrr-matrix and mef-matrix; and the descriptor sizes that
// the Python loader checks its ctypes mirrors against.
#include "rank_ops.cuh"

extern "C" int sbwt_lf_matrix(int device, int op, int variant, const void* rank,
                              const void* args, void* stream) {
    using namespace sbwt;
    cudaSetDevice(device);
    const LFArgs* a = static_cast<const LFArgs*>(args);
    switch (variant) {
        case 0: return launch_rank_op<PlainMatrix>(op, rank, a, stream);
        case 1: return launch_rank_op<MatrixRank<RRR15>>(op, rank, a, stream);
        case 2: return launch_rank_op<MatrixRank<MEF>>(op, rank, a, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// sizeof of each rank descriptor, in kernels.RANK_TYPES order, then LFArgs
// and K20b's ShardedTable
extern "C" int sbwt_lf_desc_sizes(long long* out) {
    using namespace sbwt;
    const long long sizes[] = {
        sizeof(PlainMatrix), sizeof(MatrixRank<RRR15>), sizeof(MatrixRank<MEF>),
        sizeof(SplitRank<PlainBV>), sizeof(SplitRank<RRR15>), sizeof(SplitRank<MEF>),
        sizeof(ConcatRank<PlainBV>), sizeof(ConcatRank<RRR15>),
        sizeof(SubsetWTRank<PlainBV>), sizeof(SubsetWTRank<RRR15>), sizeof(WideMatrix),
        sizeof(ShardedMatrix), sizeof(LFArgs), sizeof(ShardedTable),
    };
    for (int i = 0; i < (int)(sizeof(sizes) / sizeof(sizes[0])); ++i) out[i] = sizes[i];
    return 0;
}

// Dynamic shared memory of one K4 block at (k, arity), answers of pos_bytes
extern "C" int sbwt_turbo_smem_bytes(int k, int arity, int pos_bytes) {
    using namespace sbwt;
    return pos_bytes == 8 ? turbo_smem_bytes<int64_t>(k, arity) : turbo_smem_bytes<int>(k, arity);
}

// Dynamic shared memory of one K14 block at k over the rank type numbered
// variant (kernels.RANK_TYPES order), or -1
extern "C" int sbwt_lf_smem_bytes(int k, int variant) {
    using namespace sbwt;
    switch (variant) {
        case 0: return lf_smem_bytes<PlainMatrix>(k);
        case 1: return lf_smem_bytes<MatrixRank<RRR15>>(k);
        case 2: return lf_smem_bytes<MatrixRank<MEF>>(k);
        case 3: return lf_smem_bytes<SplitRank<PlainBV>>(k);
        case 4: return lf_smem_bytes<SplitRank<RRR15>>(k);
        case 5: return lf_smem_bytes<SplitRank<MEF>>(k);
        case 6: return lf_smem_bytes<ConcatRank<PlainBV>>(k);
        case 7: return lf_smem_bytes<ConcatRank<RRR15>>(k);
        case 8: return lf_smem_bytes<SubsetWTRank<PlainBV>>(k);
        case 9: return lf_smem_bytes<SubsetWTRank<RRR15>>(k);
        case 10: return lf_smem_bytes<WideMatrix>(k);
        case 11: return lf_smem_bytes<ShardedMatrix>(k);
        default: return -1;
    }
}
