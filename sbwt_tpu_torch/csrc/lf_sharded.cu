// K20: the tensor-parallel (row-sharded) kernels of
// sbwt_tpu/parallel/sharded.py, and peer access between the cards of a
// mesh.
//   K20a  the rank-templated kernels (rank_ops.cuh) over ShardedMatrix
//         (subset_rank.cuh): kmer_search and lf_stream, what tp_search and
//         tp_streaming_search run; the other ops are refused.
//   K20b  K4 (turbo_stream.cuh) over plain-matrix ranks and a ShardedTable,
//         what tp_turbo_streaming_search runs.
// A shard may lie on another card than the one that runs the kernel: the
// thread then loads the owner's row over NVLink. The caller enables peer
// access first (sbwt_enable_peer), and a pair of cards that cannot reach
// each other is an error, never a copy of the table.
//
// Bound on the H100: the same dependent loads as the flat instances
// (one row a rank or a table step), plus the integer division that picks
// the shard; a row on a peer card costs an NVLink round trip instead of
// an HBM one.
#include "rank_ops.cuh"

extern "C" int sbwt_lf_sharded(int device, int op, int variant, const void* rank,
                               const void* args, void* stream) {
    using namespace sbwt;
    cudaSetDevice(device);
    if (variant != 11 || (op != kLFStream && op != kKmerSearch)) return (int)cudaErrorInvalidValue;
    return launch_rank_op<ShardedMatrix>(op, rank, static_cast<const LFArgs*>(args), stream);
}

extern "C" int sbwt_turbo_sharded_table(int device, const void* rank, const void* table,
                                        const void* args, void* stream) {
    using namespace sbwt;
    cudaSetDevice(device);
    const PlainMatrix rk = *static_cast<const PlainMatrix*>(rank);
    const ShardedTable t = *static_cast<const ShardedTable*>(table);
    const LFArgs a = *static_cast<const LFArgs*>(args);
    if (a.arity < 1 || a.arity > 3 || t.cols < 1 || a.out_r != nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    return launch_turbo_stream<false>(rk, a, t, (cudaStream_t)stream);
}

// Let kernels on `device` load from memory on `peer`; 0 if they may
// (already enabled included), else the CUDA error.
extern "C" int sbwt_enable_peer(int device, int peer) {
    int can = 0;
    cudaError_t e = cudaDeviceCanAccessPeer(&can, device, peer);
    if (e != cudaSuccess) return (int)e;
    if (!can) return (int)cudaErrorPeerAccessUnsupported;
    cudaSetDevice(device);
    e = cudaDeviceEnablePeerAccess(peer, 0);
    if (e == cudaErrorPeerAccessAlreadyEnabled) {
        cudaGetLastError();  // not an error here: take it off the last-error slot
        return 0;
    }
    return (int)e;
}
