// K2 succ_table: the de Bruijn successor tables of arity 1, 2 and 3.
//
// Replaces the XLA programs of sbwt_tpu/ops/turbo.py: _succ1 (one out-edge
// per column and char), _pair_chunk / _triple_chunk / _build_tbl_jit (their
// 2- and 3-fold composition, built chunk by chunk into a padded buffer)
// and the arity-1 transpose.
//
// Bound on the H100: writes. The arity-3 table is n * 64 rows of 16 bytes
// (4.1 GB at n = 4M columns), against 16 bytes of succ reads per column;
// at 3.35 TB/s the write floor is 0.3 ms per GB. Design: succ1 runs
// one thread per column (the rank and suffix-group rows it reads are 4.5 MB
// and stay in L2); compose runs one thread per (column, first char) and
// writes its 4^(A-1) rows as one contiguous run into the preallocated
// table, so there are no chunk buffers and no pad rows. Row indices are
// 64-bit (col * 64 overflows int32 past 2^25 columns).
#include "sbwt_common.cuh"

namespace {

// succ[c * n + col] = successor of col's suffix group by c, or -1.
__global__ void succ1_kernel(const int2* __restrict__ rank_tbl, int64_t n_words,
                             const int2* __restrict__ sgs_tbl,
                             const int* __restrict__ C, int n_nodes,
                             int* __restrict__ succ) {
    const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (col >= n_nodes) return;
    const int Cl[4] = {C[0], C[1], C[2], C[3]};
    const int s = sbwt::sg_start(sgs_tbl, (int)col);
    for (int c = 0; c < 4; ++c) {
        int bit;
        const int r = sbwt::extend_rank(rank_tbl, n_words, c, s, &bit);
        succ[(int64_t)c * n_nodes + col] = bit ? Cl[c] + r : -1;
    }
}

// Thread t = col * 4 + c1 writes every table row that starts with col, c1.
__global__ void compose_kernel(const int* __restrict__ succ, int n_nodes, int arity,
                               int* __restrict__ tbl) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (int64_t)n_nodes * 4) return;
    const int64_t col = t >> 2;
    const int c1 = (int)(t & 3);
    const int s1 = succ[(int64_t)c1 * n_nodes + col];
    if (arity == 1) {
        tbl[t] = s1;  // [n, 4]: the transpose of succ
        return;
    }
    if (arity == 2) {
        int2* rows = reinterpret_cast<int2*>(tbl) + t * 4;
        for (int c2 = 0; c2 < 4; ++c2) {
            const int s2 = s1 >= 0 ? succ[(int64_t)c2 * n_nodes + s1] : -1;
            rows[c2] = make_int2(s1, s2);
        }
        return;
    }
    int4* rows = reinterpret_cast<int4*>(tbl) + t * 16;
    for (int c2 = 0; c2 < 4; ++c2) {
        const int s2 = s1 >= 0 ? succ[(int64_t)c2 * n_nodes + s1] : -1;
        for (int c3 = 0; c3 < 4; ++c3) {
            const int s3 = s2 >= 0 ? succ[(int64_t)c3 * n_nodes + s2] : -1;
            rows[c2 * 4 + c3] = make_int4(s1, s2, s3, 0);
        }
    }
}

}  // namespace

extern "C" int sbwt_succ1(int device, const void* rank_tbl, long long n_words,
                          const void* sgs_tbl, const void* C, int n_nodes, void* succ,
                          void* stream) {
    cudaSetDevice(device);
    succ1_kernel<<<sbwt::grid_for(n_nodes), sbwt::kBlock, 0, (cudaStream_t)stream>>>(
        (const int2*)rank_tbl, n_words, (const int2*)sgs_tbl, (const int*)C, n_nodes,
        (int*)succ);
    return (int)cudaGetLastError();
}

extern "C" int sbwt_succ_compose(int device, const void* succ, int n_nodes, int arity,
                                 void* tbl, void* stream) {
    cudaSetDevice(device);
    compose_kernel<<<sbwt::grid_for((int64_t)n_nodes * 4), sbwt::kBlock, 0,
                     (cudaStream_t)stream>>>((const int*)succ, n_nodes, arity, (int*)tbl);
    return (int)cudaGetLastError();
}
