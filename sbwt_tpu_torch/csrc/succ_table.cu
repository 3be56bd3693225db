// K2 succ_compose: the de Bruijn successor tables of arity 1, 2 and 3
// from the one-edge successors that succ1 (succ_table.cuh) gives. It is
// int32 only and reads no rank structure, so the composed table of a
// compressed variant is the plain-matrix one; the wide tier has no arity 2
// or 3 (sbwt_tpu/ops/turbo.py:406-409).
//
// Replaces the XLA programs of sbwt_tpu/ops/turbo.py: _pair_chunk /
// _triple_chunk / _build_tbl_jit (the 2- and 3-fold composition of _succ1,
// built chunk by chunk into a padded buffer) and the arity-1 transpose.
//
// Bound on the H100: writes. The arity-3 table is n * 64 rows of 16 bytes
// (4.1 GB at n = 4M columns), against 16 bytes of succ reads per column;
// at 3.35 TB/s the write floor is 0.3 ms per GB. Design: one thread per
// (column, first char) writes its 4^(A-1) rows as one contiguous run into
// the preallocated table, so there are no chunk buffers and no pad rows.
// Row indices are 64-bit (col * 64 overflows int32 past 2^25 columns).
//
// K20c: the same kernel over a column range (kRange). A launch writes the
// rows of columns col0 .. col0 + n_cols - 1 (all < n) into a buffer that
// starts at col0's first row; a model shard of sbwt_tpu/parallel/sharded.py
// build_turbo_sharded (:343-421) is its own range in its own allocation,
// so no card ever holds the whole table. The caller zeroes the rows of the
// last shard's pad columns (past n, never gathered); the JAX build
// composes them from zero-padded succ. The whole table keeps an instance
// without the offset: with it, nvcc schedules the loads otherwise and the
// arity-3 table of 4M columns took 16% longer on an H100 (PERF.md;
// tools/compose_ab.py).
#include "sbwt_common.cuh"

namespace {

// Thread t = (col - col0) * 4 + c1 writes every table row that starts
// with col, c1.
template <bool kRange>
__global__ void compose_kernel(const int* __restrict__ succ, int n_nodes, int arity, int col0,
                               int n_cols, int* __restrict__ tbl) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (int64_t)(kRange ? n_cols : n_nodes) * 4) return;
    const int64_t col = kRange ? col0 + (t >> 2) : t >> 2;
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

extern "C" int sbwt_succ_compose(int device, const void* succ, int n_nodes, int arity, int col0,
                                 int n_cols, void* tbl, void* stream) {
    cudaSetDevice(device);
    if (arity < 1 || arity > 3 || col0 < 0 || n_cols < 1 || (int64_t)col0 + n_cols > n_nodes) {
        return (int)cudaErrorInvalidValue;
    }
    const unsigned grid = sbwt::grid_for((int64_t)n_cols * 4);
    const cudaStream_t s = (cudaStream_t)stream;
    if (col0 == 0 && n_cols == n_nodes) {
        compose_kernel<false><<<grid, sbwt::kBlock, 0, s>>>((const int*)succ, n_nodes, arity, 0,
                                                            n_nodes, (int*)tbl);
    } else {
        compose_kernel<true><<<grid, sbwt::kBlock, 0, s>>>((const int*)succ, n_nodes, arity, col0,
                                                           n_cols, (int*)tbl);
    }
    return (int)cudaGetLastError();
}
