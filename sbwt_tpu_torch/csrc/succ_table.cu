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
// at 3.35 TB/s the write floor is 0.3 ms per GB. Design: the launch first
// writes succ row by row, [n, 4] (64 MB at 4M columns), so that the
// successors of a column after each char are one 16-byte load. Then one
// thread writes one table row: the lanes of a warp write neighbouring
// rows, 512 bytes a store instruction at arity 3 (256 at arity 2), with
// evict-first stores, so that the GBs of table written do not push the
// successor rows out of L2. A row's three successors are a chain of three
// dependent loads (the column's row, then the row of s1, then of s2);
// every thread of a column reads the same first row, and its four s1 rows
// and sixteen s2 rows are shared by 16 and 4 threads. At arity 1 the table
// is the row layout itself. Row indices are 64-bit (col * 64 overflows
// int32 past 2^25 columns).
//
// K20c: the same kernels over a column range. A launch writes the
// rows of columns col0 .. col0 + n_cols - 1 (all < n) into a buffer that
// starts at col0's first row; a model shard of sbwt_tpu/parallel/sharded.py
// build_turbo_sharded (:343-421) is its own range in its own allocation,
// so no card ever holds the whole table. The caller zeroes the rows of the
// last shard's pad columns (past n, never gathered); the JAX build
// composes them from zero-padded succ. The whole table is the range of all
// columns: with one-thread-a-row stores, an instance without the column
// offset timed the same on an H100 (PERF.md; tools/compose_ab.py).
#include "sbwt_common.cuh"

namespace {

__device__ __forceinline__ int pick(const int4& v, int c) {
    return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w));
}

// Row i of out is (succ[0][col0 + i], .., succ[3][col0 + i]) for i < n_cols:
// [4, n] to [n, 4], four coalesced loads and one 16-byte store a thread.
// kStream: the rows are the arity-1 table, written evict-first.
template <bool kStream>
__global__ void succ_rows_kernel(const int* __restrict__ succ, int64_t n_nodes, int col0,
                                 int n_cols, int4* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_cols) return;
    const int64_t col = col0 + i;
    const int4 v = make_int4(succ[col], succ[n_nodes + col], succ[2 * n_nodes + col],
                             succ[3 * n_nodes + col]);
    if (kStream) {
        __stcs(out + i, v);
    } else {
        out[i] = v;
    }
}

// Thread t writes table row t (of the columns from col0): column
// (t >> 2A) + col0, chars c1..cA the digits of t's low 2A bits. The lanes
// of a warp write neighbouring rows, 256 (A = 2) or 512 (A = 3) bytes a
// store instruction, evict-first so that the successor rows stay in L2;
// each successor comes from one 16-byte row of rows [n, 4].
template <int A>
__global__ void compose_kernel(const int4* __restrict__ rows, int col0, int64_t n_rows,
                               void* __restrict__ tbl) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_rows) return;
    const int64_t col = col0 + (t >> (2 * A));
    const int sub = (int)t & ((1 << (2 * A)) - 1);
    const int s1 = pick(rows[col], sub >> (2 * (A - 1)));
    const int s2 = s1 >= 0 ? pick(rows[s1], (sub >> (2 * (A - 2))) & 3) : -1;
    if constexpr (A == 2) {
        __stcs(static_cast<int2*>(tbl) + t, make_int2(s1, s2));
    } else {
        const int s3 = s2 >= 0 ? pick(rows[s2], sub & 3) : -1;
        __stcs(static_cast<int4*>(tbl) + t, make_int4(s1, s2, s3, 0));
    }
}

}  // namespace

// rows: scratch of [n_nodes, 4] int32 for arity 2 and 3 (the successors
// row by row), unused at arity 1.
extern "C" int sbwt_succ_compose(int device, const void* succ, int n_nodes, int arity, int col0,
                                 int n_cols, void* rows, void* tbl, void* stream) {
    cudaSetDevice(device);
    if (arity < 1 || arity > 3 || col0 < 0 || n_cols < 1 || (int64_t)col0 + n_cols > n_nodes ||
        (arity > 1 && rows == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    const int* sc = static_cast<const int*>(succ);
    if (arity == 1) {
        succ_rows_kernel<true><<<sbwt::grid_for(n_cols), sbwt::kBlock, 0, s>>>(
            sc, n_nodes, col0, n_cols, static_cast<int4*>(tbl));
        return (int)cudaGetLastError();
    }
    int4* r = static_cast<int4*>(rows);
    succ_rows_kernel<false><<<sbwt::grid_for(n_nodes), sbwt::kBlock, 0, s>>>(sc, n_nodes, 0,
                                                                               n_nodes, r);
    const int64_t n_rows = (int64_t)n_cols << (2 * arity);
    if (arity == 2) {
        compose_kernel<2><<<sbwt::grid_for(n_rows), sbwt::kBlock, 0, s>>>(r, col0, n_rows, tbl);
    } else {
        compose_kernel<3><<<sbwt::grid_for(n_rows), sbwt::kBlock, 0, s>>>(r, col0, n_rows, tbl);
    }
    return (int)cudaGetLastError();
}
