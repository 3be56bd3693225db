// fast_search: the colex rank of full k-mers from a singleton precalc
// seed through the turbo successor table, one thread per k-mer row.
//
// Replaces the XLA program of sbwt_tpu/ops/turbo.py fast_search (:491,
// jitted at :1353 as fast_search_jit) with _walk_rem (:474) and _step
// (:439). For each row of codes [B, k]: valid only if all k codes are
// 0..3 (search semantics, SBWT.hh:426-427); the seed is precalc[pidx],
// pidx packing the first p chars (char j at bits 2j); the row is dead if
// it is invalid or its seed empty; needs_slow marks a live seed wider than
// one column, which only exact LF steps can answer; a live singleton walks
// the k - p remaining chars with table rows (walk_singleton, shared with
// K4's restarts in turbo_stream.cuh). ans is -1 where dead or needs_slow.
// The seed-bits table is never read (fast_search does not read it), and no
// rank structure is: the table is the same for every variant, so the
// kernel is templated on the position type only.
//   int      narrow tables: int32 [n, 4], [n * 16, 2] or [n * 64, 4] (arity 1-3)
//   int64_t  the wide tier's arity-1 table int64 [n, 4]
//
// Bound on the H100: a chain of 1 + ceil((k - p) / arity) dependent loads
// a row (the precalc row, then the table rows), each an HBM round trip in
// a table far past L2; bytes are small beside it (k codes in, 5 or 9
// bytes out). Design: one thread a row keeps the chain in registers, so
// many rows are in flight at once to hide the latency; the codes reads are
// strided by row, as in K1's kmer_search.
#include "turbo_stream.cuh"

namespace sbwt {

template <class P>
__global__ void fast_search_kernel(const void* __restrict__ tbl, int arity,
                                   const void* __restrict__ precalc, int p,
                                   const int8_t* __restrict__ codes, long long B, int k,
                                   P* __restrict__ ans, uint8_t* __restrict__ needs_slow) {
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int8_t* kmer = codes + b * k;
    unsigned pidx = 0;
    bool valid = true;
    for (int j = 0; j < k; ++j) {
        const int c = kmer[j];
        valid &= is_base(c);
        if (j < p) pidx |= (unsigned)(c & 3) << (2 * j);
    }
    P out = -1;
    uint8_t slow = 0;
    if (valid) {
        const pair_t<P> seed = static_cast<const pair_t<P>*>(precalc)[pidx];
        if (seed.x >= 0) {
            if (seed.x == seed.y) {
                out = walk_singleton<P>(FlatTable{}, tbl, arity, seed.x, kmer + p, k - p);
            } else {
                slow = 1;
            }
        }
    }
    ans[b] = out;
    needs_slow[b] = slow;
}

}  // namespace sbwt

// wide: 0 for the narrow (int32) tables of arity 1-3, 1 for the wide tier's
// int64 arity-1 table. Returns 0, or the CUDA error of the launch.
extern "C" int sbwt_fast_search(int device, int wide, const void* tbl, int arity,
                                const void* precalc, int p, const void* codes, long long B, int k,
                                void* ans, void* needs_slow, void* stream) {
    using namespace sbwt;
    cudaSetDevice(device);
    if (arity < 1 || arity > (wide ? 1 : 3) || p < 1 || p > 16 || p > k || B < 1) {
        return (int)cudaErrorInvalidValue;
    }
    const cudaStream_t s = (cudaStream_t)stream;
    const int8_t* c = static_cast<const int8_t*>(codes);
    uint8_t* slow = static_cast<uint8_t*>(needs_slow);
    if (wide) {
        fast_search_kernel<int64_t><<<grid_for(B), kBlock, 0, s>>>(
            tbl, arity, precalc, p, c, B, k, static_cast<int64_t*>(ans), slow);
    } else {
        fast_search_kernel<int><<<grid_for(B), kBlock, 0, s>>>(
            tbl, arity, precalc, p, c, B, k, static_cast<int*>(ans), slow);
    }
    return (int)cudaGetLastError();
}
