// fast_search: the colex rank of full k-mers from a singleton precalc
// seed through the turbo successor table, a warp per 32 rows.
//
// Replaces the XLA program of sbwt_tpu/ops/turbo.py fast_search (:491,
// jitted at :1353 as fast_search_jit) with _walk_rem (:474) and _step
// (:439). For each row of codes [B, k]: valid only if all k codes are
// 0..3 (search semantics, SBWT.hh:426-427); the seed is precalc[pidx],
// pidx packing the first p chars (char j at bits 2j); the row is dead if
// it is invalid or its seed empty; needs_slow marks a live seed wider than
// one column, which only exact LF steps can answer; a live singleton walks
// the k - p remaining chars with table rows, as K4's restarts do
// (walk_singleton, turbo_stream.cuh). ans is -1 where dead or needs_slow.
// The seed-bits table is never read (fast_search does not read it), and no
// rank structure is: the table is the same for every variant, so the
// kernel is templated on the position type only.
//   int      narrow tables: int32 [n, 4], [n * 16, 2] or [n * 64, 4] (arity 1-3)
//   int64_t  the wide tier's arity-1 table int64 [n, 4]
//
// Bound on the H100: a chain of 1 + ceil((k - p) / arity) dependent loads
// a row (the precalc row, then the table rows), each an HBM round trip in
// a table far past L2; bytes are small beside it (k codes in, 5 or 9
// bytes out). One thread a row read its k codes byte by byte, 32 rows k
// bytes apart in every warp instruction, and twice: for the validity and
// seed index, and again in the walk. So a warp stages its 32 consecutive
// rows, one contiguous span, into shared memory with 16-byte loads
// (stage_span, as K1's kmer_search does); each lane tests its row and
// packs its seed index from 4-byte words of the span (staged_kmer_index),
// walks on chars read from shared memory (its own walk, so that K4's
// walk_singleton is not touched) and stores its answer and needs_slow,
// coalesced across the warp. A lane that walked two or four rows side by
// side, to keep more table loads in flight, was slower on an H100 at both
// mixes (tools/fast_search_ab.py; PERF.md), as were 8 warps a block.
#include "turbo_stream.cuh"

namespace sbwt {

constexpr int kFastWarps = 4;  // warps a block

template <class P>
__global__ void __launch_bounds__(kFastWarps * 32)
    fast_search_kernel(const void* __restrict__ tbl, int arity, const void* __restrict__ precalc,
                       int p, const int8_t* __restrict__ codes, long long B, int k,
                       P* __restrict__ ans, uint8_t* __restrict__ needs_slow) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t b0 = ((int64_t)blockIdx.x * kFastWarps + warp) * 32;
    if (b0 >= B) return;  // the whole warp
    const int nrows = (int)min((int64_t)32, (int64_t)(B - b0));
    extern __shared__ __align__(16) unsigned char smem[];
    int8_t* st = reinterpret_cast<int8_t*>(smem) + warp * kmer_span_bytes(k);
    const int8_t* span = codes + b0 * k;
    stage_span(codes, B * (int64_t)k, span, nrows * k, st, lane);
    __syncwarp();
    if (lane >= nrows) return;
    const int off = (int)((uintptr_t)span & 15) + lane * k;
    unsigned pidx;
    P col = -1;
    uint8_t slow = 0;
    if (staged_kmer_index(reinterpret_cast<const unsigned*>(st), off, k, p, &pidx)) {
        const pair_t<P> seed = static_cast<const pair_t<P>*>(precalc)[pidx];
        if (seed.x >= 0) {
            if (seed.x == seed.y) {
                col = seed.x;
            } else {
                slow = 1;
            }
        }
    }
    // the k - p chars after the seed's, min(arity, chars left) a table row
    const int8_t* chars = st + off + p;
    const int rem = k - p;
    for (int j = 0; j < rem && col >= 0; j += arity) {
        const int take = min(arity, rem - j);
        col = component(table_row<P>(tbl, arity, col, chars + j, take), take - 1);
    }
    ans[b0 + lane] = col;
    needs_slow[b0 + lane] = slow;
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
    const int smem = kFastWarps * kmer_span_bytes(k);
    const unsigned grid = (unsigned)((B + 32 * kFastWarps - 1) / (32 * kFastWarps));
    static std::atomic<int> raised_narrow[64], raised_wide[64];
    if (wide) {
        if (const int e = raise_smem_limit(fast_search_kernel<int64_t>, smem, raised_wide)) return e;
        fast_search_kernel<int64_t><<<grid, kFastWarps * 32, smem, s>>>(
            tbl, arity, precalc, p, c, B, k, static_cast<int64_t*>(ans), slow);
    } else {
        if (const int e = raise_smem_limit(fast_search_kernel<int>, smem, raised_narrow)) return e;
        fast_search_kernel<int><<<grid, kFastWarps * 32, smem, s>>>(
            tbl, arity, precalc, p, c, B, k, static_cast<int*>(ans), slow);
    }
    return (int)cudaGetLastError();
}
