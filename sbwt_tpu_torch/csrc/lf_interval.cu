// K1 lf_interval: LF interval search, one thread per lane.
//
// Replaces the XLA programs of sbwt_tpu/models/matrix.py with_precalc
// (the 4^p precalc fill) and sbwt_tpu/ops/search.py search_batch /
// update_interval_batch / lf_step (k-mer search), which ran the LF steps
// in lockstep over all lanes with lax.scan.
//
// Bound on the H100: each LF step is two dependent 8-byte loads from the
// rank table (4 * n/32 rows: 4 MB at n = 4M columns, so it sits in the
// 50 MB L2), i.e. latency, not bandwidth. Design: one thread runs its
// lane's whole chain of m steps in registers and stops at the first empty
// interval, so dead lanes cost nothing; the many resident threads (a
// 4^13-lane fill is 67M threads) hide the load latency. Output rows are
// written once, coalesced across neighbouring lanes.
#include "sbwt_common.cuh"

namespace {

// Lane i runs the p chars (i >> 2j) & 3 (colex-reversed packing,
// SBWT.hh:396-401) from the full interval (0, n - 1).
__global__ void precalc_fill_kernel(const int2* __restrict__ rank_tbl,
                                    int64_t n_words, const int* __restrict__ C,
                                    int n_nodes, int p, int64_t n_entries,
                                    int2* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n_entries) return;
    const int Cl[4] = {C[0], C[1], C[2], C[3]};
    int l = 0, r = n_nodes - 1;
    for (int j = 0; j < p; ++j) {
        if (!sbwt::lf_step(rank_tbl, n_words, Cl, (int)((i >> (2 * j)) & 3), l, r)) {
            out[i] = make_int2(-1, -1);
            return;
        }
    }
    out[i] = make_int2(l, r);
}

// Colex rank of each k-mer row of codes [B, k], or -1. Only codes 0..3 are
// valid (lowercase 4..7 and -1 are not, SBWT.hh:426-427). With p > 0 the
// first p chars come from the precalc table.
__global__ void kmer_search_kernel(const int2* __restrict__ rank_tbl,
                                   int64_t n_words, const int* __restrict__ C,
                                   int n_nodes, const int2* __restrict__ precalc,
                                   int p, const int8_t* __restrict__ codes,
                                   int64_t B, int k, int* __restrict__ out) {
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int8_t* kmer = codes + b * k;
    for (int j = 0; j < k; ++j) {
        if (!sbwt::is_base(kmer[j])) {
            out[b] = -1;
            return;
        }
    }
    const int Cl[4] = {C[0], C[1], C[2], C[3]};
    int l = 0, r = n_nodes - 1;
    if (p > 0) {
        unsigned pidx = 0;
        for (int j = 0; j < p; ++j) pidx |= (unsigned)kmer[j] << (2 * j);
        const int2 seed = precalc[pidx];
        if (seed.x < 0) {
            out[b] = -1;
            return;
        }
        l = seed.x;
        r = seed.y;
    }
    for (int j = p; j < k; ++j) {
        if (!sbwt::lf_step(rank_tbl, n_words, Cl, kmer[j], l, r)) {
            out[b] = -1;
            return;
        }
    }
    out[b] = l;
}

}  // namespace

extern "C" int sbwt_precalc_fill(int device, const void* rank_tbl, long long n_words,
                                 const void* C, int n_nodes, int p, void* out,
                                 void* stream) {
    cudaSetDevice(device);
    const int64_t n_entries = (int64_t)1 << (2 * p);
    precalc_fill_kernel<<<sbwt::grid_for(n_entries), sbwt::kBlock, 0, (cudaStream_t)stream>>>(
        (const int2*)rank_tbl, n_words, (const int*)C, n_nodes, p, n_entries, (int2*)out);
    return (int)cudaGetLastError();
}

extern "C" int sbwt_kmer_search(int device, const void* rank_tbl, long long n_words,
                                const void* C, int n_nodes, const void* precalc, int p,
                                const void* codes, long long B, int k, void* out,
                                void* stream) {
    cudaSetDevice(device);
    kmer_search_kernel<<<sbwt::grid_for(B), sbwt::kBlock, 0, (cudaStream_t)stream>>>(
        (const int2*)rank_tbl, n_words, (const int*)C, n_nodes, (const int2*)precalc, p,
        (const int8_t*)codes, B, k, (int*)out);
    return (int)cudaGetLastError();
}
