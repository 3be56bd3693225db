// K14 lf_stream and K1 (precalc_fill, kmer_search) as templates over the
// rank type R of subset_rank.cuh: one instance per variant, plain-matrix
// included, in lf_stream.cu (matrix), lf_split.cu, lf_concat.cu and
// lf_subsetwt.cu.
//
// K14 replaces the XLA programs of sbwt_tpu/ops/search.py streaming_search
// (:185), streaming_chain (:141), its staged patch with _patch_chunk
// (:173) and compact_indices (:38), and extend_from_column (:125). K1
// replaces sbwt_tpu/models/matrix.py with_precalc (:267) and
// sbwt_tpu/models/variants.py generic_with_precalc (:125), the 4^p
// precalc fill, and sbwt_tpu/ops/search.py search_batch (:83) with
// update_interval_batch (:64) and lf_step (:53), which ran the LF steps in
// lockstep over all lanes with lax.scan. K1 runs one thread per lane: the
// lane's whole chain of steps in registers, stopping at the first empty
// interval, so dead lanes cost nothing.
//
// One thread per read, as K4 (turbo_stream.cu): the thread walks its
// read's positions in order. While the previous answer is a column, the
// next is one extension, successor = C[c] + rank(c, sg_start(col)) when
// the edge bit at sg_start(col) is set, both from one rank_pair. After a
// -1 the position restarts: the window must be all ACGT, then the precalc
// seed of its first p chars, then exact LF steps over rank(l) and
// rank(r + 1) for the other k - p chars (one rank_pair when l == r).
// Answers equal the JAX engine's: until a read's first -1 the extension
// takes lowercase codes 4..7 as their base (SBWT.hh:565-566); the JAX
// engine answers every later position by full search, where lowercase is
// invalid (SBWT.hh:426-427), so past that point only 0..3 extend.
// Positions past lengths[b] - k are -1.
//
// Bound on the H100: dependent loads, as many per answer as the variant's
// rank takes (subset_rank.cuh) plus one suffix-group row, and k - p ranks
// for a restart with a live seed. The thread keeps its whole state in
// registers and reads the codes in place; the many resident threads hide
// the latency. As in K4, codes reads and answer writes are strided by row.
#pragma once

#include "subset_rank.cuh"

namespace sbwt {

// What an LF launch reads besides the rank structure (kernels.LFArgs).
struct LFArgs {
    const int2* sgs_tbl;  // [W] (suffix-group-start word w, word w - 1)
    const int* C;         // [4]
    const int2* precalc;  // [4^p] (l, r), (-1, -1) when empty
    const int8_t* codes;  // lf_stream [B, L], kmer_search [B, k]
    const int* lengths;   // lf_stream [B]
    int* out;             // lf_stream int [B, L - k + 1]; kmer_search int [B];
                          // precalc_fill int2 [4^p]
    long long B;          // reads, k-mers or precalc entries
    int L;
    int k;
    int p;
    int n_nodes;
};

enum LFOp { kLFStream = 0, kPrecalcFill = 1, kKmerSearch = 2 };

__device__ __forceinline__ int pick_c(const int (&Cl)[4], int c) {
    return c == 0 ? Cl[0] : (c == 1 ? Cl[1] : (c == 2 ? Cl[2] : Cl[3]));
}

// One LF step of [l, r] by char c (SBWT.hh:430-433); false, with (l, r)
// unchanged, when the interval empties.
template <class R>
__device__ __forceinline__ bool lf_step_r(const R& rk, const int (&Cl)[4], int c, int& l, int& r) {
    int a, b;
    if (l == r) {
        const int2 q = rk.rank_pair(c, l);
        a = q.x;
        b = q.y;
    } else {
        a = rk.rank(c, l);
        b = rk.rank(c, r + 1);
    }
    const int base = pick_c(Cl, c);
    if (a >= b) return false;
    l = base + a;
    r = base + b - 1;
    return true;
}

// Colex rank of the k chars at kmer (all 0..3), seeded from the precalc
// row of its first p chars (packed colex-reversed in pidx), or -1.
template <class R>
__device__ __forceinline__ int search_from_seed(const R& rk, const LFArgs& a, const int (&Cl)[4],
                                                const int8_t* kmer, unsigned pidx) {
    int l = 0, r = a.n_nodes - 1;
    if (a.p > 0) {
        const int2 seed = a.precalc[pidx];
        if (seed.x < 0) return -1;
        l = seed.x;
        r = seed.y;
    }
    for (int j = a.p; j < a.k; ++j) {
        if (!lf_step_r(rk, Cl, kmer[j], l, r)) return -1;
    }
    return l;  // a found k-mer's interval is a singleton (SBWT.hh:410-414)
}

template <class R>
__global__ void lf_stream_kernel(R rk, LFArgs a) {
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= a.B) return;
    const int k = a.k, p = a.p, L = a.L;
    const int P = L - k + 1;
    const int8_t* read = a.codes + b * L;
    int* ans = a.out + b * P;
    const int n_pos = max(0, min(P, a.lengths[b] - k + 1));
    for (int i = n_pos; i < P; ++i) ans[i] = -1;
    if (n_pos == 0) return;
    const int Cl[4] = {a.C[0], a.C[1], a.C[2], a.C[3]};

    // Rolling state of position pos, as in K4: pidx packs chars
    // pos..pos+p-1 colex-reversed, run counts the valid chars ending at
    // pos+k-1. advance(pos) takes in chars pos+p-1 and pos+k-1.
    const unsigned top = p > 0 ? 2u * (unsigned)(p - 1) : 0u;
    unsigned pidx = 0;
    int run = 0;
    for (int j = 0; j < k - 1; ++j) run = is_base(read[j]) ? run + 1 : 0;
    if (p > 0) {
        for (int j = 0; j < p - 1; ++j) pidx = (pidx >> 2) | ((unsigned)(read[j] & 3) << top);
    }

    bool lenient = true;  // lowercase extends until the read's first -1
    int prev = -1;
    for (int pos = 0; pos < n_pos; ++pos) {
        const int c = read[pos + k - 1];
        run = is_base(c) ? run + 1 : 0;
        if (p > 0) pidx = (pidx >> 2) | ((unsigned)(read[pos + p - 1] & 3) << top);
        if (prev >= 0) {
            if (c >= 0 && (lenient || c < 4)) {
                const int cc = c & 3;
                const int2 q = rk.rank_pair(cc, sg_start(a.sgs_tbl, prev));
                prev = q.y > q.x ? pick_c(Cl, cc) + q.x : -1;
            } else {
                prev = -1;
            }
        } else {
            prev = run >= k ? search_from_seed(rk, a, Cl, read + pos, pidx) : -1;
        }
        ans[pos] = prev;
        if (prev < 0) lenient = false;
    }
}

// Lane i runs the p chars (i >> 2j) & 3 from the full interval (0, n - 1).
template <class R>
__global__ void precalc_fill_kernel(R rk, LFArgs a) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.B) return;
    const int Cl[4] = {a.C[0], a.C[1], a.C[2], a.C[3]};
    int l = 0, r = a.n_nodes - 1;
    int2* out = reinterpret_cast<int2*>(a.out);
    for (int j = 0; j < a.p; ++j) {
        if (!lf_step_r(rk, Cl, (int)((i >> (2 * j)) & 3), l, r)) {
            out[i] = make_int2(-1, -1);
            return;
        }
    }
    out[i] = make_int2(l, r);
}

// Colex rank of each k-mer row of codes [B, k], or -1; only 0..3 are valid.
template <class R>
__global__ void kmer_search_kernel(R rk, LFArgs a) {
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= a.B) return;
    const int8_t* kmer = a.codes + b * a.k;
    unsigned pidx = 0;
    for (int j = 0; j < a.k; ++j) {
        if (!is_base(kmer[j])) {
            a.out[b] = -1;
            return;
        }
        if (j < a.p) pidx |= (unsigned)kmer[j] << (2 * j);
    }
    const int Cl[4] = {a.C[0], a.C[1], a.C[2], a.C[3]};
    a.out[b] = search_from_seed(rk, a, Cl, kmer, pidx);
}

template <class R>
int launch_lf(int op, const void* rank_desc, const LFArgs* args, void* stream) {
    const R rk = *static_cast<const R*>(rank_desc);
    const LFArgs a = *args;
    const cudaStream_t s = (cudaStream_t)stream;
    const unsigned grid = grid_for(a.B);
    switch (op) {
        case kLFStream:
            lf_stream_kernel<R><<<grid, kBlock, 0, s>>>(rk, a);
            break;
        case kPrecalcFill:
            precalc_fill_kernel<R><<<grid, kBlock, 0, s>>>(rk, a);
            break;
        case kKmerSearch:
            kmer_search_kernel<R><<<grid, kBlock, 0, s>>>(rk, a);
            break;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace sbwt
