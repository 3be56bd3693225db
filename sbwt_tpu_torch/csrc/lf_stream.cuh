// K14 lf_stream, K1 (precalc_fill, kmer_search) and partial_search as
// templates over the rank type R of subset_rank.cuh, at R's position type:
// one instance per rank type, in lf_stream.cu (the matrix variants),
// lf_split.cu, lf_concat.cu, lf_subsetwt.cu, lf_wide.cu (WideMatrix:
// K18b, the int64 LF programs of sbwt_tpu/models/wide.py:157-177 and of
// sbwt_tpu/ops/search.py at pos_dtype int64) and lf_sharded.cu
// (ShardedMatrix: K20a, the row-sharded TP search of
// sbwt_tpu/parallel/sharded.py tp_search :208 and tp_streaming_search :478).
//
// K14 replaces the XLA programs of sbwt_tpu/ops/search.py streaming_search
// (:185), streaming_chain (:141), its staged patch with _patch_chunk
// (:173) and compact_indices (:38), and extend_from_column (:125). K1
// replaces sbwt_tpu/models/matrix.py with_precalc (:267) and
// sbwt_tpu/models/variants.py generic_with_precalc (:125), the 4^p
// precalc fill, and sbwt_tpu/ops/search.py search_batch (:83) with
// update_interval_batch (:64) and lf_step (:53), which ran the LF steps in
// lockstep over all lanes with lax.scan. partial_search replaces
// partial_search_batch (:291) and, given start intervals,
// update_interval_batch as the facade's update_sbwt_interval calls it. K1
// and partial_search run one thread per lane: the lane's whole chain of
// steps in registers, stopping at the first empty interval, so dead lanes
// cost nothing.
//
// One thread per read: the thread walks its read's positions in order, as
// each lane of K4 (turbo_stream.cuh) does. While the previous answer is a
// column, the next is one extension, successor = C[c] +
// rank(c, sg_start(col)) when the edge bit at sg_start(col) is set, both
// from one rank_pair. After a
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
// the latency. Codes reads and answer writes are strided by row; K4 stages
// both through shared memory, a warp's 32 reads at a time.
// Offsets into codes and answers (b * L, b * P) are 64-bit.
#pragma once

#include "subset_rank.cuh"

namespace sbwt {

// What a launch of a rank-templated kernel reads besides the rank
// structure (kernels.LFArgs mirrors it). "pos" is the rank type's pos_t,
// "pair" two of them.
struct LFArgs {
    const int2* sgs_tbl;        // [W] (suffix-group-start word w, word w - 1)
    const void* C;              // pos [4]
    const void* precalc;        // pair [4^p] (l, r), (-1, -1) when empty
    const int8_t* codes;        // lf_stream, turbo_stream, partial_search [B, L]; kmer_search [B, k]
    const int* lengths;         // [B]
    const void* aux;            // partial_search: pair [B] start intervals, or null for (0, n - 1);
                                // succ1: pos [B] columns, or null for 0..B-1
    const void* tbl;            // turbo_stream: the arity-A successor table
    const unsigned* seed_bits;  // turbo_stream: 2-bit pair entries, or null
    void* out;                  // lf_stream, turbo_stream pos [B, L - k + 1]; kmer_search pos [B];
                                // precalc_fill pair [4^p]; partial_search l pos [B];
                                // succ1 pos [4, B], or [B, 4] when row_major
    void* out_r;                // partial_search: r pos [B]
    int* out_len;               // partial_search: matched length [B]
    long long B;                // reads, k-mers, precalc entries or columns
    long long n_nodes;
    int L;
    int k;
    int p;
    int arity;      // turbo_stream
    int row_major;  // succ1
};

enum LFOp { kLFStream = 0, kPrecalcFill = 1, kKmerSearch = 2, kPartialSearch = 3, kSucc1 = 4,
            kTurboStream = 5 };

// C[0..3] in registers, picked by selects
template <class P>
struct CArray {
    P v[4];
    __device__ __forceinline__ explicit CArray(const void* C) {
        const P* c = static_cast<const P*>(C);
        v[0] = c[0];
        v[1] = c[1];
        v[2] = c[2];
        v[3] = c[3];
    }
    __device__ __forceinline__ P operator[](int c) const {
        return c == 0 ? v[0] : (c == 1 ? v[1] : (c == 2 ? v[2] : v[3]));
    }
};

// One LF step of [l, r] by char c (SBWT.hh:430-433); false, with (l, r)
// unchanged, when the interval empties.
template <class R, class P = typename R::pos_t>
__device__ __forceinline__ bool lf_step_r(const R& rk, const CArray<P>& Cl, int c, P& l, P& r) {
    P a, b;
    if (l == r) {
        const auto q = rk.rank_pair(c, l);
        a = q.x;
        b = q.y;
    } else {
        a = rk.rank(c, l);
        b = rk.rank(c, r + 1);
    }
    if (a >= b) return false;
    const P base = Cl[c];
    l = base + a;
    r = base + b - 1;
    return true;
}

// Greatest marked column <= col, its row read through the rank type
template <class R, class P>
__device__ __forceinline__ P sg_start_r(const R& rk, const int2* __restrict__ sgs_tbl, P col) {
    return sg_start_in(sg_row(rk, sgs_tbl, (int64_t)(col >> 5)), col);
}

// Out-edge c of col's suffix group: its successor column, or -1
// (SBWT.hh:566-577). The edge bit and the rank below it are one rank_pair.
template <class R, class P = typename R::pos_t>
__device__ __forceinline__ P successor(const R& rk, const int2* __restrict__ sgs_tbl,
                                       const CArray<P>& Cl, P col, int c) {
    const auto q = rk.rank_pair(c, sg_start_r(rk, sgs_tbl, col));
    return q.y > q.x ? Cl[c] + q.x : (P)-1;
}

// Colex rank of the k chars at kmer (all 0..3), seeded from the precalc
// row of its first p chars (packed colex-reversed in pidx), or -1.
template <class R, class P = typename R::pos_t>
__device__ __forceinline__ P search_from_seed(const R& rk, const LFArgs& a, const CArray<P>& Cl,
                                              const int8_t* kmer, unsigned pidx) {
    P l = 0, r = (P)a.n_nodes - 1;
    if (a.p > 0) {
        const pair_t<P> seed = static_cast<const pair_t<P>*>(a.precalc)[pidx];
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
    using P = typename R::pos_t;
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= a.B) return;
    const int k = a.k, p = a.p, L = a.L;
    const int P_out = L - k + 1;
    const int8_t* read = a.codes + b * L;
    P* ans = static_cast<P*>(a.out) + b * P_out;
    const int n_pos = max(0, min(P_out, a.lengths[b] - k + 1));
    for (int i = n_pos; i < P_out; ++i) ans[i] = -1;
    if (n_pos == 0) return;
    const CArray<P> Cl(a.C);

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
    P prev = -1;
    for (int pos = 0; pos < n_pos; ++pos) {
        const int c = read[pos + k - 1];
        run = is_base(c) ? run + 1 : 0;
        if (p > 0) pidx = (pidx >> 2) | ((unsigned)(read[pos + p - 1] & 3) << top);
        if (prev >= 0) {
            prev = c >= 0 && (lenient || c < 4) ? successor(rk, a.sgs_tbl, Cl, prev, c & 3) : (P)-1;
        } else {
            prev = run >= k ? search_from_seed(rk, a, Cl, read + pos, pidx) : (P)-1;
        }
        ans[pos] = prev;
        if (prev < 0) lenient = false;
    }
}

// Lane i runs the p chars (i >> 2j) & 3 from the full interval (0, n - 1).
template <class R>
__global__ void precalc_fill_kernel(R rk, LFArgs a) {
    using P = typename R::pos_t;
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.B) return;
    const CArray<P> Cl(a.C);
    P l = 0, r = (P)a.n_nodes - 1;
    pair_t<P>* out = static_cast<pair_t<P>*>(a.out);
    for (int j = 0; j < a.p; ++j) {
        if (!lf_step_r(rk, Cl, (int)((i >> (2 * j)) & 3), l, r)) {
            out[i] = make_pair_of<P>(-1, -1);
            return;
        }
    }
    out[i] = make_pair_of<P>(l, r);
}

// Colex rank of each k-mer row of codes [B, k], or -1; only 0..3 are valid.
template <class R>
__global__ void kmer_search_kernel(R rk, LFArgs a) {
    using P = typename R::pos_t;
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= a.B) return;
    const int8_t* kmer = a.codes + b * a.k;
    P* out = static_cast<P*>(a.out);
    unsigned pidx = 0;
    for (int j = 0; j < a.k; ++j) {
        if (!is_base(kmer[j])) {
            out[b] = -1;
            return;
        }
        if (j < a.p) pidx |= (unsigned)kmer[j] << (2 * j);
    }
    const CArray<P> Cl(a.C);
    out[b] = search_from_seed(rk, a, Cl, kmer, pidx);
}

// SBWT::partial_search (SBWT.hh:526-537): LF steps over the lane's first
// lengths[b] chars of codes [B, L] from its start interval, lowercase
// taken as its base, until the first char < 0 or the first step that
// empties the interval. Writes the last live interval and the number of
// chars it matched.
template <class R>
__global__ void partial_search_kernel(R rk, LFArgs a) {
    using P = typename R::pos_t;
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= a.B) return;
    const int8_t* text = a.codes + b * a.L;
    const CArray<P> Cl(a.C);
    P l = 0, r = (P)a.n_nodes - 1;
    if (a.aux != nullptr) {
        const pair_t<P> start = static_cast<const pair_t<P>*>(a.aux)[b];
        l = start.x;
        r = start.y;
    }
    const int len = min(a.L, a.lengths[b]);
    int t = 0;
    for (; t < len; ++t) {
        const int c = text[t];
        if (c < 0 || !lf_step_r(rk, Cl, c & 3, l, r)) break;
    }
    static_cast<P*>(a.out)[b] = l;
    static_cast<P*>(a.out_r)[b] = r;
    a.out_len[b] = t;
}

}  // namespace sbwt
