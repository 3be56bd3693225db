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
// update_interval_batch as the facade's update_sbwt_interval calls it.
// K1's search and partial_search run a lane's whole chain of steps in
// registers, stopping at the first empty interval, and take a wider
// interval's two ranks in one rank_interval (subset_rank.cuh).
//
// K14 walks each read's positions in order, one lane a read, as each lane
// of K4 (turbo_stream.cuh) does. While the previous answer is a column,
// the next is one extension, successor = C[c] + rank(c, sg_start(col))
// when the edge bit at sg_start(col) is set, both from one rank_pair.
// After a -1 the position restarts: the window must be all ACGT, then the
// precalc seed of its first p chars, then exact LF steps over rank(l) and
// rank(r + 1) for the other k - p chars (one rank_pair when l == r).
// Answers equal the JAX engine's: until a read's first -1 the extension
// takes lowercase codes 4..7 as their base (SBWT.hh:565-566); the JAX
// engine answers every later position by full search, where lowercase is
// invalid (SBWT.hh:426-427), so past that point only 0..3 extend.
// Positions past lengths[b] - k are -1.
//
// A restart first probes ahead (probe_from_seed). If the search of the
// window at q empties at char e, read[q..e] is a suffix of no column's
// label, so no indexed k-mer contains it (a k-mer that did would reach a
// column labelled with it by predecessors, or a dummy prefix of it), and
// every window from e - k + 1 to q is -1 without a search; a non-ACGT char
// at e rules out the same windows, save a lowercase one while extensions
// still pass it. The lane probes q = pos + k - 1 - die, where die is the
// offset at which its last probe died (at first ceil(log4 n) + 1: a
// random window dies about there), so that the dead range reaches back to
// pos, and at most the tile's last position, whose window is staged; at
// q <= pos it restarts at pos as before. A probe that dies too far on
// leaves [pos, e - k] open, which is probed again by the same rule; one
// that hits keeps its column for q, and the positions before q restart
// one by one. Lanes in restart mode at a tile's start probe together, so
// a warp pays about one probe a tile where it paid its slowest lane's
// search at every position (PERF.md).
//
// Bound on the H100: an extension is a suffix-group row and a rank row
// (on plain-matrix both from tables that stay in L2), a restart one
// precalc row from the 4^p table in HBM and the LF rank rows of a live
// seed; the compulsory bytes are mostly the codes read and the answers
// written. Those two streams, one lane a read, touch 32 rows L bytes
// apart in every warp instruction, so K14 stages them as K4 does
// (stream_tile.cuh): a warp owns 32 consecutive reads and walks them in
// tiles of T positions (LFShape), its codes window (T + k - 1 chars a
// read) staged in shared memory, its answers stored through a shared
// tile. The rolling state (run of valid chars, previous answer, lenience,
// the probes' state) stays in registers across tiles.
//
// Bound of K1's search and of partial_search on the H100: the codes read
// (k chars a k-mer; a lane's chars up to where it stops) and the answers
// written, and the rank rows of the LF steps, a chain of dependent loads a
// lane. One thread a lane read its row byte by byte, 32 rows k or L bytes
// apart in every warp instruction, and a partial_search warp ran until its
// longest lane stopped. So a warp stages its rows through shared memory
// with 16-byte loads (stream_tile.cuh), and partial_search refills a lane
// whose search has stopped from a pool of lanes (SearchShape).
//
// K1's fill shares interval prefixes: the entries below one node of the
// p-level tree of intervals share its interval, so a thread runs the
// p - D steps above a node of depth p - D once and expands its 4^D
// entries from there, each store coalesced across the warp
// (precalc_fill_kernel). Bound: the 4^p table written (537 MB at p = 13).
//
// Offsets into codes and answers (b * L, b * P) are 64-bit.
#pragma once

#include "stream_tile.cuh"
#include "subset_rank.cuh"

namespace sbwt {

// What a launch of a rank-templated kernel reads besides the rank
// structure (kernels.LFArgs mirrors it). "pos" is the rank type's pos_t,
// "pair" two of them.
struct LFArgs {
    const int2* sgs_tbl;        // [W] (suffix-group-start word w, word w - 1)
    const void* C;              // pos [4]
    const void* precalc;        // pair [4^p] (l, r), (-1, -1) when empty
    const int8_t* codes;        // lf_stream, turbo_stream, partial_search [B, L]; kmer_search [B, k];
                                // forward: chars [B]
    const int* lengths;         // [B]
    const void* aux;            // partial_search: pair [B] start intervals, or null for (0, n - 1);
                                // succ1: pos [B] columns, or null for 0..B-1; forward: pos [B] columns
    const void* tbl;            // turbo_stream: the arity-A successor table
    const unsigned* seed_bits;  // turbo_stream: 2-bit pair entries, or null
    void* out;                  // lf_stream, turbo_stream pos [B, L - k + 1]; kmer_search pos [B];
                                // precalc_fill pair [4^p]; partial_search l pos [B];
                                // succ1 pos [4, B], or [B, 4] when row_major; forward pos [B]
    void* out_r;                // partial_search: r pos [B]; lf_stream, turbo_stream: the
                                // WorkCounter totals [kWorkCounters] (unsigned long long) that the
                                // counting instance adds to, null for the one that counts nothing
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
            kTurboStream = 5, kForward = 6 };

// The work counters of K14 and K4 (kernels.WORK_COUNTERS): the real
// positions, the full searches begun (a restart: no previous answer and a
// window of k ACGT chars; K14's probes too), those that found their k-mer,
// the exact LF steps (lf_step_r calls) the searches took, the
// successor-table rows read (K4 only: the chain's and walk_singleton's),
// and the positions with a window of k ACGT chars that a probe's dead
// substring answered -1 with no search or extension of their own (K14
// only).
enum WorkCounter { kWorkPositions, kWorkRestarts, kWorkRestartHits, kWorkLFSteps, kWorkTableRows,
                   kWorkSkipped, kWorkCounters };

// A lane's work counts. WorkTally<false>, the instance launched without
// counting, does nothing and compiles to nothing. WorkTally<true> keeps the
// counts in registers (a read's below 2^32 each) and at the kernel's end
// adds them up across the warp, which every lane must reach, into one
// 64-bit atomicAdd a counter a warp at LFArgs::out_r. The totals ride in
// out_r, which K14 and K4 do not otherwise read: a field more in LFArgs
// moved nvcc's registers in kernels that never read it (PERF.md).
template <bool kOn>
struct WorkTally {
    __device__ __forceinline__ void add(WorkCounter, unsigned = 1) {}
    __device__ __forceinline__ void flush(void*) {}
};
template <>
struct WorkTally<true> {
    unsigned n[kWorkCounters] = {};
    __device__ __forceinline__ void add(WorkCounter i, unsigned v = 1) { n[i] += v; }
    __device__ __forceinline__ void flush(void* totals) {
        unsigned long long* work = static_cast<unsigned long long*>(totals);
#pragma unroll
        for (int i = 0; i < kWorkCounters; ++i) {
            unsigned long long v = n[i];
#pragma unroll
            for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(0xFFFFFFFFu, v, d);
            if ((threadIdx.x & 31) == 0 && v != 0) atomicAdd(work + i, v);
        }
    }
};

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
// unchanged, when the interval empties. kPair: a singleton's two ranks by
// one rank_pair (K14's and K4's restarts); K1's fill takes them down the
// same path as a wider interval's, so that a warp's singletons and wider
// intervals do not diverge: the fill at p = 12 ran 1.0-3.6x faster so on
// an H100, where K14's restarts on ConcatRank lost 14-33% (PERF.md).
template <bool kPair = true, class R, class P = typename R::pos_t>
__device__ __forceinline__ bool lf_step_r(const R& rk, const CArray<P>& Cl, int c, P& l, P& r) {
    P a, b;
    if (kPair && l == r) {
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

// lf_step_r as K1's search and partial_search take it: a wider interval's
// two ranks from one rank_interval (subset_rank.cuh), and with kUnified a
// singleton's too, so that the lanes of a warp at different stages of
// their searches run one code path (partial_search's refilled lanes). In
// lf_step_r, which K14's and K4's restarts and K1's fill share,
// rank_interval cost the p = 13 fill 22% on an H100 (tools/lf_ab.py), so
// they keep rank and rank.
template <bool kUnified, class R, class P = typename R::pos_t>
__device__ __forceinline__ bool lf_step_iv(const R& rk, const CArray<P>& Cl, int c, P& l, P& r) {
    P a, b;
    if (!kUnified && l == r) {
        const auto q = rk.rank_pair(c, l);
        a = q.x;
        b = q.y;
    } else {
        const auto q = rank_interval(rk, c, l, (P)(r + 1));
        a = q.x;
        b = q.y;
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
// row of its first p chars (packed colex-reversed in pidx), or -1: K1's
// search.
template <bool kInterval = false, class R, class P = typename R::pos_t>
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
        if constexpr (kInterval) {
            if (!lf_step_iv<false>(rk, Cl, kmer[j], l, r)) return -1;
        } else {
            if (!lf_step_r(rk, Cl, kmer[j], l, r)) return -1;
        }
    }
    return l;  // a found k-mer's interval is a singleton (SBWT.hh:410-414)
}

// K14's search of the window at w, whose chars it checks as it goes: the
// colex rank of its k chars, or -1 with *die the offset of the char where
// it died: the first non-ACGT char, the seed's last char where the precalc
// row is (-1, -1), or the char whose LF step emptied the interval.
template <class R, class P = typename R::pos_t, class Tally>
__device__ __forceinline__ P probe_from_seed(const R& rk, const LFArgs& a, const CArray<P>& Cl,
                                             const int8_t* w, int* die, Tally& work) {
    unsigned pidx = 0;
    for (int j = 0; j < a.p; ++j) {
        const int c = w[j];
        if (!is_base(c)) {
            *die = j;
            return -1;
        }
        pidx |= (unsigned)c << (2 * j);
    }
    P l = 0, r = (P)a.n_nodes - 1;
    if (a.p > 0) {
        const pair_t<P> seed = static_cast<const pair_t<P>*>(a.precalc)[pidx];
        if (seed.x < 0) {
            *die = a.p - 1;
            return -1;
        }
        l = seed.x;
        r = seed.y;
    }
    for (int j = a.p; j < a.k; ++j) {
        const int c = w[j];
        if (is_base(c)) {
            work.add(kWorkLFSteps);
            if (lf_step_r(rk, Cl, c, l, r)) continue;
        }
        *die = j;
        return -1;
    }
    return l;
}

// Launch shape of K14 over rank type R: `warps` warps a block, each owning
// 32 consecutive reads, walked `tile` positions at a time; `min_blocks`
// blocks an SM cap nvcc's registers at 65536 / (32 * warps * min_blocks) a
// thread. Chosen by sweeps on an H100 (tools/lf_ab.py; PERF.md): tiles of
// 16, 4 warps and at most 64 registers for most rank types; the wide
// tier's int64 answers run faster in tiles of 8; mef-concat, whose ranks
// are long chains of dependent loads, with at most 56 registers and 1,152
// threads an SM (48 spilled 8 bytes and ran 2.5% faster at hit0, 64 ran 4%
// slower; PERF.md).
template <class R>
struct LFShape {
    static constexpr int warps = 4, tile = 16, min_blocks = 8;
};
template <>
struct LFShape<WideMatrix> {
    static constexpr int warps = 4, tile = 8, min_blocks = 8;
};
template <>
struct LFShape<ConcatRank<RRR15>> {
    static constexpr int warps = 4, tile = 16, min_blocks = 9;
};

// K14's window: a tile's positions and the k - 1 chars after its last
__host__ __device__ __forceinline__ int lf_window(int tile, int k) { return tile + k - 1; }

// Dynamic shared memory of one K14 block over the variant's rank type R at k
template <class R>
__host__ __device__ __forceinline__ int lf_smem_bytes(int k) {
    using S = LFShape<R>;
    return tile_smem_bytes<typename R::pos_t>(S::warps, S::tile, lf_window(S::tile, k));
}

// One warp per 32 consecutive reads. For each tile of positions the warp
// stages the windows the tile reads into shared memory, each lane answers
// its read's positions of the tile from there (a restart's and a probe's
// k chars too), keeping its rolling state in registers across tiles, and
// writes its answers into a shared tile, which the warp then stores read
// by read as contiguous runs. K14 reads neither the turbo table nor the
// seed bits. With kCount it also counts its work (WorkTally) into a.out_r.
template <class R, bool kCount>
__global__ void __launch_bounds__(LFShape<R>::warps * 32, LFShape<R>::min_blocks)
    lf_stream_kernel(R rk, LFArgs a) {
    using P = typename R::pos_t;
    constexpr int T = LFShape<R>::tile, W = LFShape<R>::warps;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    extern __shared__ __align__(16) unsigned char smem[];
    const int64_t b0 = ((int64_t)blockIdx.x * W + warp) * 32;
    if (b0 >= a.B) return;  // the whole warp
    const int nrows = (int)min((int64_t)32, (int64_t)(a.B - b0));
    const int64_t b = b0 + lane;
    const int k = a.k, L = a.L;
    const int P_out = L - k + 1;
    const int n_pos = lane < nrows ? max(0, min(P_out, a.lengths[b] - k + 1)) : 0;
    const int win = lf_window(T, k);
    const int chunks = tile_code_chunks(win), row_bytes = tile_code_row_bytes(win);
    int8_t* st = reinterpret_cast<int8_t*>(smem) + warp * 32 * row_bytes;
    P* sa = reinterpret_cast<P*>(smem + W * 32 * row_bytes) + warp * 32 * (T + 1);
    P* out = static_cast<P*>(a.out);
    const CArray<P> Cl(a.C);
    WorkTally<kCount> work;
    work.add(kWorkPositions, n_pos);

    // Rolling state of position pos: run counts the valid chars ending at
    // pos+k-1. The probes' state: die, the offset at which the last probe
    // died (first ceil(log4 n) + 1); the windows cov_lo..cov_hi are known
    // -1; a probe's hit at hit_q, ahead of pos, answers it with hit_v.
    int run = 0;
    bool lenient = true;  // lowercase extends until the read's first -1
    P prev = -1;
    int die = min(k - 1, (65 - __clzll(a.n_nodes - 1)) / 2 + 1);
    int cov_lo = 0, cov_hi = -1, hit_q = -1;
    P hit_v = -1;

    for (int t0 = 0; t0 < P_out; t0 += T) {
        const int tend = min(t0 + T, P_out), end = min(tend, n_pos);
        if (__any_sync(0xFFFFFFFFu, t0 < n_pos)) {
            stage_codes(a.codes, a.B * (int64_t)L, b0, nrows, L, t0, win, chunks, row_bytes, st,
                        lane);
        }
        __syncwarp();
        const int8_t* s = staged_row(st, row_bytes, lane, a.codes + b * L, t0);
        if (t0 == 0 && n_pos > 0) {
            for (int x = 0; x < k - 1; ++x) run = is_base(s[x]) ? run + 1 : 0;
        }
        for (int pos = t0; pos < tend; ++pos) {
            P v = -1;
            if (pos < n_pos) {
                const int c = s[pos + k - 1];
                run = is_base(c) ? run + 1 : 0;
                if (pos == hit_q) {
                    v = hit_v;
                } else if (pos >= cov_lo && pos <= cov_hi) {
                    work.add(kWorkSkipped, run >= k);
                } else if (prev >= 0) {
                    if (c >= 0 && (lenient || c < 4)) v = successor(rk, a.sgs_tbl, Cl, prev, c & 3);
                } else if (run >= k) {
                    // Probe at q (pos itself: the restart as it was) until
                    // pos is answered. The dead range held ahead bounds q,
                    // and a new one that joins it extends it.
                    int q = pos;
                    if (hit_q < pos) q = max(pos, min(cov_lo > pos ? cov_lo - 1 : end - 1,
                                                      pos + k - 1 - die));
                    for (;;) {
                        int e;
                        const P col = probe_from_seed(rk, a, Cl, s + q, &e, work);
                        work.add(kWorkRestarts);
                        work.add(kWorkRestartHits, col >= 0);
                        if (q == pos) {
                            v = col;
                            break;
                        }
                        if (col >= 0) {
                            hit_q = q;
                            hit_v = col;
                            q = pos;
                        } else if (lenient && s[q + e] > 3) {
                            q = pos;  // a lowercase char that an extension may yet pass
                        } else {
                            die = e;
                            const int lo = q + e - k + 1;
                            if (cov_lo != q + 1) cov_hi = q;
                            cov_lo = lo;
                            if (lo <= pos) {
                                work.add(kWorkSkipped);
                                break;
                            }
                            q = max(pos, min(lo - 1, pos + k - 1 - die));
                        }
                    }
                }
                if (v < 0) lenient = false;
                prev = v;
            }
            sa[lane * (T + 1) + (pos - t0)] = v;
        }
        __syncwarp();
        store_answer_tile<T>(out, sa, b0, nrows, P_out, t0, tend - t0, lane);
        __syncwarp();  // the staged rows and the answer tile are reused
    }
    work.flush(a.out_r);
}

// K1's fill: a thread owns the 4^D entries below one node of depth p - D
// of the tree of intervals, D = min(kFillDepth, p - kFillMinLevel) and at
// least 0, so that the 4^(p - D) threads are never fewer than
// 4^kFillMinLevel (65,536): fewer leave the card idle (at p = 8, 1,024
// threads of depth 3 ran 1.4-6x slower than one thread an entry on an
// H100, tools/lf_ab.py).
constexpr int kFillDepth = 3;
constexpr int kFillMinLevel = 8;

// The 4^D entries below the interval (l, r) (live: not empty), the entry
// whose next D chars are m = sum c_e 4^e at out[m * stride], stride
// growing 4x a level: one LF step a child, none below an empty interval.
// Only the last level is unrolled (its four steps are independent loads
// in flight together); the levels above loop, which keeps the code of a
// heavy rank type small.
template <int D, class R, class P>
__device__ __forceinline__ void fill_below(const R& rk, const CArray<P>& Cl, P l, P r, bool live,
                                           pair_t<P>* out, int64_t stride) {
    if constexpr (D == 0) {
        __stcs(out, live ? make_pair_of<P>(l, r) : make_pair_of<P>(-1, -1));
    } else if constexpr (D == 1) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            P cl = l, cr = r;
            const bool child = live && lf_step_r<false>(rk, Cl, c, cl, cr);
            fill_below<0>(rk, Cl, cl, cr, child, out + c * stride, 4 * stride);
        }
    } else {
#pragma unroll 1
        for (int c = 0; c < 4; ++c) {
            P cl = l, cr = r;
            const bool child = live && lf_step_r<false>(rk, Cl, c, cl, cr);
            fill_below<D - 1>(rk, Cl, cl, cr, child, out + c * stride, 4 * stride);
        }
    }
}

// Entry i of the table spells chars (i >> 2j) & 3, j = 0..p-1, from the
// full interval (0, n - 1); its last D chars are its high bits. Thread
// t < 4^(p - D) runs the p - D steps of t's chars once, then writes
// entries t + m * 4^(p - D), m < 4^D: at each m consecutive threads write
// consecutive entries, so every store is coalesced across the warp. Over
// a rank type that reads staged patterns (StagedRank), the block stages
// the table first.
template <int D, class R>
__global__ void precalc_fill_kernel(R rk, LFArgs a) {
    using P = typename R::pos_t;
    if constexpr (StagesPatterns<R>::value) {
        stage_patterns();
        __syncthreads();
    }
    const int above = a.p - D;
    const int64_t n_threads = (int64_t)1 << (2 * above);
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n_threads) return;
    const CArray<P> Cl(a.C);
    P l = 0, r = (P)a.n_nodes - 1;
    bool live = true;
    for (int j = 0; j < above && live; ++j) live = lf_step_r<false>(rk, Cl, (int)((t >> (2 * j)) & 3), l, r);
    fill_below<D>(rk, Cl, l, r, live, static_cast<pair_t<P>*>(a.out) + t, n_threads);
}

// Launch shape of kmer_search and partial_search: kSearchWarps warps a
// block; a kmer_search warp owns 32 consecutive k-mers, a partial_search
// warp a pool of 32 * pool consecutive lanes, whose chars it stages
// kSearchTile at a time (8 warps, tiles of 8 or 32 and pools of 128 were
// no faster on an H100, tools/search_ab.py).
constexpr int kSearchWarps = 4, kSearchTile = 16;

// The rest is a trait of the rank type R, as LFShape is for K14: the
// partial_search pool, whether its steps are `unified` (every step through
// rank_interval, lf_step_iv), and for each kernel whether it is staged or
// keeps its one-thread-a-lane form (the lane's row read byte by byte from
// global memory). Chosen by A/B turns on an H100 (tools/search_ab.py;
// PERF.md): staged, kmer_search won 2-14% and partial_search 0.3-9% on
// the other rank types, and partial_search lost 4-9% where the ranks read
// RRR blocks (swept again with the patterns decoded in registers, so not
// for want of L1 by a table), on plain-concat and on the giant (wide);
// kmer_search staged on rrr-matrix won 10% but spilled 32 bytes. A pool
// of 64 with unified steps won 15% on mef-concat's partial search and lost
// 0.5-50% elsewhere: a refilled lane starts from the full interval while
// the others step singletons, and without unified steps the two paths
// diverge. rrr-subsetwt: kmer_search staged won 3-12%, partial_search
// staged lost 3%; its one-thread-a-lane partial_search reads the staged
// pattern table (rank_ops.cuh), which won 28%. kmer_blocks is the blocks
// an SM that kmer_search's launch bounds ask for, 0 for none: left to
// itself ptxas gave the split types' kmer_search 32 registers and spilled
// 16 bytes on mef-split; at 12 blocks they take 40 registers, no spill,
// and ran 0-2.5% faster. With Y in position-order rows, staged
// partial_search lost again on rrr- and mef-split, 2-3%.
struct SearchStaged {
    static constexpr int pool = 1;
    static constexpr bool unified = false, kmer_staged = true, partial_staged = true;
    static constexpr int kmer_blocks = 0;
};
struct SearchKmerStaged : SearchStaged {
    static constexpr bool partial_staged = false;
};
struct SearchLanes : SearchStaged {
    static constexpr bool kmer_staged = false, partial_staged = false;
};
template <class R>
struct SearchShape : SearchStaged {};
template <>
struct SearchShape<MatrixRank<RRR15>> : SearchLanes {};
template <>
struct SearchShape<SubsetWTRank<RRR15>> : SearchKmerStaged {};
template <class XBV>
struct SearchShape<SplitRank<XBV>> : SearchKmerStaged {
    static constexpr int kmer_blocks = 12;
};
template <>
struct SearchShape<SplitRank<PlainBV>> : SearchStaged {
    static constexpr int kmer_blocks = 12;
};
template <>
struct SearchShape<ConcatRank<PlainBV>> : SearchKmerStaged {};
template <>
struct SearchShape<WideMatrix> : SearchKmerStaged {};
template <>
struct SearchShape<ConcatRank<RRR15>> : SearchStaged {
    static constexpr int pool = 2;
    static constexpr bool unified = true;
};

// Bytes of one kmer_search warp's staged span: its 32 rows of k chars from
// the 16-byte chunk that holds the first, in whole chunks, and one more
// chunk that the last row's word reads may reach into
__host__ __device__ __forceinline__ int kmer_span_bytes(int k) { return 16 * ((32 * k + 30) / 16 + 1); }

// Dynamic shared memory of one partial_search block over R: each warp's
// 32 staged rows of a tile, then each warp's pool of results (l, r and
// the matched length)
template <class R>
__host__ __device__ __forceinline__ int partial_search_smem_bytes() {
    return kSearchWarps * 32 *
           (tile_code_row_bytes(kSearchTile) +
            SearchShape<R>::pool * (2 * (int)sizeof(typename R::pos_t) + 4));
}

// Whether the k chars staged at byte `off` of the span (4-byte aligned)
// are all ACGT, and their first p packed colex-reversed into *pidx (char j
// at bits 2j). Reads 4-byte words, each funnel-shifted from the two
// aligned words that hold it: a word is all ACGT iff no byte has a bit
// above bit 1, and the bytes past the k-mer are zeroed first.
__device__ __forceinline__ bool staged_kmer_index(const unsigned* span, int off, int k, int p,
                                                  unsigned* pidx) {
    const unsigned sh = 8u * (unsigned)(off & 3);
    unsigned bad = 0, idx = 0;
    for (int j = 0; j < k; j += 4) {
        const int w = (off + j) >> 2;
        unsigned x = __funnelshift_r(span[w], span[w + 1], sh);  // chars j .. j + 3
        if (k - j < 4) x &= (1u << (8 * (k - j))) - 1u;
        bad |= x & 0xFCFCFCFCu;
        if (j < p) {
            unsigned q = x & 0x03030303u;  // four 2-bit codes into one byte
            q = (q | (q >> 6)) & 0x000F000Fu;
            q = (q | (q >> 12)) & 0xFFu;
            if (p - j < 4) q &= (1u << (2 * (p - j))) - 1u;
            idx |= q << (2 * j);
        }
    }
    *pidx = idx;
    return bad == 0;
}

// Colex rank of each k-mer row of codes [B, k], or -1; only 0..3 are valid.
// A warp stages its 32 consecutive rows, one contiguous span, with 16-byte
// loads (stage_span: each chunk loaded once); each lane tests its row and
// packs its precalc index from 4-byte words of the span, runs its LF steps
// on chars read from shared memory and stores its answer, a coalesced
// store across the warp.
template <class R>
__global__ void __launch_bounds__(kSearchWarps * 32, SearchShape<R>::kmer_blocks)
    kmer_search_kernel(R rk, LFArgs a) {
    using P = typename R::pos_t;
    constexpr int W = kSearchWarps;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t b0 = ((int64_t)blockIdx.x * W + warp) * 32;
    if (b0 >= a.B) return;  // the whole warp
    const int nrows = (int)min((int64_t)32, (int64_t)(a.B - b0));
    const int k = a.k;
    extern __shared__ __align__(16) unsigned char smem[];
    int8_t* st = reinterpret_cast<int8_t*>(smem) + warp * kmer_span_bytes(k);
    const int8_t* span = a.codes + b0 * k;
    stage_span(a.codes, a.B * (int64_t)k, span, nrows * k, st, lane);
    __syncwarp();
    if (lane >= nrows) return;
    const int64_t b = b0 + lane;
    const int off = (int)((uintptr_t)span & 15) + lane * k;
    unsigned pidx;
    P v = -1;
    if (staged_kmer_index(reinterpret_cast<const unsigned*>(st), off, k, a.p, &pidx)) {
        const CArray<P> Cl(a.C);
        v = search_from_seed<true>(rk, a, Cl, st + off, pidx);
    }
    __stcs(static_cast<P*>(a.out) + b, v);
}

// The one-thread-a-lane kmer_search, for a rank type whose SearchShape
// keeps it.
template <class R>
__global__ void kmer_search_lane_kernel(R rk, LFArgs a) {
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
//
// A warp owns a pool of 32 * pool consecutive lanes and runs 32 of them at
// a time, in rounds: each round it stages the next `tile` chars of each
// running lane's row (stage_windows; a row is never staged whole, as
// update_sbwt_interval may pass any length), each lane takes its LF steps
// from there, keeping (l, r, t) in registers across rounds, and a lane
// whose search has stopped leaves its result in shared memory and takes
// the pool's next unstarted lane (a ballot and a popcount prefix), so a
// warp's rounds follow the mean matched length, not the longest. The
// pool's results are stored at the end, three coalesced evict-first runs.
template <class R>
__global__ void __launch_bounds__(kSearchWarps * 32) partial_search_kernel(R rk, LFArgs a) {
    using P = typename R::pos_t;
    using S = SearchShape<R>;
    constexpr int W = kSearchWarps, T = kSearchTile, G = S::pool;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t pool0 = ((int64_t)blockIdx.x * W + warp) * (32 * G);
    if (pool0 >= a.B) return;  // the whole warp
    const int n_pool = (int)min((int64_t)(32 * G), (int64_t)(a.B - pool0));
    const int chunks = tile_code_chunks(T), row_bytes = tile_code_row_bytes(T);
    extern __shared__ __align__(16) unsigned char smem[];
    int8_t* st = reinterpret_cast<int8_t*>(smem) + warp * 32 * row_bytes;
    P* res_l = reinterpret_cast<P*>(smem + W * 32 * row_bytes) + warp * 2 * 32 * G;
    P* res_r = res_l + 32 * G;
    int* res_len = reinterpret_cast<int*>(reinterpret_cast<P*>(smem + W * 32 * row_bytes) +
                                          W * 2 * 32 * G) + warp * 32 * G;
    const CArray<P> Cl(a.C);
    const pair_t<P>* start = static_cast<const pair_t<P>*>(a.aux);
    const int L = a.L;
    const int64_t total = a.B * (int64_t)L;

    int job = -1, t = 0, len = 0;  // the pool lane this lane runs (-1: none), its chars done and due
    P l = 0, r = 0;
    auto begin = [&](int j) {
        job = j < n_pool ? j : -1;
        if (job < 0) return;
        const int64_t b = pool0 + job;
        if (start != nullptr) {
            const pair_t<P> s0 = start[b];
            l = s0.x;
            r = s0.y;
        } else {
            l = 0;
            r = (P)a.n_nodes - 1;
        }
        len = max(0, min(L, a.lengths[b]));
        t = 0;
    };
    begin(lane);
    int next = 32;  // the pool's first lane not yet begun
    while (__any_sync(0xFFFFFFFFu, job >= 0)) {
        const int8_t* read = a.codes + (pool0 + max(job, 0)) * (int64_t)L;
        const int wlen = job >= 0 ? min(T, len - t) : 0;
        stage_windows(a.codes, total, read + t, wlen, chunks, row_bytes, st, lane);
        __syncwarp();
        bool done = job >= 0 && wlen <= 0;
        if (wlen > 0) {
            const int8_t* s = staged_row(st, row_bytes, lane, read, t);
            const int tend = t + wlen;
            while (t < tend) {
                const int c = s[t];
                if (c < 0 || !lf_step_iv<S::unified>(rk, Cl, c & 3, l, r)) break;
                ++t;
            }
            done = t < tend || t >= len;
        }
        if (done) {
            res_l[job] = l;
            res_r[job] = r;
            res_len[job] = t;
        }
        __syncwarp();  // the staged rows are reused
        const unsigned stopped = __ballot_sync(0xFFFFFFFFu, done);
        if (done) begin(next + __popc(stopped & ((1u << lane) - 1u)));
        next += __popc(stopped);
    }
    __syncwarp();
    P* out_l = static_cast<P*>(a.out) + pool0;
    P* out_r = static_cast<P*>(a.out_r) + pool0;
    int* out_len = a.out_len + pool0;
    for (int i = lane; i < n_pool; i += 32) {
        __stcs(out_l + i, res_l[i]);
        __stcs(out_r + i, res_r[i]);
        __stcs(out_len + i, res_len[i]);
    }
}

// The one-thread-a-lane partial_search, for a rank type whose SearchShape
// keeps it; over a rank type that reads staged patterns (StagedRank), the
// block stages the table first.
template <class R>
__global__ void partial_search_lane_kernel(R rk, LFArgs a) {
    using P = typename R::pos_t;
    if constexpr (StagesPatterns<R>::value) {
        stage_patterns();
        __syncthreads();
    }
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
