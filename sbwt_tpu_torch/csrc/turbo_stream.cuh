// K4 turbo_stream as a template over the rank type R of subset_rank.cuh:
// exact streaming search over the successor table, one thread per read.
// The table is followed wherever a column is known; R serves only the
// exact LF steps of a restart whose precalc seed is wider than one column.
// With WideMatrix it is K18d, the wide arity-1 chain and restarts of
// sbwt_tpu/ops/turbo.py (:167-198, :661) at int64, whose (lo, hi) table
// pair and lo-only path exist because the TPU has no 64-bit lanes.
//
// Replaces the XLA program of sbwt_tpu/ops/turbo.py turbo_streaming_search
// as a whole: the position-0 seed and walk, the arity-A chain (_step), the
// restart patch (lane_body, bitmap_trip, _block_sweep, pend_pass,
// patch_lanes, patch_global), _lf_from_seeds and the compaction
// (sbwt_tpu/ops/search.py compact_indices). Those stages, their sentinels
// and chunk sizes exist because the TPU runs lockstep vector programs; a
// GPU thread can branch, so the thread walks its read's positions in order
// as the reference's streaming_search does (SBWT.hh:545-581).
//
// Answers equal the JAX engine's: position i is the colex rank of window
// i..i+k-1, or -1. Until a read's first -1 the chain extends with
// lowercase codes 4..7 as their uppercase base (SBWT.hh:565-566); from the
// first -1 on, the JAX engine answers every later position with a full
// search, in which lowercase is invalid (SBWT.hh:426-427), so past that
// point the extension accepts codes 0..3 only. Positions past
// lengths[b] - k are -1.
//
// Bound on the H100: dependent random loads. A chain step is one 16-byte
// row of the arity-3 table (4.1 GB at n = 4M columns, far past L2) and
// gives 3 answers; a restart costs a 4-byte seed_bits load (only bit0 of
// the words below 4^p / 16 is read: 16.8 MB of the 67 MB table at
// p = 13), then, for live seeds, an 8-byte precalc row and the walk's
// table rows. Design: one thread per read keeps its whole state in
// registers (rolling p-mer index, run of valid chars, previous answer) and
// reads the int8 codes in place, so every load it issues is one the
// algorithm needs; the many resident threads hide the latency. A wide
// arity-1 row is 32 bytes, of which the char picks one 16-byte half. The codes
// reads and the [B, P] answer writes are strided by row (one read per
// thread), which is correct but not coalesced: staging them through shared
// memory is left for a later change.
//
// The table's layout is a template parameter T: FlatTable, the one table of
// the launch's arguments, or ShardedTable (K20b), row shards of whole
// columns that may lie on other cards of the mesh. K20b replaces
// sbwt_tpu/parallel/sharded.py TPTurboView (:233-287): there each device
// gathers from its own shard and a psum over `model` adds up the one
// non-zero row; here the thread loads the row from the owning shard, with
// the row index rebased per shard as in tbl_row_sub (:278-287):
// (col - shard * cols) * 4^A + sub, formed in 64 bits by table_row.
#pragma once

#include "lf_stream.cuh"

namespace sbwt {

// The one flat table of LFArgs::tbl
struct FlatTable {
    template <class P>
    __device__ __forceinline__ const void* locate(const void* tbl, P&) const {
        return tbl;
    }
};

// Row shards of cols columns each (4^A rows a column; 1 at arity 1): the
// shard that owns col, with col made local to it. Narrow (int) only.
struct ShardedTable {
    const void* shard[kMaxShards];
    int cols;

    __device__ __forceinline__ const void* locate(const void*, int& col) const {
        const int s = col / cols;
        col -= s * cols;
        return shard_ptr(shard, s);
    }
};

// The column reached from column col by the rem chars at chars (all
// 0..3), min(arity, chars left) of them a table row, or -1
// (sbwt_tpu/ops/turbo.py _walk_rem, :474). K4's restarts from a singleton
// seed and fast_search (fast_search.cu) share it.
template <class P, class T>
__device__ __forceinline__ P walk_singleton(const T& t, const void* tbl, int arity, P col,
                                            const int8_t* chars, int rem) {
    for (int j = 0; j < rem && col >= 0; j += arity) {
        const int take = min(arity, rem - j);
        P local = col;
        const void* base = t.locate(tbl, local);
        col = component(table_row<P>(base, arity, local, chars + j, take), take - 1);
    }
    return col;
}

// Full search of the window at win (its k chars are all 0..3): seed from
// the precalc row of its first p chars (pidx), then walk the rest with
// table rows from a singleton seed, or take exact LF steps from a wider one.
template <class R, class T, class P = typename R::pos_t>
__device__ __forceinline__ P turbo_restart(const R& rk, const T& t, const LFArgs& a,
                                           const CArray<P>& Cl, const int8_t* win, unsigned pidx) {
    if (a.seed_bits != nullptr &&
        !((a.seed_bits[pidx >> 4] >> (2 * (pidx & 15))) & 1u)) {
        return -1;
    }
    const pair_t<P> seed = static_cast<const pair_t<P>*>(a.precalc)[pidx];
    if (seed.x < 0) return -1;
    if (seed.x == seed.y) return walk_singleton<P>(t, a.tbl, a.arity, seed.x, win + a.p, a.k - a.p);
    P l = seed.x, r = seed.y;
    for (int j = a.p; j < a.k; ++j) {
        if (!lf_step_r(rk, Cl, win[j], l, r)) return -1;
    }
    return l;
}

template <class R, class T>
__global__ void turbo_stream_kernel(R rk, LFArgs a, T t) {
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

    // Rolling state of position pos: pidx packs chars pos..pos+p-1
    // colex-reversed (char j at bits 2j), run counts the valid chars
    // ending at pos+k-1. advance(pos) takes in chars pos+p-1 and pos+k-1.
    const unsigned top = 2u * (unsigned)(p - 1);
    unsigned pidx = 0;
    int run = 0;
    for (int j = 0; j < k - 1; ++j) run = is_base(read[j]) ? run + 1 : 0;
    for (int j = 0; j < p - 1; ++j) pidx = (pidx >> 2) | ((unsigned)(read[j] & 3) << top);
    auto advance = [&](int pos) {
        const int c = read[pos + k - 1];
        run = is_base(c) ? run + 1 : 0;
        pidx = (pidx >> 2) | ((unsigned)(read[pos + p - 1] & 3) << top);
    };

    bool lenient = true;  // lowercase extends until the read's first -1
    P prev = -1;
    int pos = 0;
    while (pos < n_pos) {
        if (prev < 0) {
            advance(pos);
            prev = run >= k ? turbo_restart(rk, t, a, Cl, read + pos, pidx) : (P)-1;
            ans[pos++] = prev;
            if (prev < 0) lenient = false;
            continue;
        }
        const int take = min(a.arity, n_pos - pos);
        P local = prev;
        const void* base = t.locate(a.tbl, local);
        const Succ3<P> row = table_row<P>(base, a.arity, local, read + pos + k - 1, take);
        for (int j = 0; j < take; ++j) {
            advance(pos);
            const int c = read[pos + k - 1];
            const bool ok = c >= 0 && (lenient || c < 4);
            prev = ok ? component(row, j) : (P)-1;
            ans[pos++] = prev;
            if (prev < 0) {
                lenient = false;
                break;
            }
        }
    }
}

}  // namespace sbwt
