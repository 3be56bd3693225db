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
// table rows. Design: a warp owns 32 consecutive reads, whose codes are
// one contiguous [32, L] region and whose answers one contiguous
// [32, L - k + 1] region, and walks them in tiles of kTurboTile positions.
// For each tile it stages the codes the tile reads (each window and the
// table row's look-ahead, kTurboTile + k + arity - 2 chars a read) into
// shared memory with 16-byte loads on neighbouring addresses (evict-first,
// as the answer stores, so that both streams leave L2 to the table rows
// and the seed bits); each lane
// answers its read's positions from there, one thread per read as the
// reference's streaming_search, keeping its rolling state (p-mer index,
// run of valid chars, previous answer, lenience) and any table row not
// yet consumed in registers across tiles; its answers go to a shared
// tile, which the warp stores as one run of neighbouring stores a read.
// So the warp's codes loads and answer stores touch whole sectors, where
// one thread a read touched 32 rows L bytes apart in every instruction.
// A wide arity-1 row is 32 bytes, of which the char picks one
// 16-byte half.
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
// (sbwt_tpu/ops/turbo.py _walk_rem, :474): K4's restarts from a singleton
// seed.
template <class P, class T, class Tally>
__device__ __forceinline__ P walk_singleton(const T& t, const void* tbl, int arity, P col,
                                            const int8_t* chars, int rem, Tally& work) {
    for (int j = 0; j < rem && col >= 0; j += arity) {
        work.add(kWorkTableRows);
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
template <class R, class T, class P, class Tally>
__device__ __forceinline__ P turbo_restart(const R& rk, const T& t, const LFArgs& a,
                                           const CArray<P>& Cl, const int8_t* win, unsigned pidx,
                                           Tally& work) {
    if (a.seed_bits != nullptr &&
        !((a.seed_bits[pidx >> 4] >> (2 * (pidx & 15))) & 1u)) {
        return -1;
    }
    const pair_t<P> seed = static_cast<const pair_t<P>*>(a.precalc)[pidx];
    if (seed.x < 0) return -1;
    if (seed.x == seed.y) {
        return walk_singleton<P>(t, a.tbl, a.arity, seed.x, win + a.p, a.k - a.p, work);
    }
    P l = seed.x, r = seed.y;
    for (int j = a.p; j < a.k; ++j) {
        work.add(kWorkLFSteps);
        if (!lf_step_r(rk, Cl, win[j], l, r)) return -1;
    }
    return l;
}

// Launch shape: kTurboWarps warps a block, each owning 32 consecutive
// reads, walked kTurboTile positions at a time; kTurboMinBlocks keeps
// nvcc's registers at or under 64 a thread. Chosen by a sweep on an H100
// (tools/turbo_ab.py; PERF.md): tiles of 8, 32 and 64 positions,
// 8 warps a block and caps of 40 and 42 registers were all slower.
constexpr int kTurboTile = 16;
constexpr int kTurboWarps = 4;
constexpr int kTurboMinBlocks = 8;

// K4's window: each position's k chars and the table row's look-ahead of
// arity - 1 chars.
__host__ __device__ __forceinline__ int turbo_window(int k, int arity) {
    return kTurboTile + k + arity - 2;
}

// Dynamic shared memory of one block at (k, arity)
template <class P>
__host__ __device__ __forceinline__ int turbo_smem_bytes(int k, int arity) {
    return tile_smem_bytes<P>(kTurboWarps, kTurboTile, turbo_window(k, arity));
}

// One warp per 32 consecutive reads. For each tile of kTurboTile
// positions the warp stages the codes the tile reads (its windows and the
// table rows' look-ahead) into shared memory, each lane answers its read's
// positions of the tile from there, keeping its rolling state and any
// unconsumed table row in registers across tiles, and writes its answers
// into a shared tile, which the warp then stores read by read as
// contiguous runs. With kCount it also counts its work (WorkTally) into
// a.out_r.
template <class R, class T, bool kCount>
__global__ void __launch_bounds__(kTurboWarps * 32, kTurboMinBlocks)
    turbo_stream_kernel(R rk, LFArgs a, T t) {
    using P = typename R::pos_t;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int64_t b0 = ((int64_t)blockIdx.x * kTurboWarps + warp) * 32;
    if (b0 >= a.B) return;  // the whole warp
    const int nrows = (int)min((int64_t)32, (int64_t)(a.B - b0));
    const int64_t b = b0 + lane;
    const int k = a.k, p = a.p, L = a.L;
    const int P_out = L - k + 1;
    const int n_pos = lane < nrows ? max(0, min(P_out, a.lengths[b] - k + 1)) : 0;
    const int win = turbo_window(k, a.arity);
    const int chunks = tile_code_chunks(win), row_bytes = tile_code_row_bytes(win);
    extern __shared__ __align__(16) unsigned char smem[];
    int8_t* st = reinterpret_cast<int8_t*>(smem) + warp * 32 * row_bytes;
    P* sa = reinterpret_cast<P*>(smem + kTurboWarps * 32 * row_bytes) +
            warp * 32 * (kTurboTile + 1);
    P* out = static_cast<P*>(a.out);
    const CArray<P> Cl(a.C);
    WorkTally<kCount> work;
    work.add(kWorkPositions, n_pos);

    // Rolling state of position pos: pidx packs chars pos..pos+p-1
    // colex-reversed (char j at bits 2j), run counts the valid chars
    // ending at pos+k-1. Position pos takes in chars pos+p-1 and pos+k-1.
    const unsigned top = 2u * (unsigned)(p - 1);
    unsigned pidx = 0;
    int run = 0;
    bool lenient = true;  // lowercase extends until the read's first -1
    P prev = -1;
    Succ3<P> row{-1, -1, -1};  // the table row being consumed: component j next, left more
    int j = 0, left = 0;

    for (int t0 = 0; t0 < P_out; t0 += kTurboTile) {
        const int tend = min(t0 + kTurboTile, P_out);
        if (__any_sync(0xFFFFFFFFu, t0 < n_pos)) {
            stage_codes(a.codes, a.B * (int64_t)L, b0, nrows, L, t0, win, chunks, row_bytes, st,
                        lane);
        }
        __syncwarp();
        const int8_t* s = staged_row(st, row_bytes, lane, a.codes + b * L, t0);
        if (t0 == 0 && n_pos > 0) {
            for (int x = 0; x < k - 1; ++x) run = is_base(s[x]) ? run + 1 : 0;
            for (int x = 0; x < p - 1; ++x) pidx = (pidx >> 2) | ((unsigned)(s[x] & 3) << top);
        }
        for (int pos = t0; pos < tend; ++pos) {
            P v = -1;
            if (pos < n_pos) {
                const int c = s[pos + k - 1];
                run = is_base(c) ? run + 1 : 0;
                pidx = (pidx >> 2) | ((unsigned)(s[pos + p - 1] & 3) << top);
                if (prev < 0) {
                    left = 0;
                    if (run >= k) {
                        v = turbo_restart(rk, t, a, Cl, s + pos, pidx, work);
                        work.add(kWorkRestarts);
                        work.add(kWorkRestartHits, v >= 0);
                    }
                } else {
                    if (left == 0) {
                        const int take = min(a.arity, n_pos - pos);
                        P local = prev;
                        const void* base = t.locate(a.tbl, local);
                        row = table_row<P>(base, a.arity, local, s + pos + k - 1, take);
                        work.add(kWorkTableRows);
                        j = 0;
                        left = take;
                    }
                    const bool ok = c >= 0 && (lenient || c < 4);
                    v = ok ? component(row, j) : (P)-1;
                    ++j;
                    --left;
                }
                if (v < 0) {
                    lenient = false;
                    left = 0;
                }
                prev = v;
            }
            sa[lane * (kTurboTile + 1) + (pos - t0)] = v;
        }
        __syncwarp();
        store_answer_tile<kTurboTile>(out, sa, b0, nrows, P_out, t0, tend - t0, lane);
        __syncwarp();  // the staged rows and the answer tile are reused
    }
    work.flush(a.out_r);
}

// Launches K4 over the table t, the counting instance when kCount; the
// shared memory a block needs grows with k, and past 48 KB the kernel's
// limit is raised first.
template <bool kCount, class R, class T>
int launch_turbo_stream(const R& rk, const LFArgs& a, const T& t, cudaStream_t s) {
    using P = typename R::pos_t;
    static std::atomic<int> raised[64];
    const int smem = turbo_smem_bytes<P>(a.k, a.arity);
    if (const int e = raise_smem_limit(turbo_stream_kernel<R, T, kCount>, smem, raised)) return e;
    const int64_t warps = (a.B + 31) / 32;
    const unsigned grid = (unsigned)((warps + kTurboWarps - 1) / kTurboWarps);
    turbo_stream_kernel<R, T, kCount><<<grid, kTurboWarps * 32, smem, s>>>(rk, a, t);
    return (int)cudaGetLastError();
}

}  // namespace sbwt
