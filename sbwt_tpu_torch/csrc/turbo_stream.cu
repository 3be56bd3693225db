// K4 turbo_stream: exact streaming search over the successor table, one
// thread per read.
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
// algorithm needs; the many resident threads hide the latency. The codes
// reads and the [B, P] answer writes are strided by row (one read per
// thread), which is correct but not coalesced: staging them through shared
// memory is left for a later change.
#include "sbwt_common.cuh"

namespace {

struct Tables {
    const int* tbl;  // arity-A successor table
    int arity;
    const int2* rank_tbl;
    int64_t n_words;
    const int2* precalc;  // [4^p] (l, r), (-1, -1) when empty
    const unsigned* seed_bits;  // 2-bit pair entries, or nullptr
    int p;
    int k;
};

// Full search of the window at win (its k chars are all 0..3): seed from
// the precalc row of its first p chars (pidx), then walk the rest with
// table rows from a singleton seed, or take exact LF steps from a wider one.
__device__ __forceinline__ int restart(const Tables& t, const int* Cl,
                                       const int8_t* win, unsigned pidx) {
    if (t.seed_bits != nullptr &&
        !((t.seed_bits[pidx >> 4] >> (2 * (pidx & 15))) & 1u)) {
        return -1;
    }
    const int2 seed = t.precalc[pidx];
    if (seed.x < 0) return -1;
    if (seed.x == seed.y) {
        int col = seed.x;
        for (int j = t.p; j < t.k && col >= 0; j += t.arity) {
            const int take = min(t.arity, t.k - j);
            col = sbwt::component(sbwt::table_row(t.tbl, t.arity, col, win + j, take),
                                  take - 1);
        }
        return col;
    }
    int l = seed.x, r = seed.y;
    for (int j = t.p; j < t.k; ++j) {
        if (!sbwt::lf_step(t.rank_tbl, t.n_words, Cl, win[j], l, r)) return -1;
    }
    return l;
}

__global__ void turbo_stream_kernel(Tables t, const int* __restrict__ C,
                                    const int8_t* __restrict__ codes, int64_t B, int L,
                                    const int* __restrict__ lengths, int* __restrict__ out) {
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    const int k = t.k, p = t.p;
    const int P = L - k + 1;
    const int8_t* read = codes + b * L;
    int* ans = out + b * P;
    const int n_pos = max(0, min(P, lengths[b] - k + 1));
    for (int i = n_pos; i < P; ++i) ans[i] = -1;
    if (n_pos == 0) return;
    const int Cl[4] = {C[0], C[1], C[2], C[3]};

    // Rolling state of position pos: pidx packs chars pos..pos+p-1
    // colex-reversed (char j at bits 2j), run counts the valid chars
    // ending at pos+k-1. advance(pos) takes in chars pos+p-1 and pos+k-1.
    const unsigned top = 2u * (unsigned)(p - 1);
    unsigned pidx = 0;
    int run = 0;
    for (int j = 0; j < k - 1; ++j) run = sbwt::is_base(read[j]) ? run + 1 : 0;
    for (int j = 0; j < p - 1; ++j) pidx = (pidx >> 2) | ((unsigned)(read[j] & 3) << top);
    auto advance = [&](int pos) {
        const int c = read[pos + k - 1];
        run = sbwt::is_base(c) ? run + 1 : 0;
        pidx = (pidx >> 2) | ((unsigned)(read[pos + p - 1] & 3) << top);
    };

    bool lenient = true;  // lowercase extends until the read's first -1
    int prev = -1;
    int pos = 0;
    while (pos < n_pos) {
        if (prev < 0) {
            advance(pos);
            prev = run >= k ? restart(t, Cl, read + pos, pidx) : -1;
            ans[pos++] = prev;
            if (prev < 0) lenient = false;
            continue;
        }
        const int take = min(t.arity, n_pos - pos);
        const int4 row = sbwt::table_row(t.tbl, t.arity, prev, read + pos + k - 1, take);
        for (int j = 0; j < take; ++j) {
            advance(pos);
            const int c = read[pos + k - 1];
            const bool ok = c >= 0 && (lenient || c < 4);
            prev = ok ? sbwt::component(row, j) : -1;
            ans[pos++] = prev;
            if (prev < 0) {
                lenient = false;
                break;
            }
        }
    }
}

}  // namespace

extern "C" int sbwt_turbo_stream(int device, const void* tbl, int arity,
                                 const void* rank_tbl, long long n_words, const void* C,
                                 const void* precalc, int p, const void* seed_bits,
                                 const void* codes, long long B, int L, int k,
                                 const void* lengths, void* out, void* stream) {
    cudaSetDevice(device);
    const Tables t{(const int*)tbl, arity, (const int2*)rank_tbl, n_words,
                   (const int2*)precalc, (const unsigned*)seed_bits, p, k};
    turbo_stream_kernel<<<sbwt::grid_for(B), sbwt::kBlock, 0, (cudaStream_t)stream>>>(
        t, (const int*)C, (const int8_t*)codes, B, L, (const int*)lengths, (int*)out);
    return (int)cudaGetLastError();
}
