// K19: the on-device SBWT build. Four kernels between the library sorts,
// prefix sums and mask compactions of sbwt_tpu_torch/construct/device.py.
//
// Replaces the stages of the XLA program _build_device_jit
// (sbwt_tpu/construct/device.py:187-332) that are not its lax.sort and
// jnp.cumsum calls:
//   pack_windows     window packing (:198-207)
//   edge_src_probe   suffix groups, out-edge probes, predecessor test
//                    (:221-245, with _drop_first, _append_last,
//                    _shift_left2 and _member_sorted)
//   emit_dummies     dummy prefixes of every source (:247-270, with _prefix
//                    and _char_at)
//   finalize_tables  streaming marks, bit packing, popcounts (:307-330, with
//                    _pack_bits_words and the popcount of _rank_rows)
//
// A key is W = ceil(k / 16) uint32 words, row-major [n, W], word 0 most
// significant: the char at distance d from the END of the k-mer sits at
// bits [30 - 2 (d % 16), 32 - 2 (d % 16)) of word d / 16, so unsigned
// word-sequence order is colex order and a prefix shorter than k is
// top-aligned too.
//
// The XLA program tests membership by "concatenate, sort, propagate the
// run's leading tag", five full sorts of 2m rows. Here edge_src_probe is one
// sorted merge of the distinct k-mer list against itself:
//   * The predecessor query of k-mer j is pred(j) = shift_left2(key j), its
//     (k-1)-prefix. Keys sort with the last char most significant, so the
//     list is four runs by last char, and within a run pred(j) is strictly
//     increasing: four sorted runs of queries.
//   * Dropping a key's first char clears its least significant bits, which
//     keeps the list's order: the masked list is sorted, a suffix group a
//     run of equal masked keys.
//   * suffix_i . c is a k-mer exactly when some k-mer j with last char c
//     has pred(j) == masked(key i). So one lower bound of pred(j) in the
//     masked list gives all three outputs: where the key there equals
//     pred(j), it is the first of its group (a group start i), j has a
//     predecessor, and bit c = last_char(j) of edges[i] is set. The four
//     suffix . c searches of a group start are the same membership question
//     asked from the other side.
// Each run is merged against the masked list with merge-path partitions
// (moderngpu's sorted search): block (p, c) takes an equal share of run c's
// queries plus list keys, reads its split at each edge (found by a first
// kernel, one warp a partition edge), stages its window of the list in
// shared memory by cp.async and settles each query there.
//
// Bounds on the H100: all four kernels are bound by bytes. pack_windows,
// emit_dummies and finalize_tables write or read W words a row once;
// edge_src_probe reads each run's keys once and the list once a run (four
// times; the blocks of the four runs at one partition run side by side, so
// their windows of the list meet in L2) and writes three bytes a k-mer.
// Keys live in registers: the kernels are templated on a word capacity WMAX
// (2, 4 or 16) with the true W a runtime value.
#include "sbwt_common.cuh"

namespace {

constexpr unsigned kSentinel = 0xFFFFFFFFu;

__host__ __device__ __forceinline__ int word_of(int d) { return d >> 4; }
__host__ __device__ __forceinline__ int shift_of(int d) { return 30 - 2 * (d & 15); }

template <int WMAX>
struct Key {
    unsigned w[WMAX];
};

template <int WMAX>
__device__ __forceinline__ Key<WMAX> load_key(const unsigned* __restrict__ keys, int64_t i,
                                              int W) {
    Key<WMAX> a;
#pragma unroll
    for (int j = 0; j < WMAX; ++j) a.w[j] = j < W ? keys[i * W + j] : 0u;
    return a;
}

// -1, 0, 1 as a sorts before, equal to, after b.
template <int WMAX>
__device__ __forceinline__ int compare(const Key<WMAX>& a, const Key<WMAX>& b) {
#pragma unroll
    for (int j = 0; j < WMAX; ++j) {
        if (a.w[j] != b.w[j]) return a.w[j] < b.w[j] ? -1 : 1;
    }
    return 0;
}

// Clear the first char of a length-k key (distance k - 1 from the end).
template <int WMAX>
__device__ __forceinline__ void drop_first(Key<WMAX>& a, int k) {
    const int wi = word_of(k - 1);
    const unsigned mask = ~(3u << shift_of(k - 1));
#pragma unroll
    for (int j = 0; j < WMAX; ++j) {
        if (j == wi) a.w[j] &= mask;
    }
}

// Shift left by one char: drops the last char (Kmer::dropright).
template <int WMAX>
__device__ __forceinline__ Key<WMAX> shift_left2(const Key<WMAX>& a, int W) {
    Key<WMAX> out;
#pragma unroll
    for (int j = 0; j < WMAX; ++j) {
        const unsigned next = (j + 1 < WMAX && j + 1 < W) ? (a.w[j + 1 < WMAX ? j + 1 : j] >> 30) : 0u;
        out.w[j] = j < W ? ((a.w[j] << 2) | next) : 0u;
    }
    return out;
}

// One thread per window start: k codes into W top-aligned words; a window
// holding a code < 0 becomes all ones and is marked invalid.
__global__ void pack_windows_kernel(const int8_t* __restrict__ codes, int64_t m, int k, int W,
                                    unsigned* __restrict__ keys, uint8_t* __restrict__ valid) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= m) return;
    bool ok = true;
    for (int wj = 0; wj < W; ++wj) {
        unsigned word = 0;
        for (int t = 0; t < 16; ++t) {
            const int d = wj * 16 + t;
            if (d >= k) break;
            const int c = codes[i + (k - 1 - d)];
            ok &= c >= 0;
            word |= (unsigned)(c & 3) << (30 - 2 * t);
        }
        keys[i * W + wj] = word;
    }
    if (!ok) {
        for (int wj = 0; wj < W; ++wj) keys[i * W + wj] = kSentinel;
    }
    valid[i] = ok;
}

// ---- edge_src_probe: the four query runs merged against the masked list ----

constexpr int kMergeThreads = 256;  // threads a block
constexpr int kWinWords = 8192;     // key words a block stages: 32 KB of shared memory

// List keys in a block's share at most: its window (the share, one key
// either side, and up to three words before the first for 16-byte
// alignment) fits kWinWords.
template <int WMAX>
constexpr int merge_share() {
    return (kWinWords - 3) / WMAX - 2;
}

// Partitions of every run. A run holds at most n queries, so each
// partition's ceil((run + n) / parts) merge steps stay within the share.
inline int merge_parts(int n, int share) { return (int)((2LL * n + share - 1) / share); }

// The first x in [lo, hi) where f(x) is false, else hi, for f true then
// false on [lo, hi): a 32-ary search by the whole warp, one probe a lane a
// round, the ballot's true prefix picking the sub-range (five rounds for
// 2^22 keys where a binary search takes 22 dependent loads).
template <class F>
__device__ __forceinline__ int64_t warp_partition(int64_t lo, int64_t hi, F f) {
    const int lane = threadIdx.x & 31;
    while (lo < hi) {
        const int64_t step = (hi - lo + 31) >> 5;
        const int64_t x = lo + (lane + 1) * step - 1;
        const int cnt = __popc(__ballot_sync(0xFFFFFFFFu, x < hi && f(x)));
        const int64_t next = lo + cnt * step;
        hi = min(hi, next + step - 1);
        lo = next;
    }
    return lo;
}

__device__ __forceinline__ void cp_async4(unsigned* dst, const unsigned* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

__device__ __forceinline__ void cp_async16(unsigned* dst, const unsigned* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     (unsigned)__cvta_generic_to_shared(dst)),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// -1, 0, 1 as the staged key at s, with its first char cleared (word wi
// under mask), sorts before, equal to, after q.
template <int WMAX>
__device__ __forceinline__ int compare_staged(const unsigned* s, const Key<WMAX>& q, int W, int wi,
                                              unsigned mask) {
#pragma unroll
    for (int j = 0; j < WMAX; ++j) {
        if (j < W) {
            const unsigned a = j == wi ? s[j] & mask : s[j];
            if (a != q.w[j]) return a < q.w[j] ? -1 : 1;
        }
    }
    return 0;
}

// Whether two staged keys differ once their first chars are cleared.
template <int WMAX>
__device__ __forceinline__ bool differs_staged(const unsigned* a, const unsigned* b, int W, int wi,
                                               unsigned mask) {
    unsigned d = 0;
#pragma unroll
    for (int j = 0; j < WMAX; ++j) {
        if (j < W) d |= (a[j] ^ b[j]) & (j == wi ? mask : ~0u);
    }
    return d != 0;
}

// The merge steps of run c are its queries pred(j), j in [r0, r0 + len),
// and the n masked list keys, cut into `parts` partitions of `share` steps.
// Queries go first on ties, so the list keys before a query are exactly
// those below it: its lower bound. One warp a partition edge (c, p), p in
// [0, parts]: run c's bounds, and the split at diagonal d = p * share (the
// queries among the first d steps) into splits[c * (parts + 1) + p]; the
// warps of p = 0 write runs[c] = r0. Each search reads global memory a
// round at a time, so the searches of all edges run side by side here,
// not one after another in front of each block's work.
template <int WMAX>
__global__ void edge_src_split_kernel(const unsigned* __restrict__ keys, int n, int W, int k,
                                      int parts, int64_t* __restrict__ splits,
                                      int64_t* __restrict__ runs) {
    const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (e >= 4 * (int64_t)(parts + 1)) return;  // whole warps
    const int c = (int)(e / (parts + 1)), p = (int)(e % (parts + 1));
    auto run_at = [&](unsigned r) -> int64_t {
        return r == 0 ? 0 : r == 4 ? n : warp_partition(0, n, [&](int64_t x) {
            return (keys[x * W] >> 30) < r;
        });
    };
    const int64_t r0 = run_at(c), len = run_at(c + 1) - r0, total = len + n;
    const int64_t share = (total + parts - 1) / parts;
    const int64_t d = min((int64_t)p * share, total);
    const int64_t a = warp_partition(max((int64_t)0, d - n), min(d, len), [&](int64_t x) {
        const Key<WMAX> q = shift_left2(load_key<WMAX>(keys, r0 + x, W), W);
        Key<WMAX> m = load_key<WMAX>(keys, d - 1 - x, W);
        drop_first(m, k);
        return compare(q, m) <= 0;
    });
    if ((threadIdx.x & 31) == 0) {
        splits[e] = a;
        if (p == 0) runs[c] = r0;
    }
}

// Block (p, c) = (blockIdx.x / 4, blockIdx.x % 4): partition p of run c.
// It reads its splits (a0, b0) and (a1, b1), stages list keys b0 - 1 .. b1
// (every lower bound of its queries lies in [b0, b1]), and each thread
// settles queries by a binary search of the window. A hit sets is_src[j] =
// 0 and bit c of edges[lower bound] (a group start) by a word atomicOr:
// the runs' blocks write the same bytes. Run 0's blocks also mark the
// group starts of their list keys.
template <int WMAX>
__global__ void __launch_bounds__(kMergeThreads)
    edge_src_probe_kernel(const unsigned* __restrict__ keys, int n, int W, int k, int parts,
                          const int64_t* __restrict__ splits, const int64_t* __restrict__ runs,
                          unsigned* __restrict__ edge_words, uint8_t* __restrict__ gstart,
                          uint8_t* __restrict__ is_src) {
    __shared__ __align__(16) unsigned win[kWinWords];
    const int c = blockIdx.x & 3, p = blockIdx.x >> 2;
    const int wi = word_of(k - 1);
    const unsigned mask = ~(3u << shift_of(k - 1));
    const int64_t r0 = runs[c], len = (c == 3 ? n : runs[c + 1]) - r0, total = len + n;
    const int64_t share = (total + parts - 1) / parts;
    const int64_t d0 = min((int64_t)p * share, total), d1 = min(d0 + share, total);
    const int64_t* cut = splits + c * (int64_t)(parts + 1) + p;
    const int64_t a0 = cut[0], a1 = cut[1], b0 = d0 - a0, b1 = d1 - a1;
    if (c != 0 && a0 == a1) return;

    // stage list keys w0 .. w1 - 1, global words g0 .. g1 - 1; win[0] holds
    // word base, so 16-byte copies land 16-byte aligned
    const int64_t w0 = max(b0 - 1, (int64_t)0), w1 = min(b1 + 1, (int64_t)n);
    const int64_t g0 = w0 * W, g1 = w1 * W, base = g0 & ~(int64_t)3;
    const bool by16 = ((uintptr_t)keys & 15u) == 0;
    const int64_t body0 = by16 ? min((g0 + 3) & ~(int64_t)3, g1) : g1;
    const int64_t body1 = by16 ? max(body0, g1 & ~(int64_t)3) : g1;
    for (int64_t g = g0 + threadIdx.x; g < body0; g += kMergeThreads) {
        cp_async4(win + (g - base), keys + g);
    }
    for (int64_t g = body0 + 4 * threadIdx.x; g < body1; g += 4 * kMergeThreads) {
        cp_async16(win + (g - base), keys + g);
    }
    for (int64_t g = body1 + threadIdx.x; g < g1; g += kMergeThreads) {
        cp_async4(win + (g - base), keys + g);
    }
    cp_async_wait_all();
    __syncthreads();
    const unsigned* first = win + (g0 - base);  // list key w0
    auto key_at = [&](int64_t x) { return first + (int)(x - w0) * W; };

    if (c == 0) {
        for (int64_t i = b0 + threadIdx.x; i < b1; i += kMergeThreads) {
            gstart[i] = i == 0 || differs_staged<WMAX>(key_at(i), key_at(i - 1), W, wi, mask);
        }
    }
    for (int64_t a = a0 + threadIdx.x; a < a1; a += kMergeThreads) {
        const int64_t j = r0 + a;
        const Key<WMAX> q = shift_left2(load_key<WMAX>(keys, j, W), W);
        int64_t lo = b0, hi = b1;
        while (lo < hi) {
            const int64_t mid = (lo + hi) >> 1;
            if (compare_staged(key_at(mid), q, W, wi, mask) < 0) {
                lo = mid + 1;
            } else {
                hi = mid;
            }
        }
        const bool hit = lo < n && compare_staged(key_at(lo), q, W, wi, mask) == 0;
        is_src[j] = !hit;
        if (hit) atomicOr(edge_words + (lo >> 2), (1u << c) << (8 * (lo & 3)));
    }
}

template <int WMAX>
int launch_edge_src_probe(const void* keys, int n, int W, int k, void* edges, void* gstart,
                          void* is_src, void* scratch, cudaStream_t s) {
    const int parts = merge_parts(n, merge_share<WMAX>());
    int64_t* splits = (int64_t*)scratch;
    int64_t* runs = splits + 4 * (int64_t)(parts + 1);
    const int64_t edges_per_block = kMergeThreads / 32, n_edges = 4 * (int64_t)(parts + 1);
    edge_src_split_kernel<WMAX><<<(unsigned)((n_edges + edges_per_block - 1) / edges_per_block),
                                  kMergeThreads, 0, s>>>(
        (const unsigned*)keys, n, W, k, parts, splits, runs);
    edge_src_probe_kernel<WMAX><<<4u * parts, kMergeThreads, 0, s>>>(
        (const unsigned*)keys, n, W, k, parts, splits, runs, (unsigned*)edges, (uint8_t*)gstart,
        (uint8_t*)is_src);
    return (int)cudaGetLastError();
}

// One thread per (source, length l in 0..k-1): the l-char prefix as a key,
// its length and its edge char (the source's char at index l); the last
// thread writes the root (length 0, no edge).
__global__ void emit_dummies_kernel(const unsigned* __restrict__ src, int64_t n_src, int k, int W,
                                    unsigned* __restrict__ out_keys, int* __restrict__ out_len,
                                    int* __restrict__ out_edge) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t total = n_src * k + 1;
    if (t >= total) return;
    if (t == total - 1) {
        for (int j = 0; j < W; ++j) out_keys[t * W + j] = 0u;
        out_len[t] = 0;
        out_edge[t] = -1;
        return;
    }
    const int64_t s = t / k;
    const int l = (int)(t % k);
    const unsigned* row = src + s * W;
    const int shift = 2 * (k - l);
    const int ws = shift >> 5, b = shift & 31;
    for (int j = 0; j < W; ++j) {
        const unsigned cur = j + ws < W ? row[j + ws] : 0u;
        const unsigned next = (b != 0 && j + ws + 1 < W) ? row[j + ws + 1] : 0u;
        out_keys[t * W + j] = b == 0 ? cur : ((cur << b) | (next >> (32 - b)));
    }
    const int d = k - 1 - l;
    out_len[t] = l;
    out_edge[t] = (int)((row[word_of(d)] >> shift_of(d)) & 3u);
}

// One thread per column of the merged, sorted nodes, one warp per output
// word: the streaming mark (the node's suffix key and length differ from
// the left neighbour's), then a ballot packs the four edge rows and the
// marks 32 columns per word, with each edge word's popcount.
template <int WMAX>
__global__ void finalize_tables_kernel(const unsigned* __restrict__ keys,
                                       const int* __restrict__ len,
                                       const uint8_t* __restrict__ edges, int64_t T, int W, int k,
                                       int64_t n_words, unsigned* __restrict__ rank_words,
                                       int* __restrict__ pops, unsigned* __restrict__ sgs_words) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    const int64_t w = t >> 5;
    if (w >= n_words) return;  // whole warps leave together
    const bool active = t < T;
    const unsigned e = active ? edges[t] : 0u;
    bool mark = false;
    if (sgs_words != nullptr && active) {
        mark = true;
        if (t > 0) {
            Key<WMAX> a = load_key<WMAX>(keys, t, W), b = load_key<WMAX>(keys, t - 1, W);
            int la = len[t], lb = len[t - 1];
            if (la == k) {
                drop_first(a, k);
                la = k - 1;
            }
            if (lb == k) {
                drop_first(b, k);
                lb = k - 1;
            }
            mark = la != lb || compare(a, b) != 0;
        }
    }
    const bool lane0 = (threadIdx.x & 31) == 0;
    for (int c = 0; c < 4; ++c) {
        const unsigned word = __ballot_sync(0xFFFFFFFFu, (e >> c) & 1u);
        if (lane0) {
            rank_words[c * n_words + w] = word;
            pops[c * n_words + w] = __popc(word);
        }
    }
    if (sgs_words != nullptr) {
        const unsigned word = __ballot_sync(0xFFFFFFFFu, mark);
        if (lane0) sgs_words[w] = word;
    }
}

}  // namespace

extern "C" int sbwt_pack_windows(int device, const void* codes, long long m, int k, void* keys,
                                 void* valid, void* stream) {
    cudaSetDevice(device);
    pack_windows_kernel<<<sbwt::grid_for(m), sbwt::kBlock, 0, (cudaStream_t)stream>>>(
        (const int8_t*)codes, m, k, (k + 15) / 16, (unsigned*)keys, (uint8_t*)valid);
    return (int)cudaGetLastError();
}

// n >= 1. edges: 4-byte aligned, room for (n + 3) / 4 words, zeroed here:
// the kernel ORs each edge bit into its word. scratch: int64, 4 * (parts +
// 1) + 4 of them, parts = ceil(2 n / sbwt_edge_src_share(k)).
extern "C" int sbwt_edge_src_probe(int device, const void* keys, int n, int k, void* edges,
                                   void* gstart, void* is_src, void* scratch, void* stream) {
    cudaSetDevice(device);
    const int W = (k + 15) / 16;
    cudaStream_t s = (cudaStream_t)stream;
    if (const cudaError_t e = cudaMemsetAsync(edges, 0, ((size_t)n + 3) & ~(size_t)3, s)) {
        return (int)e;
    }
    if (W <= 2) return launch_edge_src_probe<2>(keys, n, W, k, edges, gstart, is_src, scratch, s);
    if (W <= 4) return launch_edge_src_probe<4>(keys, n, W, k, edges, gstart, is_src, scratch, s);
    return launch_edge_src_probe<16>(keys, n, W, k, edges, gstart, is_src, scratch, s);
}

// The list keys a block of edge_src_probe takes at most at this k.
extern "C" int sbwt_edge_src_share(int k) {
    const int W = (k + 15) / 16;
    return W <= 2 ? merge_share<2>() : W <= 4 ? merge_share<4>() : merge_share<16>();
}

extern "C" int sbwt_emit_dummies(int device, const void* src, long long n_src, int k,
                                 void* out_keys, void* out_len, void* out_edge, void* stream) {
    cudaSetDevice(device);
    emit_dummies_kernel<<<sbwt::grid_for(n_src * k + 1), sbwt::kBlock, 0, (cudaStream_t)stream>>>(
        (const unsigned*)src, n_src, k, (k + 15) / 16, (unsigned*)out_keys, (int*)out_len,
        (int*)out_edge);
    return (int)cudaGetLastError();
}

// sgs_words is null without streaming support.
extern "C" int sbwt_finalize_tables(int device, const void* keys, const void* len,
                                    const void* edges, long long T, int k, long long n_words,
                                    void* rank_words, void* pops, void* sgs_words, void* stream) {
    cudaSetDevice(device);
    const int W = (k + 15) / 16;
    const unsigned grid = sbwt::grid_for(n_words * 32);
    cudaStream_t s = (cudaStream_t)stream;
    if (W <= 2) {
        finalize_tables_kernel<2><<<grid, sbwt::kBlock, 0, s>>>(
            (const unsigned*)keys, (const int*)len, (const uint8_t*)edges, T, W, k, n_words,
            (unsigned*)rank_words, (int*)pops, (unsigned*)sgs_words);
    } else if (W <= 4) {
        finalize_tables_kernel<4><<<grid, sbwt::kBlock, 0, s>>>(
            (const unsigned*)keys, (const int*)len, (const uint8_t*)edges, T, W, k, n_words,
            (unsigned*)rank_words, (int*)pops, (unsigned*)sgs_words);
    } else {
        finalize_tables_kernel<16><<<grid, sbwt::kBlock, 0, s>>>(
            (const unsigned*)keys, (const int*)len, (const uint8_t*)edges, T, W, k, n_words,
            (unsigned*)rank_words, (int*)pops, (unsigned*)sgs_words);
    }
    return (int)cudaGetLastError();
}
