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
// run's leading tag", five full sorts of 2m rows. Here the sorted distinct
// k-mer list is searched directly: a W-word lower bound per query. Dropping
// a key's first char clears its least significant bits, which keeps the
// list's order, so the predecessor test searches the same list under a
// mask and no compacted copy of the suffix-group representatives exists.
//
// Bounds on the H100: pack_windows, emit_dummies and finalize_tables are
// bound by bytes (each writes or reads W words a row once); edge_src_probe
// is bound by the latency of its log2(n) dependent key loads per search,
// five searches per suffix-group start, into a list that fits L2 at the
// bench size (32 MB). Keys live in registers: the kernels are templated on
// a word capacity WMAX (2, 4 or 16) with the true W a runtime value.
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

// Shift right by one char and put c at the end (distance 0).
template <int WMAX>
__device__ __forceinline__ Key<WMAX> append_last(const Key<WMAX>& a, unsigned c, int W) {
    Key<WMAX> out;
#pragma unroll
    for (int j = 0; j < WMAX; ++j) {
        const unsigned carry = j == 0 ? c : (a.w[j > 0 ? j - 1 : 0] & 3u);
        out.w[j] = j < W ? ((a.w[j] >> 2) | (carry << 30)) : 0u;
    }
    return out;
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

// Whether q is among the n sorted keys, each seen with its first char
// cleared when MASKED (the list stays sorted under the mask).
template <int WMAX, bool MASKED>
__device__ __forceinline__ bool member(const unsigned* __restrict__ keys, int n, int W, int k,
                                       const Key<WMAX>& q) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = lo + ((hi - lo) >> 1);
        Key<WMAX> a = load_key<WMAX>(keys, mid, W);
        if (MASKED) drop_first(a, k);
        if (compare(a, q) < 0) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    if (lo >= n) return false;
    Key<WMAX> a = load_key<WMAX>(keys, lo, W);
    if (MASKED) drop_first(a, k);
    return compare(a, q) == 0;
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

// One thread per sorted distinct k-mer: suffix-group start, and for a
// start the four out-edges of its group and, for every k-mer, whether it
// has no predecessor (a source).
template <int WMAX>
__global__ void edge_src_probe_kernel(const unsigned* __restrict__ keys, int n, int W, int k,
                                      uint8_t* __restrict__ edges, uint8_t* __restrict__ gstart,
                                      uint8_t* __restrict__ is_src) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const Key<WMAX> self = load_key<WMAX>(keys, i, W);
    Key<WMAX> suffix = self;
    drop_first(suffix, k);
    bool start = true;
    if (i > 0) {
        Key<WMAX> left = load_key<WMAX>(keys, i - 1, W);
        drop_first(left, k);
        start = compare(suffix, left) != 0;
    }
    unsigned e = 0;
    if (start) {
        // only the group's first column carries its edge bits
        for (unsigned c = 0; c < 4; ++c) {
            const Key<WMAX> y = append_last(suffix, c, W);
            if (member<WMAX, false>(keys, n, W, k, y)) e |= 1u << c;
        }
    }
    edges[i] = (uint8_t)e;
    gstart[i] = start;
    // the (k-1)-prefix among the k-mers' (k-1)-suffixes
    const Key<WMAX> pred = shift_left2(self, W);
    is_src[i] = !member<WMAX, true>(keys, n, W, k, pred);
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

extern "C" int sbwt_edge_src_probe(int device, const void* keys, int n, int k, void* edges,
                                   void* gstart, void* is_src, void* stream) {
    cudaSetDevice(device);
    const int W = (k + 15) / 16;
    const unsigned grid = sbwt::grid_for(n);
    cudaStream_t s = (cudaStream_t)stream;
    if (W <= 2) {
        edge_src_probe_kernel<2><<<grid, sbwt::kBlock, 0, s>>>(
            (const unsigned*)keys, n, W, k, (uint8_t*)edges, (uint8_t*)gstart, (uint8_t*)is_src);
    } else if (W <= 4) {
        edge_src_probe_kernel<4><<<grid, sbwt::kBlock, 0, s>>>(
            (const unsigned*)keys, n, W, k, (uint8_t*)edges, (uint8_t*)gstart, (uint8_t*)is_src);
    } else {
        edge_src_probe_kernel<16><<<grid, sbwt::kBlock, 0, s>>>(
            (const unsigned*)keys, n, W, k, (uint8_t*)edges, (uint8_t*)gstart, (uint8_t*)is_src);
    }
    return (int)cudaGetLastError();
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
