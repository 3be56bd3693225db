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
// and, for the ranged build of construct/device.py (an index whose windows
// do not fit the card at once; the JAX program has none):
//   pack_range       one pass over the codes: pack_windows' staging, then
//                    only the valid windows of a range of keys (the nodes)
//                    and those whose (k-1)-prefix lies in it (the out-edges
//                    of its suffix groups), appended warp by warp
// edge_src_probe then takes the range's nodes as the list and its out-edges
// as the queries, and finalize_tables writes the range's columns from a bit
// offset inside the first word. Counts are 64-bit throughout.
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
// pack_windows gives a warp a run of windows and each lane R consecutive
// ones: the warp stages their codes with 16-byte loads and packs each
// code once into 2-bit chars, a key word is one funnel shift of two char
// words, and the warp writes its keys as one contiguous span.
// finalize_tables gives a lane one column of each of a warp's output
// words, takes the left neighbour's key by shuffles, and a block writes
// each output row as one contiguous run.
//
// Bounds on the H100: all five kernels are bound by bytes; pack_range reads
// the codes once and writes the selected keys once. pack_windows,
// emit_dummies and finalize_tables write or read W words a row once;
// edge_src_probe reads each run's keys once and the list once a run (four
// times; the blocks of the four runs at one partition run side by side, so
// their windows of the list meet in L2) and writes three bytes a k-mer.
// Keys live in registers: the kernels are templated on a word capacity WMAX
// (2, 4 or 16) with the true W a runtime value.
#include "sbwt_common.cuh"
#include "stream_tile.cuh"

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

// ---- pack_windows: a warp's run of windows, its codes packed once ----

constexpr int kPackWarps = 4;  // warps a block

// Windows a lane takes. Fewer at W = 16, so that a block's staged keys fit
// 48 KB of static shared memory.
template <int WMAX>
__host__ __device__ constexpr int pack_run() {
    return WMAX == 16 ? 4 : 8;
}

// A staged key word's place: one pad word after every 32, so that the
// lanes' rows (R W words apart) fall in different banks.
__device__ __forceinline__ int key_slot(int i) { return i + (i >> 5); }

// The 16 codes of one 16-byte chunk (four little-endian words) as 2-bit
// chars, char i at bits 2i, and a mask of those < 0, bit i for char i.
__device__ __forceinline__ void pack_chunk(const unsigned* v, unsigned* chars, unsigned* bad) {
    unsigned pk = 0, neg = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        unsigned t = v[q] & 0x03030303u;
        t |= t >> 6;  // byte 0: c0 | c1 << 2, byte 2: c2 | c3 << 2
        pk |= ((t & 0xFu) | ((t >> 12) & 0xF0u)) << (8 * q);
        const unsigned sg = v[q] & 0x80808080u;
        neg |= (((sg >> 7) | (sg >> 14) | (sg >> 21) | (sg >> 28)) & 0xFu) << (4 * q);
    }
    *chars = pk;
    *bad = neg;
}

// Where pack_range sends a window: the node keys, the top `bits` bits of
// word 0 (the key's last chars) in [lo, hi), go to `nodes`, and the keys
// whose (k-1)-prefix (the key shifted left by one char) has its top bits
// there go to `edges`; `count` holds the two counts so far. A range of
// such buckets never splits a suffix group (bits <= 2 (k - 1), so the
// first char is never among them).
struct RangeSink {
    unsigned lo, hi;
    int bits;
    unsigned* nodes;
    unsigned* edges;
    long long cap_nodes, cap_edges;
    unsigned long long* count;
};

__device__ __forceinline__ bool in_range(const RangeSink& s, unsigned word0) {
    // 64-bit, so that bits = 0 (k = 1: one bucket) shifts every bit out
    const unsigned b = (unsigned)((unsigned long long)word0 >> (32 - s.bits));
    return b >= s.lo && b < s.hi;
}

// The warp's selected windows (bit r of a lane's mask: its window r0 + r)
// appended to out at the warp's share of *count, W words each.
template <int R>
__device__ __forceinline__ void append_selected(const unsigned* sk, int r0, int W, unsigned mask,
                                                unsigned* out, long long cap,
                                                unsigned long long* count) {
    const int lane = threadIdx.x & 31;
    const int mine = __popc(mask);
    int incl = mine;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, incl, o);
        if (lane >= o) incl += v;
    }
    unsigned long long base = 0;
    if (lane == 31 && incl > 0) base = atomicAdd(count, (unsigned long long)incl);
    base = __shfl_sync(0xFFFFFFFFu, base, 31);
    long long at = (long long)base + incl - mine;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if ((mask >> r) & 1u) {
            if (at < cap) {
                for (int j = 0; j < W; ++j) out[at * W + j] = sk[key_slot((r0 + r) * W + j)];
            }
            ++at;
        }
    }
}

// A warp owns 32 R consecutive windows, lane l windows l R .. l R + R - 1
// of them. The warp stages the codes they cover with 16-byte loads, from
// the chunk 16 bytes before the first, and each lane turns the chunks it
// loaded into 2-bit chars (one word a chunk) and a mask of codes < 0, so
// each code is packed once, not once a window that holds it. A key word
// is then one funnel shift of two neighbouring char words: word j of
// window x holds chars x + k - 16 (j + 1) .. x + k - 16 j - 1, the lowest
// at bits 0-1 (so the last char, at distance 0 from the end, sits at bits
// 30-31 of word 0); the last word drops the chars before x. A lane finds
// the last code < 0 of its first window in the masks and then tests one
// char a window: a window is valid when that lies before it. Its R valid
// bytes go out as one R-byte store, its keys into the warp's staged keys,
// which the warp writes as one contiguous span with 16-byte stores. A
// window holding a code < 0 gets kSentinel in every word.
// kRange (pack_range_kernel): no keys or valid bytes are written; each
// lane tests its valid windows against the sink's range and the warp
// appends the selected keys from its staged ones, in no fixed order.
template <int WMAX, bool kRange>
__device__ __forceinline__ void pack_warp(const int8_t* __restrict__ codes, int64_t m, int k,
                                          int W, unsigned* __restrict__ keys,
                                          uint8_t* __restrict__ valid, const RangeSink& sink) {
    constexpr int R = pack_run<WMAX>();
    constexpr int kSpan = 32 * R;  // windows a warp
    constexpr int kChunks = (kSpan + 16 * WMAX + 31 + 15) / 16 + 1;
    constexpr int kKeyWords = kSpan * WMAX;
    __shared__ __align__(16) unsigned s_codes[kPackWarps][4 * kChunks];
    __shared__ unsigned s_chars[kPackWarps][kChunks];
    __shared__ unsigned s_bad[kPackWarps][kChunks];
    __shared__ unsigned s_keys[kPackWarps][kKeyWords + kKeyWords / 32];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t w0 = ((int64_t)blockIdx.x * kPackWarps + warp) * kSpan;
    if (w0 >= m) return;  // whole warps
    const int nwin = (int)min((int64_t)kSpan, m - w0);
    const uintptr_t lo = (uintptr_t)codes, hi = lo + (uintptr_t)(m + k - 1);
    const uintptr_t g = lo + (uintptr_t)w0;  // window 0's first char
    const uintptr_t at0 = (g - 16) & ~(uintptr_t)15;
    const int base = (int)(g - at0);  // its staged byte offset, 16..31
    const int chunks = (int)((g + nwin + k - 1 - at0 + 15) / 16);
    unsigned* chars = s_chars[warp];
    unsigned* bads = s_bad[warp];
    for (int i = lane; i < chunks; i += 32) {
        unsigned* st = s_codes[warp] + 4 * i;
        sbwt::stage_chunk(at0 + 16 * i, lo, hi, st);  // bytes outside the codes: no window's
        pack_chunk(st, chars + i, bads + i);
    }
    __syncwarp();
    unsigned* sk = s_keys[warp];
    const int r0 = lane * R;
    unsigned sel_nodes = 0, sel_edges = 0;  // kRange: bit r, window r0 + r
    if (r0 < nwin) {
        const int last = k - 16 * (W - 1);  // chars in the last word
        const unsigned top = last == 16 ? ~0u : ~(~0u >> (2 * last));
        // the last code < 0 up to window r0's last char, as a window-relative
        // position (one before r0 is as good as none)
        int bad = -1;
        for (int o = r0 + k - 1 + base; o >= r0 + base;) {
            const int ci = o >> 4;
            const unsigned hit = bads[ci] & (0xFFFFu >> (15 - (o & 15)));
            if (hit) {
                bad = 16 * ci + 31 - __clz(hit) - base;
                break;
            }
            o = 16 * ci - 1;
        }
        unsigned ok[R / 4] = {};  // the valid bytes, four a word
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int x = r0 + r;
            if (x < nwin) {
                if (r > 0) {
                    const int o = x + k - 1 + base;
                    if ((bads[o >> 4] >> (o & 15)) & 1u) bad = x + k - 1;
                }
                const bool good = bad < x;
                ok[r / 4] |= (unsigned)good << (8 * (r % 4));
                // word j = chars of chunks c0 + W - 1 - j and the next, shifted by sh
                const int p0 = x + k - 16 * W + base, c0 = p0 >> 4, sh = 2 * (p0 & 15);
                unsigned h[WMAX + 1];  // h[i]: char word c0 + W - i
#pragma unroll
                for (int i = 0; i <= WMAX; ++i) h[i] = i <= W ? chars[c0 + W - i] : 0u;
#pragma unroll
                for (int j = 0; j < WMAX; ++j) {
                    if (j < W) {
                        unsigned word = __funnelshift_r(h[j + 1], h[j], sh);
                        if (j == W - 1) word &= top;
                        sk[key_slot(x * W + j)] = good ? word : kSentinel;
                    }
                }
            }
        }
        if constexpr (kRange) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if (r0 + r < nwin && ((ok[r / 4] >> (8 * (r % 4))) & 1u)) {
                    // the (k-1)-prefix's word 0 is (a0 << 2) | (word 1 >> 30), whose
                    // low 2 bits lie below the bucket's (bits <= 16)
                    const unsigned a0 = sk[key_slot((r0 + r) * W)];
                    sel_nodes |= (unsigned)in_range(sink, a0) << r;
                    sel_edges |= (unsigned)in_range(sink, a0 << 2) << r;
                }
            }
        } else {
            uint8_t* v_out = valid + w0 + r0;
            if (r0 + R <= nwin && ((uintptr_t)v_out & (R - 1)) == 0) {
                if constexpr (R == 8) {
                    *reinterpret_cast<uint2*>(v_out) = make_uint2(ok[0], ok[1]);
                } else {
                    *reinterpret_cast<unsigned*>(v_out) = ok[0];
                }
            } else {
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    if (r0 + r < nwin) v_out[r] = (uint8_t)(ok[r / 4] >> (8 * (r % 4)));
                }
            }
        }
    }
    if constexpr (kRange) {
        append_selected<R>(sk, r0, W, sel_nodes, sink.nodes, sink.cap_nodes, sink.count);
        append_selected<R>(sk, r0, W, sel_edges, sink.edges, sink.cap_edges, sink.count + 1);
        return;
    }
    __syncwarp();
    // the warp's keys, words [w0 W, (w0 + nwin) W): a 16-byte chunk never
    // straddles a pad word
    const int words = nwin * W;
    unsigned* out = keys + w0 * W;
    const int vec_words = ((uintptr_t)out & 15) == 0 ? words & ~3 : 0;
    for (int i = 4 * lane; i < vec_words; i += 4 * 32) {
        const unsigned* s = sk + key_slot(i);
        *reinterpret_cast<uint4*>(out + i) = make_uint4(s[0], s[1], s[2], s[3]);
    }
    for (int i = vec_words + lane; i < words; i += 32) out[i] = sk[key_slot(i)];
}

template <int WMAX>
__global__ void __launch_bounds__(kPackWarps * 32)
    pack_windows_kernel(const int8_t* __restrict__ codes, int64_t m, int k, int W,
                        unsigned* __restrict__ keys, uint8_t* __restrict__ valid) {
    pack_warp<WMAX, false>(codes, m, k, W, keys, valid, RangeSink{});
}

template <int WMAX>
__global__ void __launch_bounds__(kPackWarps * 32)
    pack_range_kernel(const int8_t* __restrict__ codes, int64_t m, int k, int W, RangeSink sink) {
    pack_warp<WMAX, true>(codes, m, k, W, nullptr, nullptr, sink);
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

// Partitions of every run. A run holds at most nq queries, so each
// partition's ceil((run + n) / parts) merge steps stay within the share.
inline int64_t merge_parts(int64_t n, int64_t nq, int share) {
    return (n + nq + share - 1) / share;
}

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

// The queries are the keys of `qkeys` [nq] and the list those of `keys`
// [n]: the same array in the whole build; in a range of the ranged build
// the range's k-mers whose (k-1)-prefix lies in the range, and the
// range's k-mers. The merge steps of run c are its queries pred(j), j in
// [r0, r0 + len), and the n masked list keys, cut into `parts` partitions
// of `share` steps.
// Queries go first on ties, so the list keys before a query are exactly
// those below it: its lower bound. One warp a partition edge (c, p), p in
// [0, parts]: run c's bounds, and the split at diagonal d = p * share (the
// queries among the first d steps) into splits[c * (parts + 1) + p]; the
// warps of p = 0 write runs[c] = r0. Each search reads global memory a
// round at a time, so the searches of all edges run side by side here,
// not one after another in front of each block's work.
template <int WMAX>
__global__ void edge_src_split_kernel(const unsigned* __restrict__ keys, int64_t n,
                                      const unsigned* __restrict__ qkeys, int64_t nq, int W, int k,
                                      int64_t parts, int64_t* __restrict__ splits,
                                      int64_t* __restrict__ runs) {
    const int64_t e = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    if (e >= 4 * (parts + 1)) return;  // whole warps
    const int c = (int)(e / (parts + 1));
    const int64_t p = e % (parts + 1);
    auto run_at = [&](unsigned r) -> int64_t {
        return r == 0 ? 0 : r == 4 ? nq : warp_partition(0, nq, [&](int64_t x) {
            return (qkeys[x * W] >> 30) < r;
        });
    };
    const int64_t r0 = run_at(c), len = run_at(c + 1) - r0, total = len + n;
    const int64_t share = (total + parts - 1) / parts;
    const int64_t d = min(p * share, total);
    const int64_t a = warp_partition(max((int64_t)0, d - n), min(d, len), [&](int64_t x) {
        const Key<WMAX> q = shift_left2(load_key<WMAX>(qkeys, r0 + x, W), W);
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
    edge_src_probe_kernel(const unsigned* __restrict__ keys, int64_t n,
                          const unsigned* __restrict__ qkeys, int64_t nq, int W, int k,
                          int64_t parts, const int64_t* __restrict__ splits,
                          const int64_t* __restrict__ runs, unsigned* __restrict__ edge_words,
                          uint8_t* __restrict__ gstart, uint8_t* __restrict__ is_src) {
    __shared__ __align__(16) unsigned win[kWinWords];
    const int c = blockIdx.x & 3;
    const int64_t p = blockIdx.x >> 2;
    const int wi = word_of(k - 1);
    const unsigned mask = ~(3u << shift_of(k - 1));
    const int64_t r0 = runs[c], len = (c == 3 ? nq : runs[c + 1]) - r0, total = len + n;
    const int64_t share = (total + parts - 1) / parts;
    const int64_t d0 = min(p * share, total), d1 = min(d0 + share, total);
    const int64_t* cut = splits + c * (parts + 1) + p;
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
        const Key<WMAX> q = shift_left2(load_key<WMAX>(qkeys, j, W), W);
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
int launch_edge_src_probe(const void* keys, int64_t n, const void* qkeys, int64_t nq, int W, int k,
                          void* edges, void* gstart, void* is_src, void* scratch, cudaStream_t s) {
    const int64_t parts = merge_parts(n, nq, merge_share<WMAX>());
    int64_t* splits = (int64_t*)scratch;
    int64_t* runs = splits + 4 * (parts + 1);
    const int64_t edges_per_block = kMergeThreads / 32, n_edges = 4 * (parts + 1);
    edge_src_split_kernel<WMAX><<<(unsigned)((n_edges + edges_per_block - 1) / edges_per_block),
                                  kMergeThreads, 0, s>>>(
        (const unsigned*)keys, n, (const unsigned*)qkeys, nq, W, k, parts, splits, runs);
    edge_src_probe_kernel<WMAX><<<(unsigned)(4 * parts), kMergeThreads, 0, s>>>(
        (const unsigned*)keys, n, (const unsigned*)qkeys, nq, W, k, parts, splits, runs,
        (unsigned*)edges, (uint8_t*)gstart, (uint8_t*)is_src);
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

// ---- finalize_tables: the edge rows, their popcounts and the marks ----

constexpr int kFinalWarps = 4;  // warps a block
constexpr int kFinalRounds = 4;  // output words a warp: each lane's columns
constexpr int kFinalWords = kFinalWarps * kFinalRounds;  // output words a block

// Key i of the rows [n, W], with 16-byte loads (8-byte at W = 2) where vec
// holds: W == WMAX and a row's start aligned to them. Evict-first: each
// key is read once.
template <int WMAX>
__device__ __forceinline__ Key<WMAX> load_key_vec(const unsigned* __restrict__ keys, int64_t i,
                                                  int W, bool vec) {
    if (!vec) return load_key<WMAX>(keys, i, W);
    Key<WMAX> a;
    if constexpr (WMAX == 2) {
        const uint2 v = __ldcs(reinterpret_cast<const uint2*>(keys + 2 * i));
        a.w[0] = v.x;
        a.w[1] = v.y;
    } else {
#pragma unroll
        for (int j = 0; j < WMAX; j += 4) {
            const uint4 v = __ldcs(reinterpret_cast<const uint4*>(keys + i * WMAX + j));
            a.w[j] = v.x;
            a.w[j + 1] = v.y;
            a.w[j + 2] = v.z;
            a.w[j + 3] = v.w;
        }
    }
    return a;
}

template <int WMAX>
__device__ __forceinline__ Key<WMAX> shfl_key(const Key<WMAX>& a, int src, bool up) {
    Key<WMAX> b;
#pragma unroll
    for (int j = 0; j < WMAX; ++j) {
        b.w[j] = up ? __shfl_up_sync(0xFFFFFFFFu, a.w[j], 1)
                    : __shfl_sync(0xFFFFFFFFu, a.w[j], src);
    }
    return b;
}

// A warp owns kFinalRounds output words, 32 columns each: in round q lane
// l takes column 32 q + l of them, so each ballot is one output word.
// Every lane loads all its columns first (its key with vector loads, its
// length and edge nibble, all evict-first); with streaming it drops a full k-mer's first char and
// takes its left neighbour's key and length from lane l - 1 by shuffles,
// lane 0 from lane 31 of the round before, and only the warp's first
// column loads its neighbour. The mark: the column is the first or differs
// from its neighbour. The four edge ballots and the mark ballot of each
// round go to shared memory, and the block writes each of the nine output
// runs (four rank rows, four popcount rows, the marks) as kFinalWords
// contiguous words. Column t sits at bit lead + t (lead < 32: a range of
// the ranged build that starts inside a word; 0 in the whole build).
template <int WMAX>
__global__ void __launch_bounds__(kFinalWarps * 32)
    finalize_tables_kernel(const unsigned* __restrict__ keys, const int* __restrict__ len,
                           const uint8_t* __restrict__ edges, int64_t T, int W, int k,
                           int64_t n_words, int lead, unsigned* __restrict__ rank_words,
                           int* __restrict__ pops, unsigned* __restrict__ sgs_words) {
    constexpr int Q = kFinalRounds;
    __shared__ unsigned s_out[5][kFinalWords];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int64_t col0 = ((int64_t)blockIdx.x * kFinalWords + warp * Q) * 32 - lead;
    const bool streaming = sgs_words != nullptr;
    const bool vec = W == WMAX && ((uintptr_t)keys & (WMAX == 2 ? 7 : 15)) == 0;
    unsigned e[Q];
    Key<WMAX> a[Q];
    int la[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int64_t t = col0 + 32 * q + lane;
        const bool act = t >= 0 && t < T;
        e[q] = act ? __ldcs(edges + t) : 0u;
        la[q] = -1;
        a[q] = Key<WMAX>{};
        if (streaming && act) {
            a[q] = load_key_vec<WMAX>(keys, t, W, vec);
            la[q] = __ldcs(len + t);
        }
    }
    Key<WMAX> prev{};  // lane 0: the left neighbour of this round's column
    int lprev = -1;
    if (streaming && lane == 0 && col0 > 0 && col0 <= T) {
        prev = load_key_vec<WMAX>(keys, col0 - 1, W, vec);
        lprev = len[col0 - 1];
        if (lprev == k) {
            drop_first(prev, k);
            lprev = k - 1;
        }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int64_t t = col0 + 32 * q + lane;
        bool mark = false;
        if (streaming) {
            if (la[q] == k) {
                drop_first(a[q], k);
                la[q] = k - 1;
            }
            Key<WMAX> left = shfl_key(a[q], 0, true);
            int ll = __shfl_up_sync(0xFFFFFFFFu, la[q], 1);
            if (lane == 0) {
                left = prev;
                ll = lprev;
            }
            mark = t >= 0 && t < T && (t == 0 || ll != la[q] || compare(a[q], left) != 0);
            prev = shfl_key(a[q], 31, false);
            lprev = __shfl_sync(0xFFFFFFFFu, la[q], 31);
        }
        const unsigned b0 = __ballot_sync(0xFFFFFFFFu, e[q] & 1u);
        const unsigned b1 = __ballot_sync(0xFFFFFFFFu, e[q] & 2u);
        const unsigned b2 = __ballot_sync(0xFFFFFFFFu, e[q] & 4u);
        const unsigned b3 = __ballot_sync(0xFFFFFFFFu, e[q] & 8u);
        const unsigned bm = __ballot_sync(0xFFFFFFFFu, mark);
        if (lane < 5) {
            s_out[lane][warp * Q + q] =
                lane == 0 ? b0 : lane == 1 ? b1 : lane == 2 ? b2 : lane == 3 ? b3 : bm;
        }
    }
    __syncthreads();
    const int64_t word0 = (int64_t)blockIdx.x * kFinalWords;
    for (int i = threadIdx.x; i < 9 * kFinalWords; i += kFinalWarps * 32) {
        const int row = i / kFinalWords, j = i % kFinalWords;
        const int64_t w = word0 + j;
        if (w >= n_words) continue;
        if (row < 4) {
            rank_words[row * n_words + w] = s_out[row][j];
        } else if (row < 8) {
            pops[(row - 4) * n_words + w] = __popc(s_out[row - 4][j]);
        } else if (streaming) {
            sgs_words[w] = s_out[4][j];
        }
    }
}

template <int WMAX>
unsigned pack_grid(int64_t m) {
    const int64_t per_block = (int64_t)kPackWarps * 32 * pack_run<WMAX>();
    return (unsigned)((m + per_block - 1) / per_block);
}

template <int WMAX>
int launch_pack_windows(const void* codes, int64_t m, int k, void* keys, void* valid,
                        cudaStream_t s) {
    pack_windows_kernel<WMAX><<<pack_grid<WMAX>(m), kPackWarps * 32, 0, s>>>(
        (const int8_t*)codes, m, k, (k + 15) / 16, (unsigned*)keys, (uint8_t*)valid);
    return (int)cudaGetLastError();
}

template <int WMAX>
int launch_pack_range(const void* codes, int64_t m, int k, const RangeSink& sink,
                      cudaStream_t s) {
    pack_range_kernel<WMAX><<<pack_grid<WMAX>(m), kPackWarps * 32, 0, s>>>(
        (const int8_t*)codes, m, k, (k + 15) / 16, sink);
    return (int)cudaGetLastError();
}

template <int WMAX>
int launch_finalize_tables(const void* keys, const void* len, const void* edges, int64_t T, int k,
                           int64_t n_words, int lead, void* rank_words, void* pops,
                           void* sgs_words, cudaStream_t s) {
    finalize_tables_kernel<WMAX><<<(unsigned)((n_words + kFinalWords - 1) / kFinalWords),
                                   kFinalWarps * 32, 0, s>>>(
        (const unsigned*)keys, (const int*)len, (const uint8_t*)edges, T, (k + 15) / 16, k, n_words,
        lead, (unsigned*)rank_words, (int*)pops, (unsigned*)sgs_words);
    return (int)cudaGetLastError();
}

}  // namespace

// m >= 1 windows of the codes [m + k - 1], any alignment; keys and valid
// fresh (16-byte aligned keeps the wide stores, any other the narrow ones).
extern "C" int sbwt_pack_windows(int device, const void* codes, long long m, int k, void* keys,
                                 void* valid, void* stream) {
    cudaSetDevice(device);
    const int W = (k + 15) / 16;
    auto launch = W <= 2 ? launch_pack_windows<2> : W <= 4 ? launch_pack_windows<4>
                                                           : launch_pack_windows<16>;
    return launch(codes, m, k, keys, valid, (cudaStream_t)stream);
}

// pack_range: the valid windows of the codes [m + k - 1] whose key's top
// `bits` bits (0..16, at most 2 (k - 1)) lie in [lo, hi) into nodes [cap_nodes,
// W], those whose (k-1)-prefix's do into edges [cap_edges, W], each in no
// fixed order; count (two uint64, zeroed here) ends as the windows sent to
// each, also past a capacity (no key is written there).
extern "C" int sbwt_pack_range(int device, const void* codes, long long m, int k, unsigned lo,
                               unsigned hi, int bits, void* nodes, long long cap_nodes,
                               void* edges, long long cap_edges, void* count, void* stream) {
    cudaSetDevice(device);
    cudaStream_t s = (cudaStream_t)stream;
    if (const cudaError_t e = cudaMemsetAsync(count, 0, 2 * sizeof(unsigned long long), s)) {
        return (int)e;
    }
    const int W = (k + 15) / 16;
    const RangeSink sink{lo, hi, bits, (unsigned*)nodes, (unsigned*)edges, cap_nodes, cap_edges,
                         (unsigned long long*)count};
    auto launch = W <= 2 ? launch_pack_range<2> : W <= 4 ? launch_pack_range<4>
                                                         : launch_pack_range<16>;
    return launch(codes, m, k, sink, s);
}

// n >= 1 list keys, nq query keys (a range's out-edges, or the list itself).
// edges: 4-byte aligned, room for (n + 3) / 4 words, zeroed here:
// the kernel ORs each edge bit into its word; gstart [n], is_src [nq].
// scratch: int64, 4 * (parts + 1) + 4 of them, parts = ceil((n + nq) /
// sbwt_edge_src_share(k)).
extern "C" int sbwt_edge_src_probe(int device, const void* keys, long long n, const void* qkeys,
                                   long long nq, int k, void* edges, void* gstart, void* is_src,
                                   void* scratch, void* stream) {
    cudaSetDevice(device);
    const int W = (k + 15) / 16;
    cudaStream_t s = (cudaStream_t)stream;
    if (const cudaError_t e = cudaMemsetAsync(edges, 0, ((size_t)n + 3) & ~(size_t)3, s)) {
        return (int)e;
    }
    auto launch = W <= 2 ? launch_edge_src_probe<2>
                  : W <= 4 ? launch_edge_src_probe<4> : launch_edge_src_probe<16>;
    return launch(keys, n, qkeys, nq, W, k, edges, gstart, is_src, scratch, s);
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

// sgs_words is null without streaming support; column t at bit lead + t.
extern "C" int sbwt_finalize_tables(int device, const void* keys, const void* len,
                                    const void* edges, long long T, int k, long long n_words,
                                    int lead, void* rank_words, void* pops, void* sgs_words,
                                    void* stream) {
    cudaSetDevice(device);
    const int W = (k + 15) / 16;
    cudaStream_t s = (cudaStream_t)stream;
    auto launch = W <= 2 ? launch_finalize_tables<2>
                  : W <= 4 ? launch_finalize_tables<4> : launch_finalize_tables<16>;
    return launch(keys, len, edges, T, k, n_words, lead, rank_words, pops, sgs_words, s);
}
