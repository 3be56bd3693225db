// K3 seed_bits: the 2-bit seed-liveness pair table.
//
// Replaces the XLA programs of sbwt_tpu/ops/turbo.py _pack_seed_pair_bits
// and _pack_2bit_u32. Entry m, over all (p+1)-mers, has bit0 = (precalc
// row m mod 4^p is non-empty) and bit1 = (precalc row m >> 2 is
// non-empty); word w holds entries 16w .. 16w + 15, entry e at bits 2e.
// The precalc rows are int2 on the narrow tier and longlong2 on the wide
// one; the bits are the same.
//
// Bound on the H100: one read of the whole precalc table (4^p rows of 8
// bytes, 537 MB at p = 13; 16 bytes wide), since the left bounds share
// their 32-byte sectors with the right ones, and the 4^(p+1) / 16 words
// written (67 MB). Design: two passes in one entry.
//  1. Liveness bitmap: the table's rows read once, coalesced, by 16-byte
//     evict-first loads (two narrow rows or one wide row a load, four loads
//     in flight a lane), a warp's ballot making 32 live bits at a time,
//     written to a 4^p-bit bitmap (8.4 MB at p = 13, which stays in L2).
//  2. Pack: one thread a word; bit0 of its 16 entries is the 16 bitmap bits
//     at (16w) mod 4^p, a half-word spread to the even bit positions, and
//     bit1 the 4 bits at 4w, each filling the odd positions of 4 entries.
#include "sbwt_common.cuh"

namespace {

constexpr int kLoads = 4;  // 16-byte loads in flight a lane in pass 1

// bit i of the low 16 bits of x to bit 2i
__device__ __forceinline__ unsigned spread16(unsigned x) {
    x &= 0xFFFFu;
    x = (x | (x << 8)) & 0x00FF00FFu;
    x = (x | (x << 4)) & 0x0F0F0F0Fu;
    x = (x | (x << 2)) & 0x33333333u;
    return (x | (x << 1)) & 0x55555555u;
}

// Pass 1 over the q = 4^p rows: bitmap bit r = (row r's left bound >= 0).
// A warp takes kLoads * 32 vectors of 16 bytes, kRows rows each, and its
// lane t < kLoads * kRows writes the t-th of the chunk's bitmap words.
// Lanes past the table's end read nothing and vote dead; words past it are
// not written.
template <class Row>
__global__ void live_bitmap_kernel(const Row* __restrict__ precalc, int64_t q,
                                   unsigned* __restrict__ bitmap) {
    constexpr int kRows = 16 / sizeof(Row);
    constexpr int64_t kChunk = kLoads * 32 * kRows;
    const int lane = threadIdx.x & 31;
    const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int64_t row0 = warp * kChunk;
    if (row0 >= q) return;  // the whole warp
    Row r[kLoads][kRows];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
        const int64_t row = row0 + (int64_t)(u * 32 + lane) * kRows;
        if (row < q) {
            if constexpr (kRows == 2) {
                const int4 v = __ldcs(reinterpret_cast<const int4*>(precalc + row));
                r[u][0].x = v.x;
                r[u][1].x = v.z;
            } else {
                r[u][0] = __ldcs(precalc + row);
            }
        } else {
#pragma unroll
            for (int j = 0; j < kRows; ++j) r[u][j].x = -1;
        }
    }
    unsigned word = 0;
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
        if constexpr (kRows == 2) {
            // lane L holds rows 2L and 2L + 1 of the load's 64
            const unsigned even = __ballot_sync(0xffffffffu, r[u][0].x >= 0);
            const unsigned odd = __ballot_sync(0xffffffffu, r[u][1].x >= 0);
            if (lane == 2 * u) word = spread16(even) | (spread16(odd) << 1);
            if (lane == 2 * u + 1) word = spread16(even >> 16) | (spread16(odd >> 16) << 1);
        } else {
            const unsigned live = __ballot_sync(0xffffffffu, r[u][0].x >= 0);
            if (lane == u) word = live;
        }
    }
    const int64_t w = row0 / 32 + lane;
    if (lane < kLoads * kRows && w < (q + 31) / 32) bitmap[w] = word;
}

// Pass 2: output word w of the n_out = q / 4 words.
__global__ void pack_pairs_kernel(const unsigned* __restrict__ bitmap, int64_t q, int64_t n_out,
                                  unsigned* __restrict__ out) {
    const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= n_out) return;
    unsigned half;
    if (q >= 16) {
        const int64_t s = (16 * w) & (q - 1);  // a multiple of 16
        half = bitmap[s >> 5] >> (s & 31);
    } else {  // p = 1: the 4 rows repeat over the word's 16 entries
        half = 0;
        for (int e = 0; e < 16; ++e) half |= ((bitmap[0] >> (e & (q - 1))) & 1u) << e;
    }
    const int64_t t = 4 * w;
    const unsigned nib = (bitmap[t >> 5] >> (t & 31)) & 0xFu;
    // nibble bit i to bit 8i, then to the odd bits of byte i (entries 4i .. 4i + 3)
    out[w] = spread16(half) | (((nib * 0x00204081u) & 0x01010101u) * 0xAAu);
}

template <class Row>
int launch(const Row* precalc, int p, unsigned* bitmap, unsigned* out, cudaStream_t s) {
    const int64_t q = (int64_t)1 << (2 * p);
    constexpr int64_t kChunk = kLoads * 32 * (16 / sizeof(Row));
    live_bitmap_kernel<<<sbwt::grid_for((q + kChunk - 1) / kChunk * 32), sbwt::kBlock, 0, s>>>(
        precalc, q, bitmap);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    pack_pairs_kernel<<<sbwt::grid_for(q / 4), sbwt::kBlock, 0, s>>>(bitmap, q, q / 4, out);
    return (int)cudaGetLastError();
}

}  // namespace

// bitmap: scratch of ceil(4^p / 32) words; out: the 4^(p+1) / 16 words.
extern "C" int sbwt_seed_bits(int device, const void* precalc, int p, int wide, void* bitmap,
                              void* out, void* stream) {
    cudaSetDevice(device);
    const cudaStream_t s = (cudaStream_t)stream;
    return wide ? launch((const longlong2*)precalc, p, (unsigned*)bitmap, (unsigned*)out, s)
                : launch((const int2*)precalc, p, (unsigned*)bitmap, (unsigned*)out, s);
}
