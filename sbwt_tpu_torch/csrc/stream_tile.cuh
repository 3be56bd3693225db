// The warp-staged tiles that the streaming kernels share: K4
// (turbo_stream.cuh) and K14 (lf_stream.cuh); K1's search and
// partial_search (lf_stream.cuh) stage their rows the same way. A warp owns 32 consecutive
// reads, whose codes are one contiguous [32, L] region and whose answers
// one contiguous [32, L - k + 1] region, and walks them in tiles of T
// positions. For each tile it stages the window of chars the tile reads
// (stage_codes) into shared memory with 16-byte loads on neighbouring
// addresses; each lane answers its read's positions from there, keeping
// its rolling state in registers across tiles, into a shared answer tile,
// which the warp stores as one run of neighbouring stores a read
// (store_answer_tile). Both streams are evict-first, so that they leave L2
// to what the kernel reads at random. One thread a read touched 32 rows L
// bytes apart in every instruction of either stream.
#pragma once

#include <atomic>

#include "sbwt_common.cuh"

namespace sbwt {

// Bytes between two staged code rows: a window of win chars, from the
// 16-byte chunk that holds its first char, in whole chunks, plus one word
// so that the 32 rows start in 32 different banks.
__host__ __device__ __forceinline__ int tile_code_chunks(int win) {
    return (win + 15 + 15) / 16;
}
__host__ __device__ __forceinline__ int tile_code_row_bytes(int win) {
    return 16 * tile_code_chunks(win) + 4;
}

// Dynamic shared memory of one block of `warps` warps: each warp's staged
// code rows, then each warp's answer tile (32 rows of tile + 1 positions,
// so that the lanes' same-offset writes fall in 32 banks).
// Each kernel declares the array itself: behind an inlined accessor that
// returned its address, nvcc gave K4 other code (48 registers against 52)
// that ran 2.6% slower at hit0 on an H100 (tools/turbo_ab.py).
template <class P>
__host__ __device__ __forceinline__ int tile_smem_bytes(int warps, int tile, int win) {
    return warps * 32 * (tile_code_row_bytes(win) + (tile + 1) * (int)sizeof(P));
}

// The aligned 16-byte chunk at `at` of the codes buffer [lo, hi) into dst:
// one evict-first load, or byte by byte where it crosses either end.
__device__ __forceinline__ void stage_chunk(uintptr_t at, uintptr_t lo, uintptr_t hi,
                                            unsigned* dst) {
    if (at >= lo && at + 16 <= hi) {
        const int4 v = __ldcs(reinterpret_cast<const int4*>(at));
        dst[0] = (unsigned)v.x;
        dst[1] = (unsigned)v.y;
        dst[2] = (unsigned)v.z;
        dst[3] = (unsigned)v.w;
    } else {
        for (int j = 0; j < 16; ++j) {
            if (at + j >= lo && at + j < hi) {
                reinterpret_cast<int8_t*>(dst)[j] = *reinterpret_cast<const int8_t*>(at + j);
            }
        }
    }
}

// Chars [t0, t0 + win) of the warp's nrows reads (rows of L chars from
// codes, total chars in all), cut at each read's end, into the staged rows
// st: row r holds, from its byte 0, the aligned 16-byte chunks that cover
// the window of read b0 + r. Lanes take consecutive chunks, so a warp's
// loads are 16 bytes a lane on neighbouring addresses; a chunk that
// crosses either end of the codes buffer is copied byte by byte.
__device__ __forceinline__ void stage_codes(const int8_t* __restrict__ codes, int64_t total,
                                            int64_t b0, int nrows, int L, int t0, int win,
                                            int chunks, int row_bytes, int8_t* st, int lane) {
    const int wlen = min(win, L - t0);
    const uintptr_t lo = (uintptr_t)codes, hi = lo + (uintptr_t)total;
    for (int i = lane; i < nrows * chunks; i += 32) {
        const int r = i / chunks, c = i - r * chunks;
        const uintptr_t g = (uintptr_t)(codes + (b0 + r) * L + t0);
        const uintptr_t at = (g & ~(uintptr_t)15) + 16 * c;
        if (at >= g + wlen) continue;
        stage_chunk(at, lo, hi, reinterpret_cast<unsigned*>(st + r * row_bytes + 16 * c));
    }
}

// Chars [g, g + len) of the codes buffer [codes, codes + total) into st,
// from the 16-byte chunk that holds g: lanes take consecutive chunks, each
// loaded once.
__device__ __forceinline__ void stage_span(const int8_t* __restrict__ codes, int64_t total,
                                           const int8_t* g, int len, int8_t* st, int lane) {
    const uintptr_t lo = (uintptr_t)codes, hi = lo + (uintptr_t)total;
    const uintptr_t at0 = (uintptr_t)g & ~(uintptr_t)15;
    const int chunks = (int)(((uintptr_t)g + len - at0 + 15) / 16);
    for (int i = lane; i < chunks; i += 32) {
        stage_chunk(at0 + 16 * i, lo, hi, reinterpret_cast<unsigned*>(st + 16 * i));
    }
}

// Each lane's own window, wlen chars from g (wlen <= 0: none), into row
// `lane` of the staged rows st, laid out as stage_codes lays a row out.
// Called by the whole warp: lanes take consecutive chunks, row r's pointer
// and length shuffled from lane r, so where the windows lie together (the
// rows of neighbouring lanes) a warp's loads are 16 bytes a lane on
// neighbouring addresses.
__device__ __forceinline__ void stage_windows(const int8_t* __restrict__ codes, int64_t total,
                                              const int8_t* g, int wlen, int chunks,
                                              int row_bytes, int8_t* st, int lane) {
    const uintptr_t lo = (uintptr_t)codes, hi = lo + (uintptr_t)total;
    for (int i = lane; i < 32 * chunks; i += 32) {
        const int r = i / chunks, c = i - r * chunks;
        const uintptr_t gr = (uintptr_t)__shfl_sync(0xFFFFFFFFu, (unsigned long long)g, r);
        const int wr = __shfl_sync(0xFFFFFFFFu, wlen, r);
        const uintptr_t at = (gr & ~(uintptr_t)15) + 16 * c;
        if (wr <= 0 || at >= gr + (uintptr_t)wr) continue;
        stage_chunk(at, lo, hi, reinterpret_cast<unsigned*>(st + r * row_bytes + 16 * c));
    }
}

// Char x of the read that lane owns, staged for the tile from t0, is at
// the returned pointer's [x] (read is that read's row of the codes).
__device__ __forceinline__ const int8_t* staged_row(const int8_t* st, int row_bytes, int lane,
                                                    const int8_t* read, int t0) {
    return st + lane * row_bytes + ((uintptr_t)(read + t0) & 15) - t0;
}

// Answers t0 .. t0 + tlen - 1 of the warp's nrows reads, row r of the
// answer tile sa (rows of Tile + 1), into out [B, P_out]: row r as one run
// of neighbouring stores.
template <int Tile, class P>
__device__ __forceinline__ void store_answer_tile(P* out, const P* sa, int64_t b0, int nrows,
                                                  int P_out, int t0, int tlen, int lane) {
    for (int i = lane; i < nrows * Tile; i += 32) {
        const int r = i / Tile, x = i % Tile;
        if (x < tlen) __stcs(out + (b0 + r) * P_out + t0 + x, sa[r * (Tile + 1) + x]);
    }
}

// Past 48 KB a kernel's dynamic shared memory must be allowed first: raise
// kernel's limit to smem once for each device and size. raised is the
// calling instance's own record. 0 or the CUDA error.
template <class F>
int raise_smem_limit(F* kernel, int smem, std::atomic<int> (&raised)[64]) {
    if (smem <= 48 * 1024) return 0;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (raised[dev].load() < smem) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        raised[dev].store(smem);
    }
    return 0;
}

}  // namespace sbwt
