// K13 answer_stats: the checksum and hit count of an answer matrix.
//
// Replaces the reductions of the XLA programs sbwt_tpu/ops/turbo.py
// _turbo_with_stats and _turbo_reduced_stats (and bench.py's run): over a
// contiguous answer matrix [B, P], taken as one flat array of B * P
// elements, out[0] = the int64 sum of every answer (wrapping as int64
// does) and out[1] = the number of answers >= 0. Answers are int32, or
// int64 on the wide tier.
//
// Bound on the H100: one read of the matrix (297.8 MB at 1M reads x 71
// answers, int32) at 3.35 TB/s, 0.0889 ms. Design: 16-byte loads, evict-
// first (the matrix is read once, so it leaves L2 to others), in a grid-
// stride loop over one wave of blocks (as many as fit on the card), four
// loads in flight a thread; a scalar head and tail take the elements
// before the first and after the last 16-byte boundary, so rows need no
// alignment. Each thread keeps 64-bit sums, the block reduces them by warp
// shuffles, and each block adds its pair to out with two atomics. Integer
// addition is exact and associative, so the order the blocks finish in
// cannot change the result: it is deterministic, in one kernel launch
// after a 16-byte memset of out.
#include <algorithm>

#include "sbwt_common.cuh"

namespace {

constexpr int kUnroll = 4;
constexpr int kWarps = sbwt::kBlock / 32;

using u64 = unsigned long long;

// 16 bytes of answers: four int32 or two int64. A hit is an answer >= 0,
// whose sign bit is clear.
template <class T>
struct Vec16;
template <>
struct Vec16<int> {
    using type = int4;
    static constexpr int n = 4;
    __device__ static void add(int4 v, u64& sum, u64& hits) {
        sum += (u64)(long long)v.x + (u64)(long long)v.y + (u64)(long long)v.z
               + (u64)(long long)v.w;
        hits += (~(unsigned)v.x >> 31) + (~(unsigned)v.y >> 31) + (~(unsigned)v.z >> 31)
                + (~(unsigned)v.w >> 31);
    }
};
template <>
struct Vec16<int64_t> {
    using type = longlong2;
    static constexpr int n = 2;
    __device__ static void add(longlong2 v, u64& sum, u64& hits) {
        sum += (u64)v.x + (u64)v.y;
        hits += (~(u64)v.x >> 63) + (~(u64)v.y >> 63);
    }
};

// a: the answers; head: the elements before the first 16-byte boundary
// (fewer than a vector's); n_vec: the whole vectors after them; n: all
// elements.
template <class T>
__global__ void __launch_bounds__(sbwt::kBlock)
answer_stats_kernel(const T* __restrict__ a, int64_t n, int head, int64_t n_vec, u64* out) {
    using V = typename Vec16<T>::type;
    const V* __restrict__ v = reinterpret_cast<const V*>(a + head);
    const int64_t stride = (int64_t)gridDim.x * blockDim.x;
    const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    u64 sum = 0, hits = 0;
    int64_t i = tid;
    for (; i + (kUnroll - 1) * stride < n_vec; i += kUnroll * stride) {
        V x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x[u] = __ldcs(v + i + u * stride);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) Vec16<T>::add(x[u], sum, hits);
    }
    for (; i < n_vec; i += stride) Vec16<T>::add(__ldcs(v + i), sum, hits);
    // the head, and the tail after the last whole vector
    const int64_t tail0 = head + n_vec * Vec16<T>::n;
    if (tid < head) {
        sum += (u64)(long long)a[tid];
        hits += a[tid] >= 0;
    }
    if (tid < n - tail0) {
        sum += (u64)(long long)a[tail0 + tid];
        hits += a[tail0 + tid] >= 0;
    }

#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_down_sync(0xffffffffu, sum, o);
        hits += __shfl_down_sync(0xffffffffu, hits, o);
    }
    __shared__ u64 warp_sum[kWarps], warp_hits[kWarps];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) {
        warp_sum[warp] = sum;
        warp_hits[warp] = hits;
    }
    __syncthreads();
    if (warp == 0) {
        sum = lane < kWarps ? warp_sum[lane] : 0;
        hits = lane < kWarps ? warp_hits[lane] : 0;
#pragma unroll
        for (int o = kWarps / 2; o > 0; o >>= 1) {
            sum += __shfl_down_sync(0xffffffffu, sum, o);
            hits += __shfl_down_sync(0xffffffffu, hits, o);
        }
        if (lane == 0) {
            atomicAdd(out, sum);
            atomicAdd(out + 1, hits);
        }
    }
}

template <class T>
int launch(int device, const T* a, int64_t n, u64* out, cudaStream_t s) {
    cudaError_t err = cudaMemsetAsync(out, 0, 2 * sizeof(u64), s);
    if (err != cudaSuccess || n == 0) return (int)err;
    constexpr int kPer = Vec16<T>::n;
    // elements up to the first 16-byte boundary; the answers are aligned to
    // their own size, so that is a whole number of elements
    const int head = (int)std::min<int64_t>(n, ((16 - (uintptr_t)a % 16) % 16) / sizeof(T));
    const int64_t n_vec = (n - head) / kPer;
    // one wave: as many blocks as fit on the card at once
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, answer_stats_kernel<T>,
                                                            sbwt::kBlock, 0);
    if (err != cudaSuccess) return (int)err;
    const int64_t want = std::max<int64_t>(sbwt::grid_for((n_vec + kUnroll - 1) / kUnroll), 1);
    const unsigned grid = (unsigned)std::min<int64_t>(want, (int64_t)sms * per_sm);
    answer_stats_kernel<T><<<grid, sbwt::kBlock, 0, s>>>(a, n, head, n_vec, out);
    return (int)cudaGetLastError();
}

}  // namespace

// out: int64 [2] on the answers' card, (checksum, hits).
extern "C" int sbwt_answer_stats(int device, const void* answers, long long n, int wide,
                                 void* out, void* stream) {
    cudaSetDevice(device);
    const cudaStream_t s = (cudaStream_t)stream;
    return wide ? launch(device, (const int64_t*)answers, n, (u64*)out, s)
                : launch(device, (const int*)answers, n, (u64*)out, s);
}
