// The launch switch of the kernels that are templates over the rank type:
// K14 and K1 with partial_search (lf_stream.cuh), K2's succ1 and forward
// (succ_table.cuh) and K4 (turbo_stream.cuh), and the launches of K14, of
// K1's fill and search and of partial_search. An instance file
// (lf_stream.cu, lf_split.cu, lf_concat.cu, lf_subsetwt.cu, lf_wide.cu,
// lf_sharded.cu) calls launch_rank_op<R> for each rank type of its family,
// which instantiates all seven kernels for R, K4 over the flat table, and
// K14's and K4's counting instances.
#pragma once

#include <type_traits>

#include "lf_stream.cuh"
#include "succ_table.cuh"
#include "turbo_stream.cuh"

namespace sbwt {

// Whether K14 and K4 over R have an instance that counts its work: every
// rank type but the row-sharded one, whose launches refuse a.out_r.
template <class R>
struct CountsWork : std::true_type {};
template <>
struct CountsWork<ShardedMatrix> : std::false_type {};

// Launches K14, the counting instance when kCount; the shared memory a
// block needs grows with k and the tile (46,592 B at most for k <= 255
// with LFShape's tiles), and past 48 KB the kernel's limit is raised first.
template <bool kCount, class R>
int launch_lf_stream(const R& rk, const LFArgs& a, cudaStream_t s) {
    static std::atomic<int> raised[64];
    const int smem = lf_smem_bytes<R>(a.k);
    if (const int e = raise_smem_limit(lf_stream_kernel<R, kCount>, smem, raised)) return e;
    constexpr int W = LFShape<R>::warps;
    const unsigned grid = (unsigned)(((a.B + 31) / 32 + W - 1) / W);
    lf_stream_kernel<R, kCount><<<grid, W * 32, smem, s>>>(rk, a);
    return (int)cudaGetLastError();
}

// Launches kernel, an instance over StagedRank's twin of R, with n threads
// in blocks of up to 1,024 (the most its registers allow): each block
// stages the 64 KB pattern table once, so the blocks are large
template <auto kernel, class R>
int launch_staged(const R& rk, const LFArgs& a, int64_t n, cudaStream_t s) {
    using K = typename StagedRank<R>::type;
    static std::atomic<int> raised[64];
    if (const int e = raise_smem_limit(kernel, kPatternTableBytes, raised)) return e;
    cudaFuncAttributes fa;
    if (const cudaError_t e = cudaFuncGetAttributes(&fa, kernel)) return (int)e;
    const int block = min(1024, fa.maxThreadsPerBlock) & ~31;
    kernel<<<(unsigned)((n + block - 1) / block), block, kPatternTableBytes, s>>>(as_rank<K>(rk), a);
    return (int)cudaGetLastError();
}

// Launches K1's fill at subtree depth D = min(kFillDepth, p - kFillMinLevel),
// 0 at least. Over StagedRank's twin where R has one and the fill has at
// least kFillStagedThreads threads: at p = 12 (2^18 threads) the staged
// table ran rrr-subsetwt's fill 2.1x faster on an H100, at p = 8 (2^16)
// 1.3x slower (tools/lf_ab.py; PERF.md).
constexpr int64_t kFillStagedThreads = (int64_t)1 << 18;

template <class R, int D = kFillDepth>
int launch_precalc_fill(const R& rk, const LFArgs& a, cudaStream_t s) {
    if constexpr (D > 0) {
        if (a.p - D < kFillMinLevel) return launch_precalc_fill<R, D - 1>(rk, a, s);
    } else if (a.p < 0) {
        return (int)cudaErrorInvalidValue;
    }
    using K = typename StagedRank<R>::type;
    const int64_t n = (int64_t)1 << (2 * (a.p - D));
    if constexpr (StagesPatterns<K>::value) {
        if (n >= kFillStagedThreads) return launch_staged<precalc_fill_kernel<D, K>>(rk, a, n, s);
    }
    precalc_fill_kernel<D, R><<<grid_for(n), kBlock, 0, s>>>(rk, a);
    return (int)cudaGetLastError();
}

// Launches kmer_search in R's SearchShape: staged, a warp per 32 k-mers
// (the shared memory a block needs grows with k: 32,768 B at k = 255, and
// past 48 KB the limit is raised first), or one thread a k-mer
template <class R>
int launch_kmer_search(const R& rk, const LFArgs& a, cudaStream_t s) {
    if constexpr (SearchShape<R>::kmer_staged) {
        static std::atomic<int> raised[64];
        const int smem = kSearchWarps * kmer_span_bytes(a.k);
        if (const int e = raise_smem_limit(kmer_search_kernel<R>, smem, raised)) return e;
        const unsigned grid = (unsigned)(((a.B + 31) / 32 + kSearchWarps - 1) / kSearchWarps);
        kmer_search_kernel<R><<<grid, kSearchWarps * 32, smem, s>>>(rk, a);
    } else {
        kmer_search_lane_kernel<R><<<grid_for(a.B), kBlock, 0, s>>>(rk, a);
    }
    return (int)cudaGetLastError();
}

// Launches partial_search in R's SearchShape: staged, a warp per pool of
// 32 * pool lanes, or one thread a lane (over StagedRank's twin where R
// has one)
template <class R>
int launch_partial_search(const R& rk, const LFArgs& a, cudaStream_t s) {
    using S = SearchShape<R>;
    using K = typename StagedRank<R>::type;
    if constexpr (S::partial_staged) {
        const int64_t pools = (a.B + 32 * S::pool - 1) / (32 * S::pool);
        const unsigned grid = (unsigned)((pools + kSearchWarps - 1) / kSearchWarps);
        partial_search_kernel<R><<<grid, kSearchWarps * 32, partial_search_smem_bytes<R>(), s>>>(
            rk, a);
    } else if constexpr (StagesPatterns<K>::value) {
        return launch_staged<partial_search_lane_kernel<K>>(rk, a, a.B, s);
    } else {
        partial_search_lane_kernel<R><<<grid_for(a.B), kBlock, 0, s>>>(rk, a);
    }
    return (int)cudaGetLastError();
}

// Launches succ1 over all columns by span
template <class R>
int launch_succ1_span(const R& rk, const LFArgs& a, cudaStream_t s) {
    const int64_t warps = (a.B + kSuccSpan - 1) / kSuccSpan;
    succ1_span_kernel<R><<<(unsigned)((warps + kSuccWarps - 1) / kSuccWarps), kSuccWarps * 32, 0,
                           s>>>(rk, a);
    return (int)cudaGetLastError();
}

template <class R>
int launch_rank_op(int op, const void* rank_desc, const LFArgs* args, void* stream) {
    const R rk = *static_cast<const R*>(rank_desc);
    const LFArgs a = *args;
    const cudaStream_t s = (cudaStream_t)stream;
    const unsigned grid = grid_for(a.B);
    switch (op) {
        case kLFStream:
            if (a.out_r == nullptr) return launch_lf_stream<false>(rk, a, s);
            if constexpr (CountsWork<R>::value) return launch_lf_stream<true>(rk, a, s);
            return (int)cudaErrorInvalidValue;
        case kPrecalcFill:
            return launch_precalc_fill(rk, a, s);
        case kKmerSearch:
            return launch_kmer_search(rk, a, s);
        case kPartialSearch:
            return launch_partial_search(rk, a, s);
        case kSucc1:
            if constexpr (SuccRound<R>::value) {
                succ1_wide_kernel<R><<<grid, kBlock, 0, s>>>(rk, a);
                break;
            }
            if constexpr (SuccSpan<R>::value) {
                if (a.aux == nullptr) return launch_succ1_span(rk, a, s);
            }
            succ1_kernel<R><<<grid, kBlock, 0, s>>>(rk, a);
            break;
        case kForward:
            if (a.aux == nullptr || a.codes == nullptr) return (int)cudaErrorInvalidValue;
            forward_kernel<R><<<grid, kBlock, 0, s>>>(rk, a);
            break;
        case kTurboStream:
            // the wide tier's table has arity 1 only
            if (a.arity < 1 || a.arity > (sizeof(typename R::pos_t) == 8 ? 1 : 3)) {
                return (int)cudaErrorInvalidValue;
            }
            if (a.out_r == nullptr) return launch_turbo_stream<false>(rk, a, FlatTable{}, s);
            if constexpr (CountsWork<R>::value) {
                return launch_turbo_stream<true>(rk, a, FlatTable{}, s);
            }
            return (int)cudaErrorInvalidValue;
        default:
            return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // namespace sbwt
