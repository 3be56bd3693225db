// K21 gather_chain: dependent gathers from an int32 table [R, W], W = 2 or
// 8. Each lane runs `steps` loads: idx <- (xor of row idx's words &
// 0x7FFFFFFF) % R, and writes its last idx.
//
// Replaces the Pallas kernel of scratch/gather_bench.py pallas_chain (:58,
// its pl.pallas_call at :66; [R, 2] held in VMEM) and the XLA chain of
// mk_chain (:24-34) over the wide [R, 8] table: a probe of what one
// dependent row gather costs, which is what every LF and table step of K4,
// K14 and K20 pays.
//
// Bound on the H100: the card's rate of dependent random gathers, not
// bytes. The byte floor is the distinct rows the chains touch (at most the
// table) and the lanes' indices over 3.35 TB/s, but each load needs the
// one before it, so a lane has one load in flight at a time. Past a knee of some 2^15-2^16 lanes the L2's (or, for a table past
// L2, the HBM's) rate of random sectors holds the kernel; below it each
// step costs a load's latency plus the step's arithmetic, and an SM serves
// about one divergent row request a clock, so the lanes an SM holds add
// to the latency (tools/gather_ab.py measures all three).
// Design: one thread a lane, the index in a register, the lanes spread
// evenly over the SMs (one block an SM while the share fits a block); a
// W = 8 row as two 16-byte loads from one 32-byte sector (an L2-only load,
// which L1 cannot join into one request, is slower); the table may lie on
// a peer card (peer access enabled by the caller). The step's arithmetic
// is kept short: `% R` by a runtime R compiles to a high multiply by a
// hoisted reciprocal and two conditional corrections, ten dependent
// instructions from a W = 2 row to the next address; a multiplier computed
// once a launch on the host (kernels/__init__.py divisor_magic) makes it
// six: the xor, a shift, a high multiply, a shift, a multiply-add and the
// address.
#include "sbwt_common.cuh"

namespace {

constexpr int64_t kMaxBlock = 1024;  // threads a block

// (x & 0x7FFFFFFF) % R for 1 <= R < 2^31, given m = floor(2^(31 + l) / R) + 1
// and l = ceil(log2 R): the quotient of n < 2^31 is floor(m n / 2^(31 + l))
// (Granlund and Montgomery's round-up multiplier; m < 2^32), that is
// umulhi(m, 2 n) >> l, and 2 n is x << 1 whatever x's top bit. neg_r is
// 2^32 - R, a launch argument (nvcc turns q * (0 - R) back into a negate
// and a multiply-add), so that n - q R is one multiply-add.
__device__ __forceinline__ unsigned mod_by_magic(int x, unsigned neg_r, unsigned m, int l) {
    const unsigned q = __umulhi(m, (unsigned)x << 1) >> l;
    return ((unsigned)x & 0x7FFFFFFFu) + q * neg_r;
}

template <int W>
__global__ void gather_chain_kernel(const int* __restrict__ tbl, unsigned neg_r, unsigned m,
                                    int l, const int* __restrict__ idx0, long long B, int steps,
                                    int* __restrict__ out) {
    const int64_t b = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (b >= B) return;
    unsigned idx = (unsigned)idx0[b];
    for (int s = 0; s < steps; ++s) {
        int x;
        if constexpr (W == 2) {
            const int2 row = reinterpret_cast<const int2*>(tbl)[idx];
            x = row.x ^ row.y;
        } else {
            const int4* row = reinterpret_cast<const int4*>(tbl) + (int64_t)idx * 2;
            const int4 u = row[0], v = row[1];
            x = u.x ^ u.y ^ u.z ^ u.w ^ v.x ^ v.y ^ v.z ^ v.w;
        }
        idx = mod_by_magic(x, neg_r, m, l);
    }
    out[b] = (int)idx;
}

}  // namespace

extern "C" int sbwt_gather_chain(int device, const void* tbl, int R, int width, unsigned magic,
                                 int shift, const void* idx0, long long B, int steps, void* out,
                                 void* stream) {
    cudaSetDevice(device);
    const cudaStream_t s = (cudaStream_t)stream;
    if (R < 1 || B < 0 || steps < 0 || shift < 0 || shift > 31) return (int)cudaErrorInvalidValue;
    if (width != 2 && width != 8) return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    int sms = 0;
    const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return (int)e;
    if (sms < 1) return (int)cudaErrorInvalidValue;
    // every SM an equal share of the lanes, in as few blocks of at most
    // kMaxBlock threads as hold it: an SM serves about one divergent row
    // request a clock, so the SM with the most lanes sets the pace
    const int64_t share = (B + sms - 1) / sms;
    const int64_t parts = (share + kMaxBlock - 1) / kMaxBlock;
    const unsigned block = (unsigned)((share + parts - 1) / parts);
    const unsigned grid = (unsigned)((B + block - 1) / block);
    const unsigned neg_r = 0u - (unsigned)R;
    if (width == 2) {
        gather_chain_kernel<2><<<grid, block, 0, s>>>(
            (const int*)tbl, neg_r, magic, shift, (const int*)idx0, B, steps, (int*)out);
    } else {
        gather_chain_kernel<8><<<grid, block, 0, s>>>(
            (const int*)tbl, neg_r, magic, shift, (const int*)idx0, B, steps, (int*)out);
    }
    return (int)cudaGetLastError();
}
