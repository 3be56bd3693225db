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
// Bound on the H100: latency, not bytes. The byte floor is
// B * steps * row bytes / 3.35 TB/s, but each load needs the one before
// it, so a lane has one load in flight at a time (L2 for a table under the
// 50 MB L2, HBM past it, NVLink for a table on a peer card); throughput is
// resident lanes / latency. Design: one thread a lane, the index in a
// register, a W = 8 row as two 16-byte loads from the same 32-byte sector
// pair; the table may lie on a peer card (peer access enabled by the
// caller).
#include "sbwt_common.cuh"

namespace {

template <int W>
__global__ void gather_chain_kernel(const int* __restrict__ tbl, unsigned R,
                                    const int* __restrict__ idx0, long long B, int steps,
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
        idx = ((unsigned)x & 0x7FFFFFFFu) % R;
    }
    out[b] = (int)idx;
}

}  // namespace

extern "C" int sbwt_gather_chain(int device, const void* tbl, int R, int width, const void* idx0,
                                 long long B, int steps, void* out, void* stream) {
    cudaSetDevice(device);
    const cudaStream_t s = (cudaStream_t)stream;
    const unsigned grid = sbwt::grid_for(B);
    if (R < 1 || steps < 0) return (int)cudaErrorInvalidValue;
    if (width == 2) {
        gather_chain_kernel<2><<<grid, sbwt::kBlock, 0, s>>>((const int*)tbl, (unsigned)R,
                                                             (const int*)idx0, B, steps, (int*)out);
    } else if (width == 8) {
        gather_chain_kernel<8><<<grid, sbwt::kBlock, 0, s>>>((const int*)tbl, (unsigned)R,
                                                             (const int*)idx0, B, steps, (int*)out);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}
