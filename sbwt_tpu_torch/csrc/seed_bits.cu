// K3 seed_bits: the 2-bit seed-liveness pair table.
//
// Replaces the XLA programs of sbwt_tpu/ops/turbo.py _pack_seed_pair_bits
// and _pack_2bit_u32. Entry m, over all (p+1)-mers, has bit0 = (precalc
// row m mod 4^p is non-empty) and bit1 = (precalc row m >> 2 is
// non-empty); word w holds entries 16w .. 16w + 15, entry e at bits 2e.
// The precalc rows are int2 on the narrow tier and longlong2 on the wide
// one; the bits are the same.
//
// Bound on the H100: reading the left column of the precalc table
// (4^p rows of 8 bytes, 537 MB at p = 13) twice over. Design: one thread
// per output word reads its 16 + 4 neighbouring rows, so neighbouring
// threads read neighbouring rows, and writes one word.
#include "sbwt_common.cuh"

namespace {

template <class Pair>
__global__ void seed_bits_kernel(const Pair* __restrict__ precalc, int p,
                                 int64_t n_out, unsigned* __restrict__ out) {
    const int64_t w = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (w >= n_out) return;
    const int64_t q_mask = ((int64_t)1 << (2 * p)) - 1;
    unsigned v = 0;
    for (int e = 0; e < 16; ++e) {
        const int64_t m = w * 16 + e;
        const unsigned b0 = precalc[m & q_mask].x >= 0;
        const unsigned b1 = precalc[m >> 2].x >= 0;
        v |= (b0 | (b1 << 1)) << (2 * e);
    }
    out[w] = v;
}

}  // namespace

extern "C" int sbwt_seed_bits(int device, const void* precalc, int p, int wide, void* out,
                              void* stream) {
    cudaSetDevice(device);
    const int64_t n_out = ((int64_t)1 << (2 * (p + 1))) / 16;
    const unsigned grid = sbwt::grid_for(n_out);
    const cudaStream_t s = (cudaStream_t)stream;
    if (wide) {
        seed_bits_kernel<<<grid, sbwt::kBlock, 0, s>>>((const longlong2*)precalc, p, n_out,
                                                       (unsigned*)out);
    } else {
        seed_bits_kernel<<<grid, sbwt::kBlock, 0, s>>>((const int2*)precalc, p, n_out,
                                                       (unsigned*)out);
    }
    return (int)cudaGetLastError();
}
