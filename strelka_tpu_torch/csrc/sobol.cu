// Kernel K1: the folded Owen-scrambled Sobol draw of one bounce.
//
// Replaces strelka_tpu/ops/sampler.py:random_dims_pallas (the Pallas kernel
// that streams sample indices through VMEM and emits all five dimensions of
// a bounce at once). Output [D, N] f32, bit-equal to sampler.random_dims.
//
// Per lane: Owen scramble of the sample index (reverse bits, Laine-Karras,
// reverse bits), the 32-step XOR fold of the direction numbers for each
// requested dimension, a second scramble per dimension, and the u32 -> f32
// conversion rounded to nearest (as XLA's cast), scaled by 2^-32 and
// clamped below 1.
//
// Bound on the H100: integer operations. Each lane reads 8 bytes, writes
// 4*D and spends some 700 32-bit integer instructions (the fold is 32 x
// (shift, and, negate, D x (and, xor))), so the int32 pipe, not memory,
// sets the pace. Design: one thread per lane, no shared memory, the
// direction numbers in constant memory (every thread of a warp reads the
// same word, which the constant cache broadcasts), __brev for the bit
// reversals, and coalesced [D, N] row writes.

#include "common.cuh"

namespace {

__constant__ uint32_t kSobolMatrix[5][32] = {
    {0x80000000u, 0x40000000u, 0x20000000u, 0x10000000u, 0x08000000u, 0x04000000u, 0x02000000u, 0x01000000u, 0x00800000u, 0x00400000u, 0x00200000u, 0x00100000u, 0x00080000u, 0x00040000u, 0x00020000u, 0x00010000u, 0x00008000u, 0x00004000u, 0x00002000u, 0x00001000u, 0x00000800u, 0x00000400u, 0x00000200u, 0x00000100u, 0x00000080u, 0x00000040u, 0x00000020u, 0x00000010u, 0x00000008u, 0x00000004u, 0x00000002u, 0x00000001u},
    {0x80000000u, 0xC0000000u, 0xA0000000u, 0xF0000000u, 0x88000000u, 0xCC000000u, 0xAA000000u, 0xFF000000u, 0x80800000u, 0xC0C00000u, 0xA0A00000u, 0xF0F00000u, 0x88880000u, 0xCCCC0000u, 0xAAAA0000u, 0xFFFF0000u, 0x80008000u, 0xC000C000u, 0xA000A000u, 0xF000F000u, 0x88008800u, 0xCC00CC00u, 0xAA00AA00u, 0xFF00FF00u, 0x80808080u, 0xC0C0C0C0u, 0xA0A0A0A0u, 0xF0F0F0F0u, 0x88888888u, 0xCCCCCCCCu, 0xAAAAAAAAu, 0xFFFFFFFFu},
    {0x80000000u, 0xC0000000u, 0x60000000u, 0x90000000u, 0xE8000000u, 0x5C000000u, 0x8E000000u, 0xC5000000u, 0x68800000u, 0x9CC00000u, 0xEE600000u, 0x55900000u, 0x80680000u, 0xC09C0000u, 0x60EE0000u, 0x90550000u, 0xE8808000u, 0x5CC0C000u, 0x8E606000u, 0xC5909000u, 0x6868E800u, 0x9C9C5C00u, 0xEEEE8E00u, 0x5555C500u, 0x8000E880u, 0xC0005CC0u, 0x60008E60u, 0x9000C590u, 0xE8006868u, 0x5C009C9Cu, 0x8E00EEEEu, 0xC5005555u},
    {0x80000000u, 0xC0000000u, 0x20000000u, 0x50000000u, 0xF8000000u, 0x74000000u, 0xA2000000u, 0x93000000u, 0xD8800000u, 0x25400000u, 0x59E00000u, 0xE6D00000u, 0x78080000u, 0xB40C0000u, 0x82020000u, 0xC3050000u, 0x208F8000u, 0x51474000u, 0xFBEA2000u, 0x75D93000u, 0xA0858800u, 0x914E5400u, 0xDBE79E00u, 0x25DB6D00u, 0x58800080u, 0xE54000C0u, 0x79E00020u, 0xB6D00050u, 0x800800F8u, 0xC00C0074u, 0x200200A2u, 0x50050093u},
    {0x80000000u, 0x40000000u, 0x20000000u, 0xB0000000u, 0xF8000000u, 0xDC000000u, 0x7A000000u, 0x9D000000u, 0x5A800000u, 0x2FC00000u, 0xA1600000u, 0xF0B00000u, 0xDA880000u, 0x6FC40000u, 0x81620000u, 0x40BB0000u, 0x22878000u, 0xB3C9C000u, 0xFB65A000u, 0xDDB2D000u, 0x78022800u, 0x9C0B3C00u, 0x5A0FB600u, 0x2D0DDB00u, 0xA2878080u, 0xF3C9C040u, 0xDB65A020u, 0x6DB2D0B0u, 0x800228F8u, 0x400B3CDCu, 0x200FB67Au, 0xB00DDB9Du},
};

constexpr int kMaxDims = 5;

struct DimList {
    int n;
    int dim[kMaxDims];
    uint32_t seed2[kMaxDims];  // hash_combine(seed, dim)
};

__host__ __device__ inline uint32_t hash_combine(uint32_t seed, uint32_t v) {
    return seed ^ (v + (seed << 6) + (seed >> 2));
}

__device__ inline uint32_t nested_uniform_scramble(uint32_t v, uint32_t seed) {
    v = __brev(v);
    v += seed;  // Laine-Karras permutation
    v ^= v * 0x6C50B47Cu;
    v ^= v * 0xB82F1E52u;
    v ^= v * 0xC7AFE638u;
    v ^= v * 0x8D22F6E6u;
    return __brev(v);
}

__global__ void __launch_bounds__(256) random_dims_kernel(const long long* __restrict__ sample_idx,
                                                          float* __restrict__ out, long long n,
                                                          uint32_t seed, DimList dims) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t index = nested_uniform_scramble(static_cast<uint32_t>(sample_idx[i]), seed);
    uint32_t acc[kMaxDims] = {0u, 0u, 0u, 0u, 0u};
#pragma unroll 8
    for (int bit = 0; bit < 32; ++bit) {
        const uint32_t mask = 0u - ((index >> bit) & 1u);
#pragma unroll
        for (int k = 0; k < kMaxDims; ++k) {
            if (k < dims.n) acc[k] ^= mask & kSobolMatrix[dims.dim[k]][bit];
        }
    }
#pragma unroll
    for (int k = 0; k < kMaxDims; ++k) {
        if (k < dims.n) {
            const uint32_t r = nested_uniform_scramble(acc[k], dims.seed2[k]);
            const float f = __uint2float_rn(r) * 0x1p-32f;
            out[k * n + i] = fminf(f, 0x1.fffffep-1f);
        }
    }
}

}  // namespace

// sample_idx: [n] int64 holding u32 values; out: [nd, n] f32.
// seed = hash_u32(52 + depth); dims_packed holds nd dimensions, 4 bits each.
extern "C" int strelka_random_dims(const void* sample_idx, void* out, long long n, uint32_t seed,
                                   int nd, int dims_packed, void* stream) {
    if (nd < 1 || nd > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
    DimList dims{};
    dims.n = nd;
    for (int k = 0; k < nd; ++k) {
        dims.dim[k] = (dims_packed >> (4 * k)) & 0xF;
        if (dims.dim[k] >= 5) return static_cast<int>(cudaErrorInvalidValue);
        dims.seed2[k] = hash_combine(seed, static_cast<uint32_t>(dims.dim[k]));
    }
    constexpr int threads = 256;
    random_dims_kernel<<<strelka_blocks(n, threads), threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(sample_idx), static_cast<float*>(out), n, seed, dims);
    STRELKA_RETURN_LAUNCH_STATUS();
}

extern "C" const char* strelka_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
