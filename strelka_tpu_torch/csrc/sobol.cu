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
// Bound on the H100: integer operations. Each lane reads 8 bytes and writes
// 4*D; the fold is the most of its instructions, so the integer pipe, not
// memory, sets the pace. Design: one thread per lane, no shared memory,
// coalesced [D, N] row writes, and a kernel for each set of dimensions
// drawn (a template on the set's 5-bit mask, 31 instances, one per set the
// wrapper accepts). In an instance every column of the fold is a constant
// of the instruction stream: a bit of the index sets one predicate, and
// each dimension's step is one predicated LOP3 that xors an immediate (no
// constant-memory loads in the fold). Dimension 0's matrix is the identity
// read backwards, so its fold is __brev(index). The order of the output
// rows (a list may repeat a dimension or name them in any order) is a
// kernel argument: for each dimension a mask of the rows it is written to.

#include <array>
#include <utility>

#include "common.cuh"

namespace {

constexpr int kMaxDims = 5;

// RandomSampler.h:139-164; the kernels read it only at compile time
constexpr uint32_t kSobolMatrix[kMaxDims][32] = {
    {0x80000000u, 0x40000000u, 0x20000000u, 0x10000000u, 0x08000000u, 0x04000000u, 0x02000000u, 0x01000000u, 0x00800000u, 0x00400000u, 0x00200000u, 0x00100000u, 0x00080000u, 0x00040000u, 0x00020000u, 0x00010000u, 0x00008000u, 0x00004000u, 0x00002000u, 0x00001000u, 0x00000800u, 0x00000400u, 0x00000200u, 0x00000100u, 0x00000080u, 0x00000040u, 0x00000020u, 0x00000010u, 0x00000008u, 0x00000004u, 0x00000002u, 0x00000001u},
    {0x80000000u, 0xC0000000u, 0xA0000000u, 0xF0000000u, 0x88000000u, 0xCC000000u, 0xAA000000u, 0xFF000000u, 0x80800000u, 0xC0C00000u, 0xA0A00000u, 0xF0F00000u, 0x88880000u, 0xCCCC0000u, 0xAAAA0000u, 0xFFFF0000u, 0x80008000u, 0xC000C000u, 0xA000A000u, 0xF000F000u, 0x88008800u, 0xCC00CC00u, 0xAA00AA00u, 0xFF00FF00u, 0x80808080u, 0xC0C0C0C0u, 0xA0A0A0A0u, 0xF0F0F0F0u, 0x88888888u, 0xCCCCCCCCu, 0xAAAAAAAAu, 0xFFFFFFFFu},
    {0x80000000u, 0xC0000000u, 0x60000000u, 0x90000000u, 0xE8000000u, 0x5C000000u, 0x8E000000u, 0xC5000000u, 0x68800000u, 0x9CC00000u, 0xEE600000u, 0x55900000u, 0x80680000u, 0xC09C0000u, 0x60EE0000u, 0x90550000u, 0xE8808000u, 0x5CC0C000u, 0x8E606000u, 0xC5909000u, 0x6868E800u, 0x9C9C5C00u, 0xEEEE8E00u, 0x5555C500u, 0x8000E880u, 0xC0005CC0u, 0x60008E60u, 0x9000C590u, 0xE8006868u, 0x5C009C9Cu, 0x8E00EEEEu, 0xC5005555u},
    {0x80000000u, 0xC0000000u, 0x20000000u, 0x50000000u, 0xF8000000u, 0x74000000u, 0xA2000000u, 0x93000000u, 0xD8800000u, 0x25400000u, 0x59E00000u, 0xE6D00000u, 0x78080000u, 0xB40C0000u, 0x82020000u, 0xC3050000u, 0x208F8000u, 0x51474000u, 0xFBEA2000u, 0x75D93000u, 0xA0858800u, 0x914E5400u, 0xDBE79E00u, 0x25DB6D00u, 0x58800080u, 0xE54000C0u, 0x79E00020u, 0xB6D00050u, 0x800800F8u, 0xC00C0074u, 0x200200A2u, 0x50050093u},
    {0x80000000u, 0x40000000u, 0x20000000u, 0xB0000000u, 0xF8000000u, 0xDC000000u, 0x7A000000u, 0x9D000000u, 0x5A800000u, 0x2FC00000u, 0xA1600000u, 0xF0B00000u, 0xDA880000u, 0x6FC40000u, 0x81620000u, 0x40BB0000u, 0x22878000u, 0xB3C9C000u, 0xFB65A000u, 0xDDB2D000u, 0x78022800u, 0x9C0B3C00u, 0x5A0FB600u, 0x2D0DDB00u, 0xA2878080u, 0xF3C9C040u, 0xDB65A020u, 0x6DB2D0B0u, 0x800228F8u, 0x400B3CDCu, 0x200FB67Au, 0xB00DDB9Du},
};

constexpr bool dim0_is_reversal() {
    for (int b = 0; b < 32; ++b)
        if (kSobolMatrix[0][b] != (1u << (31 - b))) return false;
    return true;
}
static_assert(dim0_is_reversal(), "dimension 0's fold is __brev(index) only while its matrix is the reversed identity");

// Column B of dimension D as a constant of the instruction stream.
template <int D, int B>
struct Column {
    static constexpr uint32_t value = kSobolMatrix[D][B];
};

// Per dimension drawn: its second scramble seed, hash_combine(seed, dim),
// and the output rows it goes to (bit k: row k).
struct DimRows {
    uint32_t seed2[kMaxDims];
    uint32_t rows[kMaxDims];
};

__host__ __device__ inline uint32_t hash_combine(uint32_t seed, uint32_t v) {
    return seed ^ (v + (seed << 6) + (seed >> 2));
}

__device__ __forceinline__ uint32_t nested_uniform_scramble(uint32_t v, uint32_t seed) {
    v = __brev(v);
    v += seed;  // Laine-Karras permutation
    v ^= v * 0x6C50B47Cu;
    v ^= v * 0xB82F1E52u;
    v ^= v * 0xC7AFE638u;
    v ^= v * 0x8D22F6E6u;
    return __brev(v);
}

// One bit of the fold: where bit B of the index is set, each drawn
// dimension above 0 xors its column B.
template <unsigned kSet, int B>
__device__ __forceinline__ void fold_bit(uint32_t index, uint32_t (&acc)[kMaxDims]) {
    if (index & (1u << B)) {
        if (kSet & 2u) acc[1] ^= Column<1, B>::value;
        if (kSet & 4u) acc[2] ^= Column<2, B>::value;
        if (kSet & 8u) acc[3] ^= Column<3, B>::value;
        if (kSet & 16u) acc[4] ^= Column<4, B>::value;
    }
}

template <unsigned kSet, int... B>
__device__ __forceinline__ void fold(uint32_t index, uint32_t (&acc)[kMaxDims], std::integer_sequence<int, B...>) {
    (fold_bit<kSet, B>(index, acc), ...);
}

template <unsigned kSet>
__global__ void __launch_bounds__(256) random_dims_kernel(const long long* __restrict__ sample_idx,
                                                          float* __restrict__ out, long long n, uint32_t seed,
                                                          DimRows dims) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t index = nested_uniform_scramble(static_cast<uint32_t>(sample_idx[i]), seed);
    uint32_t acc[kMaxDims] = {0u, 0u, 0u, 0u, 0u};
    if (kSet & 1u) acc[0] = __brev(index);
    fold<kSet>(index, acc, std::make_integer_sequence<int, 32>{});
#pragma unroll
    for (int d = 0; d < kMaxDims; ++d) {
        if (!(kSet & (1u << d))) continue;
        const uint32_t r = nested_uniform_scramble(acc[d], dims.seed2[d]);
        const float f = fminf(__uint2float_rn(r) * 0x1p-32f, 0x1.fffffep-1f);
#pragma unroll
        for (int k = 0; k < kMaxDims; ++k)
            if (dims.rows[d] & (1u << k)) out[k * n + i] = f;
    }
}

using Launcher = void (*)(const long long*, float*, long long, uint32_t, DimRows, unsigned int, cudaStream_t);

template <unsigned kSet>
void launch(const long long* idx, float* out, long long n, uint32_t seed, DimRows dims, unsigned int blocks,
            cudaStream_t stream) {
    random_dims_kernel<kSet><<<blocks, 256, 0, stream>>>(idx, out, n, seed, dims);
}

template <unsigned... S>
std::array<Launcher, sizeof...(S)> launchers(std::integer_sequence<unsigned, S...>) {
    return {launch<S + 1>...};
}

// kLaunch[set - 1]: the instance of each non-empty set of dimensions
const std::array<Launcher, (1u << kMaxDims) - 1> kLaunch =
    launchers(std::make_integer_sequence<unsigned, (1u << kMaxDims) - 1>{});

}  // namespace

// sample_idx: [n] int64 holding u32 values; out: [nd, n] f32.
// seed = hash_u32(52 + depth); dims_packed holds nd dimensions, 4 bits each
// (row k draws dimension (dims_packed >> 4k) & 0xF).
extern "C" int strelka_random_dims(const void* sample_idx, void* out, long long n, uint32_t seed,
                                   int nd, int dims_packed, void* stream) {
    if (nd < 1 || nd > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
    DimRows dims{};
    unsigned set = 0;
    for (int k = 0; k < nd; ++k) {
        const int d = (dims_packed >> (4 * k)) & 0xF;
        if (d >= kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
        set |= 1u << d;
        dims.rows[d] |= 1u << k;
    }
    for (int d = 0; d < kMaxDims; ++d) dims.seed2[d] = hash_combine(seed, static_cast<uint32_t>(d));
    constexpr int threads = 256;
    kLaunch[set - 1](static_cast<const long long*>(sample_idx), static_cast<float*>(out), n, seed, dims,
                     strelka_blocks(n, threads), static_cast<cudaStream_t>(stream));
    STRELKA_RETURN_LAUNCH_STATUS();
}

extern "C" const char* strelka_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
