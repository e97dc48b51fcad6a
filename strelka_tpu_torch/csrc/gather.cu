// Kernel K4: row gather with transpose, out[f, n] = table[clip(idx[n]), f].
//
// Replaces strelka_tpu/ops/pallas_gather.py:pallas_gather_rows_t, which on
// the TPU reads table rows at hit points as a one-hot bf16x3 matmul (the TPU
// has no per-lane gather). On the card a gather is a load, so the kernel is
// a plain copy and bit-exact by construction. Indices are clipped to
// [0, T-1] as the Pallas kernel clips them.
//
// Bound on the H100: bytes. It reads 4 bytes of index and writes 4*F bytes
// per lane; the table (a few hundred KB for scenes of this size) stays in L2.
// Design: a block stages the rows of 64 lanes in shared memory, reading each
// row contiguously (coalesced along F), then writes the [F, 64] block out
// coalesced along N. The shared tile has a stride of F+1 words so that the
// transposed reads do not collide on banks.

#include "common.cuh"

namespace {

constexpr int kLanesPerBlock = 64;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) gather_rows_t_kernel(const float* __restrict__ table,
                                                                 const int* __restrict__ idx,
                                                                 float* __restrict__ out, long long n,
                                                                 int rows, int cols) {
    extern __shared__ float tile[];  // [kLanesPerBlock][cols + 1]
    const int stride = cols + 1;
    const long long n0 = static_cast<long long>(blockIdx.x) * kLanesPerBlock;
    const int lanes = static_cast<int>(min(static_cast<long long>(kLanesPerBlock), n - n0));
    for (int k = threadIdx.x; k < lanes * cols; k += blockDim.x) {
        const int lane = k / cols;
        const int f = k - lane * cols;
        const int r = min(max(idx[n0 + lane], 0), rows - 1);
        tile[lane * stride + f] = table[static_cast<long long>(r) * cols + f];
    }
    __syncthreads();
    for (int k = threadIdx.x; k < lanes * cols; k += blockDim.x) {
        const int f = k / lanes;
        const int lane = k - f * lanes;
        out[static_cast<long long>(f) * n + n0 + lane] = tile[lane * stride + f];
    }
}

}  // namespace

// table: [rows, cols] f32, idx: [n] int32, out: [cols, n] f32.
extern "C" int strelka_gather_rows_t(const void* table, const void* idx, void* out, long long n,
                                     int rows, int cols, void* stream) {
    if (rows < 1 || cols < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * kLanesPerBlock * (cols + 1);
    if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
    const unsigned int blocks = strelka_blocks(n, kLanesPerBlock);
    gather_rows_t_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int*>(idx), static_cast<float*>(out), n, rows,
        cols);
    STRELKA_RETURN_LAUNCH_STATUS();
}
