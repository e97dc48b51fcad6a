// Kernel K4: row gather with transpose, out[f, n] = table[clip(idx[n]), f].
//
// Replaces strelka_tpu/ops/pallas_gather.py:pallas_gather_rows_t, which on
// the TPU reads table rows at hit points as a one-hot bf16x3 matmul (the TPU
// has no per-lane gather). On the card a gather is a load, so the kernel is
// a plain copy and bit-exact by construction. Indices are clipped to
// [0, T-1] as the Pallas kernel clips them.
//
// Bound on the H100: bytes. It reads 4 bytes of index and the rows these
// indices name, and writes 4*F bytes a lane ([68, 2^20] is 285 MB, more than
// the 50 MB L2); a copy does no arithmetic, so the design spends as few
// instructions a word as it can and moves 16 bytes an access:
//   * one block of kLanes = 128 lanes and 128 threads; thread t reads lane
//     t's index once (clipped, in a register) and copies its row into a
//     shared tile, as float4 loads when every row starts 16-byte aligned
//     (cols % 4 == 0 and an aligned table: the main paths' widths 68, 24 and
//     20), else one word at a time: no division anywhere, the loops step by
//     column;
//   * the tile is [cols][kLanes] words, stride kLanes (no padding): the
//     copy-in writes word f of 32 consecutive lanes, 32 banks; the copy-out
//     reads 4 consecutive lanes of one column as a float4, and a warp's 32
//     float4 reads are one 512-byte run, conflict-free in both phases;
//   * warp w writes columns w, w + 4, ...: each a 512-byte run of the
//     output row f, as float4 stores where n % 4 == 0 (2^20, 2^19 and
//     294,912 lanes), else one word a lane, the last block's ragged edge
//     included;
//   * the stores are streaming stores (__stcs, evict first): nothing reads
//     the output in this kernel, and on the H100 they took 7-11% less time
//     than plain stores at four of the main paths' five shapes, the same at
//     the fifth (PERF.md section 6).
// The tile takes 512 bytes a column: up to 96 columns in the default 48 KB
// of shared memory, up to kMaxCols with the dynamic shared-memory attribute.

#include "common.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kWarps = kLanes / 32;
constexpr int kMaxSmem = 232448;  // the H100's shared memory a block
constexpr int kMaxCols = kMaxSmem / (kLanes * 4);

__global__ void __launch_bounds__(kLanes) gather_rows_t_kernel(const float* __restrict__ table,
                                                               const int* __restrict__ idx, float* __restrict__ out,
                                                               long long n, int rows, int cols, int vec_rows) {
    extern __shared__ float4 tile4[];
    float* tile = reinterpret_cast<float*>(tile4);  // [cols][kLanes]
    const long long n0 = static_cast<long long>(blockIdx.x) * kLanes;
    const int lanes = static_cast<int>(min(static_cast<long long>(kLanes), n - n0));
    const int t = threadIdx.x;
    if (t < lanes) {
        const long long r = min(max(__ldg(idx + n0 + t), 0), rows - 1);
        float* col = tile + t;
        if (vec_rows) {
            const float4* row = reinterpret_cast<const float4*>(table + r * cols);
#pragma unroll 4
            for (int f = 0; f < cols; f += 4, ++row) {
                const float4 v = __ldg(row);
                col[(f + 0) * kLanes] = v.x;
                col[(f + 1) * kLanes] = v.y;
                col[(f + 2) * kLanes] = v.z;
                col[(f + 3) * kLanes] = v.w;
            }
        } else {
            const float* row = table + r * cols;
            for (int f = 0; f < cols; ++f) col[f * kLanes] = __ldg(row + f);
        }
    }
    __syncthreads();
    const int warp = t >> 5, lane = t & 31;
    if ((n & 3) == 0) {  // every output row 16-byte aligned; lanes % 4 == 0 in every block
        const int quads = lanes >> 2;
        for (int f = warp; f < cols; f += kWarps) {
            float4* dst = reinterpret_cast<float4*>(out + f * n + n0);
            const float4* src = reinterpret_cast<const float4*>(tile + f * kLanes);
            for (int q = lane; q < quads; q += 32) __stcs(dst + q, src[q]);
        }
    } else {
        for (int f = warp; f < cols; f += kWarps) {
            float* dst = out + f * n + n0;
            const float* src = tile + f * kLanes;
            for (int l = lane; l < lanes; l += 32) __stcs(dst + l, src[l]);
        }
    }
}

}  // namespace

// table: [rows, cols] f32, idx: [n] int32, out: [cols, n] f32 (16-byte
// aligned, as PyTorch allocates).
extern "C" int strelka_gather_rows_t(const void* table, const void* idx, void* out, long long n, int rows, int cols,
                                     void* stream) {
    if (rows < 1 || cols < 1 || cols > kMaxCols || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t smem = sizeof(float) * kLanes * cols;
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(gather_rows_t_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int vec_rows = (cols & 3) == 0 && (reinterpret_cast<uintptr_t>(table) & 15) == 0;
    gather_rows_t_kernel<<<strelka_blocks(n, kLanes), kLanes, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(table), static_cast<const int*>(idx), static_cast<float*>(out), n, rows, cols,
        vec_rows);
    STRELKA_RETURN_LAUNCH_STATUS();
}
