// Kernel K9: the per-tile slab pass over the superblock boxes.
//
// Replaces strelka_tpu/ops/pallas_intersect.py:pallas_open_w. Rays go in
// tiles of `tile` consecutive lanes; each ray has the interval
// [tmin, bound]. Against every superblock box sb ([8, nsb]: lo.xyz, hi.xyz)
// a ray passes when the port's box test (common.cuh:strelka_slab_safe, the
// reference's slab test with a margin) enters the padded box, tnear < bound,
// tmin < bound and lo <= hi on all three axes, tnear being the test's
// lowered tnear (built with -fmad=false: every operation rounds once, as in
// the plain PyTorch version strelka_tpu_torch/kernels/open_w.py:open_w_plain).
// The padded box holds every cone hit in the box, so a tile's list leaves out
// no superblock a ray's hit lies in (kernels/open_w.py:sweep_order, the cone
// sweeps' order).
// Outputs:
//   W      [n_tiles, nsb] bool  does any ray of the tile pass the box?
//   min_tn [n_tiles, nsb] f32   the least tnear over the tile's passing rays,
//                               1e16 where none passes (the near-to-far key)
//   open   [n]            bool  does the ray pass a box that the tile has not
//                               swept yet, d2[tile, sb] >= r2t[tile]? (all
//                               false when d2 and r2t are null)
// A lane with bound <= tmin passes nothing.
//
// Bound on the H100: f32 operations, 26 a (ray, box) pair (6 differences,
// 6 products, 6 minima and maxima of the pairs, 6 folds into tnear and tfar,
// 2 comparisons), against the bytes of the rays and the two matrices. Design:
// one thread block a tile, one ray a thread, the ray in registers. The boxes
// go by in chunks of 128 staged in shared memory; per box each warp votes
// (ballot) and, only where a lane passes, folds the least tnear by shuffles;
// the warps' partial results meet in shared memory and one thread a box
// writes the tile's row.

#include "common.cuh"

namespace {

constexpr int kChunk = 128;
constexpr int kMaxWarps = 32;
constexpr float kBig = 1e16f;

__global__ void open_w_kernel(StrelkaRays rays, const float* __restrict__ sb, int nsb,
                              const float* __restrict__ d2, const float* __restrict__ r2t, long long n,
                              unsigned char* __restrict__ open_out, unsigned char* __restrict__ w_out,
                              float* __restrict__ tn_out) {
    __shared__ float s_box[6][kChunk];
    __shared__ float s_min[kMaxWarps][kChunk];
    __shared__ unsigned char s_any[kMaxWarps][kChunk];
    const int tile = blockIdx.x;
    const long long i = static_cast<long long>(tile) * blockDim.x + threadIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
    // a lane past the end is dead: it votes with the others and passes nothing
    float tn = 0.0f, bound = 0.0f, o0 = 0.0f, o1 = 0.0f, o2 = 0.0f, inv0 = 1.0f, inv1 = 1.0f, inv2 = 1.0f, om = 0.0f;
    if (i < n) {
        tn = rays.tmin[i];
        bound = rays.tmax[i];
        o0 = rays.ox[i]; o1 = rays.oy[i]; o2 = rays.oz[i];
        const float d0 = rays.dx[i], d1 = rays.dy[i], dz = rays.dz[i];
        inv0 = 1.0f / (fabsf(d0) > 1e-20f ? d0 : 1e-20f);
        inv1 = 1.0f / (fabsf(d1) > 1e-20f ? d1 : 1e-20f);
        inv2 = 1.0f / (fabsf(dz) > 1e-20f ? dz : 1e-20f);
        om = fmaxf(fmaxf(fabsf(o0), fabsf(o1)), fabsf(o2));
    }
    const float r2 = r2t ? r2t[tile] : 0.0f;
    const float* __restrict__ d2_row = d2 ? d2 + static_cast<long long>(tile) * nsb : nullptr;
    bool open = false;
    for (int c0 = 0; c0 < nsb; c0 += kChunk) {
        const int m = min(kChunk, nsb - c0);
        for (int j = threadIdx.x; j < 6 * m; j += blockDim.x) {
            const int row = j / m, col = j - row * m;
            s_box[row][col] = sb[static_cast<long long>(row) * nsb + c0 + col];
        }
        __syncthreads();
        for (int j = 0; j < m; ++j) {
            const float lx = s_box[0][j], ly = s_box[1][j], lz = s_box[2][j];
            const float hx = s_box[3][j], hy = s_box[4][j], hz = s_box[5][j];
            const float tnear = strelka_slab_safe(lx, ly, lz, hx, hy, hz, strelka_box_scale(lx, ly, lz, hx, hy, hz),
                                                  o0, o1, o2, inv0, inv1, inv2, om, tn, bound);
            const bool pass = tnear != INFINITY && tnear < bound && tn < bound && lx <= hx && ly <= hy && lz <= hz;
            const unsigned vote = __ballot_sync(0xffffffffu, pass);
            float mn = kBig;
            if (vote) {  // the same for every lane of the warp
                mn = pass ? tnear : kBig;
                for (int s = 16; s > 0; s >>= 1) mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, s));
                if (pass && d2_row && d2_row[c0 + j] >= r2) open = true;
            }
            if (lane == 0) {
                s_min[warp][j] = mn;
                s_any[warp][j] = vote ? 1 : 0;
            }
        }
        __syncthreads();
        for (int j = threadIdx.x; j < m; j += blockDim.x) {
            float mn = kBig;
            unsigned char any = 0;
            for (int w = 0; w < warps; ++w) {
                mn = fminf(mn, s_min[w][j]);
                any |= s_any[w][j];
            }
            const long long at = static_cast<long long>(tile) * nsb + c0 + j;
            w_out[at] = any;
            tn_out[at] = mn;
        }
        __syncthreads();
    }
    if (i < n) open_out[i] = open ? 1 : 0;
}

}  // namespace

// Rays: 8 f32 [n] component arrays (the eighth is the per-ray bound).
// sbounds f32 [8, nsb]; d2 f32 [n_tiles, nsb] and r2t f32 [n_tiles], or both
// null; tile a multiple of 32, at most 1024; n_tiles = ceil(n / tile).
// Outputs: open uint8 (torch.bool) [n], W uint8 [n_tiles, nsb], min_tn f32
// [n_tiles, nsb].
extern "C" int strelka_open_w(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                              const void* dz, const void* tmin, const void* bound, const void* sbounds, int nsb,
                              const void* d2, const void* r2t, int tile, long long n, void* open_out, void* w_out,
                              void* tn_out, void* stream) {
    open_w_kernel<<<strelka_blocks(n, tile), tile, 0, static_cast<cudaStream_t>(stream)>>>(
        strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, bound, nullptr), static_cast<const float*>(sbounds), nsb,
        static_cast<const float*>(d2), static_cast<const float*>(r2t), n, static_cast<unsigned char*>(open_out),
        static_cast<unsigned char*>(w_out), static_cast<float*>(tn_out));
    STRELKA_RETURN_LAUNCH_STATUS();
}
