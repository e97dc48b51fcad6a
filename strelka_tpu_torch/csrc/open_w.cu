// Kernel K9: the per-tile slab pass over the superblock boxes, and the tile's
// sweep order.
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
// no superblock a ray's hit lies in.
// Outputs, all of them at every launch:
//   open   [n]            bool  does the ray pass a box that the tile has not
//                               swept yet, d2[tile, sb] >= r2t[tile]? (all
//                               false when d2 and r2t are null)
//   W      [n_tiles, nsb] bool  does any ray of the tile pass the box?
//   min_tn [n_tiles, nsb] f32   the least tnear over the tile's passing rays,
//                               1e16 where none passes (the near-to-far key)
//   order  [n_tiles, nsb] i32   the passed boxes by (min_tn, index), -0.0
//                               taken as +0.0, then the others in ascending
//                               order (kernels/open_w.py:sweep_order, the
//                               cone sweeps' order)
//   tnear  [n_tiles, nsb] f32   min_tn at each entry of order
//   count  [n_tiles]      i32   the boxes some ray of the tile passes
// A lane with bound <= tmin, or past n, passes nothing.
//
// Bound on the H100: f32 operations, 26 a (ray, box) pair for the reference's
// test (6 differences, 6 products, 6 minima and maxima of the pairs, 6 folds
// into tnear and tfar, 2 comparisons); the margin adds about 20. Design: one
// block a tile and one thread a box (nsb rounded up to a warp, at most 1024
// threads, looping over the boxes beyond). The block stages its rays'
// (o, |o|, 1/d, tmin, bound) in shared memory once; each thread loads its
// box, computes the box's scale once and walks the tile's rays, read as
// broadcasts, folding "some ray passes", the least tnear and the per-ray open
// flag in registers and shared memory: no ballot, no shuffle, no second
// pass. The order needs no general sort: most of a tile's boxes pass no ray
// (12-140 of hair_long's 391 pass) and keep their index order behind the
// passed ones. A ballot and a prefix over the warps place each passed box in
// a compact list, in index order; each passed box's slot is the count of
// list entries before it by (key, position), read as broadcasts (a stable
// rank: of equal keys the lower index first); an unpassed box j goes to
// slot count + (j - the passed boxes before j).

#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 232448;  // the H100's shared memory a block
constexpr float kBig = 1e16f;

// Shared memory a block takes (kernels/open_w.py:smem_bytes): the rays, 40
// bytes each; per box min_tn, the passed list's key and index and the box's
// place (16 bytes); one count a warp.
long long smem_bytes(int nsb, int tile) { return 40LL * tile + 16LL * nsb + 4LL * (kMaxThreads / 32); }

__global__ void __launch_bounds__(kMaxThreads)
    open_w_kernel(StrelkaRays rays, const float* __restrict__ sb, int nsb, const float* __restrict__ d2,
                  const float* __restrict__ r2t, int tile, long long n, unsigned char* __restrict__ open_out,
                  unsigned char* __restrict__ w_out, float* __restrict__ tn_out, int* __restrict__ order_out,
                  float* __restrict__ tnear_out, int* __restrict__ count_out) {
    extern __shared__ float4 smem[];
    float4* s_o = smem;                                        // [tile] o.xyz, |o|_inf
    float4* s_inv = s_o + tile;                                // [tile] 1/d.xyz, tmin
    float* s_bound = reinterpret_cast<float*>(s_inv + tile);  // [tile]
    int* s_open = reinterpret_cast<int*>(s_bound + tile);     // [tile]
    float* s_tn = reinterpret_cast<float*>(s_open + tile);    // [nsb] min_tn as written
    float* s_key = s_tn + nsb;                                 // [nsb] the passed list's keys, then
    int* s_idx = reinterpret_cast<int*>(s_key + nsb);         // [nsb] its boxes, in index order
    int* s_pre = s_idx + nsb;                                  // [nsb] passed boxes before j, -1 if j passed
    int* s_warp = s_pre + nsb;                                 // [32] passed boxes a warp
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const long long row0 = static_cast<long long>(blockIdx.x) * nsb;
    const long long i0 = static_cast<long long>(blockIdx.x) * tile;

    for (int r = tid; r < tile; r += blockDim.x) {
        const long long i = i0 + r;
        float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f), b = make_float4(1.0f, 1.0f, 1.0f, 0.0f);
        float bound = 0.0f;  // a lane past the end is dead: bound <= tmin
        if (i < n) {
            a.x = rays.ox[i]; a.y = rays.oy[i]; a.z = rays.oz[i];
            a.w = fmaxf(fmaxf(fabsf(a.x), fabsf(a.y)), fabsf(a.z));
            const float d0 = rays.dx[i], d1 = rays.dy[i], dz = rays.dz[i];
            b.x = 1.0f / (fabsf(d0) > 1e-20f ? d0 : 1e-20f);
            b.y = 1.0f / (fabsf(d1) > 1e-20f ? d1 : 1e-20f);
            b.z = 1.0f / (fabsf(dz) > 1e-20f ? dz : 1e-20f);
            b.w = rays.tmin[i];
            bound = rays.tmax[i];
        }
        s_o[r] = a;
        s_inv[r] = b;
        s_bound[r] = bound;
        s_open[r] = 0;
    }
    const float r2 = r2t ? r2t[blockIdx.x] : 0.0f;
    __syncthreads();

    // ---- the slab pass, one thread a box, the tile's rays as broadcasts; the passed boxes listed in index order
    int count = 0;  // passed boxes so far (the same in every thread)
    for (int j0 = 0; j0 < nsb; j0 += blockDim.x) {
        const int j = j0 + tid;
        bool any = false;
        float mn = kBig;
        if (j < nsb) {
            const float lx = sb[j], ly = sb[nsb + j], lz = sb[2 * nsb + j];
            const float hx = sb[3 * nsb + j], hy = sb[4 * nsb + j], hz = sb[5 * nsb + j];
            if (lx <= hx && ly <= hy && lz <= hz) {
                const float bm = strelka_box_scale(lx, ly, lz, hx, hy, hz);
                const bool unswept = d2 && d2[row0 + j] >= r2;
#pragma unroll 4
                for (int r = 0; r < tile; ++r) {
                    const float4 b = s_inv[r];
                    const float bound = s_bound[r];
                    if (!(b.w < bound)) continue;  // a dead lane (the same for every thread)
                    const float4 a = s_o[r];
                    const float tnear =
                        strelka_slab_safe(lx, ly, lz, hx, hy, hz, bm, a.x, a.y, a.z, b.x, b.y, b.z, a.w, b.w, bound);
                    if (tnear < bound) {  // INFINITY where the box is not entered: never below the bound
                        any = true;
                        mn = fminf(mn, tnear);
                        if (unswept) s_open[r] = 1;
                    }
                }
            }
            w_out[row0 + j] = any ? 1 : 0;
            tn_out[row0 + j] = mn;
            s_tn[j] = mn;
        }
        const unsigned vote = __ballot_sync(0xffffffffu, any);
        if (lane == 0) s_warp[warp] = __popc(vote);
        __syncthreads();
        int before = count, chunk = 0;
        for (int w = 0; w < (blockDim.x >> 5); ++w) {
            before += w < warp ? s_warp[w] : 0;
            chunk += s_warp[w];
        }
        before += __popc(vote & ((1u << lane) - 1u));
        if (j < nsb) {
            s_pre[j] = any ? -1 : before;
            if (any) {
                s_key[before] = mn + 0.0f;  // -0.0 taken as +0.0
                s_idx[before] = j;
            }
        }
        count += chunk;
        __syncthreads();
    }

    // ---- the row's order: each passed box at its rank, each unpassed one after them in index order
    for (int e = tid; e < count; e += blockDim.x) {
        const float key = s_key[e];
        int rank = 0;
        for (int f = 0; f < count; ++f) {
            const float k = s_key[f];
            rank += (k < key || (k == key && f < e)) ? 1 : 0;
        }
        const int j = s_idx[e];
        order_out[row0 + rank] = j;
        tnear_out[row0 + rank] = s_tn[j];
    }
    for (int j = tid; j < nsb; j += blockDim.x) {
        const int pre = s_pre[j];
        if (pre >= 0) {
            order_out[row0 + count + j - pre] = j;
            tnear_out[row0 + count + j - pre] = s_tn[j];
        }
    }
    if (tid == 0) count_out[blockIdx.x] = count;
    for (int r = tid; r < tile; r += blockDim.x)
        if (i0 + r < n) open_out[i0 + r] = s_open[r] ? 1 : 0;
}

}  // namespace

// Rays: 8 f32 [n] component arrays (the eighth is the per-ray bound).
// sbounds f32 [8, nsb]; d2 f32 [n_tiles, nsb] and r2t f32 [n_tiles], or both
// null; tile a multiple of 32, at most 1024; n_tiles = ceil(n / tile).
// Outputs: open uint8 (torch.bool) [n], W uint8 [n_tiles, nsb], min_tn f32
// [n_tiles, nsb], order i32 [n_tiles, nsb], tnear f32 [n_tiles, nsb], count
// i32 [n_tiles].
extern "C" int strelka_open_w(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                              const void* dz, const void* tmin, const void* bound, const void* sbounds, int nsb,
                              const void* d2, const void* r2t, int tile, long long n, void* open_out, void* w_out,
                              void* tn_out, void* order_out, void* tnear_out, void* count_out, void* stream) {
    if (nsb < 1 || tile < 32 || tile > kMaxThreads || tile % 32) return static_cast<int>(cudaErrorInvalidValue);
    const long long smem = smem_bytes(nsb, tile);
    if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
    if (smem > 48 * 1024) {
        const cudaError_t err = cudaFuncSetAttribute(open_w_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                     static_cast<int>(smem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int threads = nsb < kMaxThreads ? (nsb + 31) / 32 * 32 : kMaxThreads;
    open_w_kernel<<<strelka_blocks(n, tile), threads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
        strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, bound, nullptr), static_cast<const float*>(sbounds), nsb,
        static_cast<const float*>(d2), static_cast<const float*>(r2t), tile, n, static_cast<unsigned char*>(open_out),
        static_cast<unsigned char*>(w_out), static_cast<float*>(tn_out), static_cast<int*>(order_out),
        static_cast<float*>(tnear_out), static_cast<int*>(count_out));
    STRELKA_RETURN_LAUNCH_STATUS();
}
