// Kernels K2 (closest hit) and K3 (any hit) over a flat triangle list.
//
// Replace strelka_tpu/ops/pallas_intersect.py:pallas_intersect_closest_mxu_small
// and pallas_intersect_any_mxu_small. On the TPU those hold the whole
// triangle set in VMEM and run Möller–Trumbore as four matmuls over ray
// features (bf16 passes, a packed t/row fold). None of that carries over:
// here MT is the f32 arithmetic of strelka_tpu/ops/intersect.py:_ray_tri_block
// term by term, and this file is built with -fmad=false so that every
// product and sum rounds on its own, as on the CPU reference.
//
// Contract (same as intersect_closest_bruteforce / intersect_any_bruteforce):
//   hit = |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, tmin < t < tmax,
//         (geom_mask & ray_mask) != 0, prim != exclude.
//   K2 keeps the smallest t; on equal t the lowest prim id wins (triangles
//   are visited in ascending id with a strict <). A miss is t = 1e16,
//   prim = -1, u = v = 0. K3 writes 1 at the first hit and stops.
//
// Bound on the H100: f32 operations, 46 per ray-triangle test (two crosses,
// four dots, the subtractions and the three scalings by 1/det), against the
// non-tensor f32 rate; rays and triangles are a few MB at most. Design: one
// ray per thread; triangles stream through shared memory in tiles of 1024
// (v0, e1, e2 and mask: 10 words, 40 KB), loaded once per block and read by
// all its 256 rays as warp-wide broadcasts. A scene of up to 1024 triangles
// (Cornell's 640 padded) is one tile; larger flat scenes loop over tiles. A
// block whose rays are all dead (tmax <= tmin) skips the sweep, and K3 stops
// loading tiles once every ray of the block is occluded.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTriTile = 1024;
constexpr float kMiss = 1e16f;

using Rays = StrelkaRays;

using Tris = StrelkaTris;

struct TriTile {
    float v[9][kTriTile];  // v0 xyz, e1 xyz, e2 xyz
    int mask[kTriTile];
};

__device__ inline void load_tile(TriTile& s, const Tris& tris, int base, int cnt) {
    for (int k = threadIdx.x; k < cnt * 3; k += blockDim.x) {
        const long long g = static_cast<long long>(base) * 3 + k;
        const int j = k / 3;
        const int c = k - j * 3;
        s.v[c][j] = tris.v0[g];
        s.v[3 + c][j] = tris.e1[g];
        s.v[6 + c][j] = tris.e2[g];
    }
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) s.mask[j] = tris.mask[base + j];
}

// Möller–Trumbore in the operation order of _ray_tri_block.
__device__ inline bool ray_tri(const TriTile& s, int j, float o0, float o1, float o2, float d0, float d1,
                               float d2, float tn, float tx, float& t, float& u, float& v) {
    return strelka_ray_tri(s.v[0][j], s.v[1][j], s.v[2][j], s.v[3][j], s.v[4][j], s.v[5][j], s.v[6][j], s.v[7][j],
                           s.v[8][j], o0, o1, o2, d0, d1, d2, tn, tx, t, u, v);
}

__global__ void __launch_bounds__(kThreads) closest_kernel(Rays rays, Tris tris, int ray_mask, long long n,
                                                           float* __restrict__ t_out, int* __restrict__ prim_out,
                                                           float* __restrict__ u_out, float* __restrict__ v_out) {
    __shared__ TriTile s;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const bool in_range = i < n;
    float o0 = 0.f, o1 = 0.f, o2 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f, tn = 0.f, tx = 0.f;
    int ex = -1;
    if (in_range) {
        o0 = rays.ox[i]; o1 = rays.oy[i]; o2 = rays.oz[i];
        d0 = rays.dx[i]; d1 = rays.dy[i]; d2 = rays.dz[i];
        tn = rays.tmin[i]; tx = rays.tmax[i];
        if (rays.exclude) ex = rays.exclude[i];
    }
    const bool live = in_range && tx > tn;
    float best_t = kMiss, best_u = 0.f, best_v = 0.f;
    int best_p = -1;
    if (__syncthreads_or(live)) {
        for (int base = 0; base < tris.count; base += kTriTile) {
            const int cnt = min(kTriTile, tris.count - base);
            __syncthreads();  // previous tile fully read
            load_tile(s, tris, base, cnt);
            __syncthreads();
            if (live) {
                for (int j = 0; j < cnt; ++j) {
                    float t, u, v;
                    const bool hit = ray_tri(s, j, o0, o1, o2, d0, d1, d2, tn, tx, t, u, v);
                    if (hit && (s.mask[j] & ray_mask) != 0 && base + j != ex && t < best_t) {
                        best_t = t;
                        best_p = base + j;
                        best_u = u;
                        best_v = v;
                    }
                }
            }
        }
    }
    if (in_range) {
        t_out[i] = best_t;
        prim_out[i] = best_p;
        u_out[i] = best_u;
        v_out[i] = best_v;
    }
}

__global__ void __launch_bounds__(kThreads) any_kernel(Rays rays, Tris tris, int ray_mask, long long n,
                                                       unsigned char* __restrict__ occ_out) {
    __shared__ TriTile s;
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const bool in_range = i < n;
    float o0 = 0.f, o1 = 0.f, o2 = 0.f, d0 = 0.f, d1 = 0.f, d2 = 0.f, tn = 0.f, tx = 0.f;
    int ex = -1;
    if (in_range) {
        o0 = rays.ox[i]; o1 = rays.oy[i]; o2 = rays.oz[i];
        d0 = rays.dx[i]; d1 = rays.dy[i]; d2 = rays.dz[i];
        tn = rays.tmin[i]; tx = rays.tmax[i];
        if (rays.exclude) ex = rays.exclude[i];
    }
    bool occ = false;
    for (int base = 0; base < tris.count; base += kTriTile) {
        const bool searching = in_range && tx > tn && !occ;
        if (!__syncthreads_or(searching)) break;  // also orders the previous tile's reads
        const int cnt = min(kTriTile, tris.count - base);
        load_tile(s, tris, base, cnt);
        __syncthreads();
        if (searching) {
            for (int j = 0; j < cnt; ++j) {
                float t, u, v;
                if (ray_tri(s, j, o0, o1, o2, d0, d1, d2, tn, tx, t, u, v) && (s.mask[j] & ray_mask) != 0 &&
                    base + j != ex) {
                    occ = true;
                    break;
                }
            }
        }
    }
    if (in_range) occ_out[i] = occ ? 1 : 0;
}

}  // namespace

// Rays: 8 f32 [n] component arrays + exclude int32 [n] (or null).
// Triangles: v0/e1/e2 f32 [ntri, 3], geometry mask int32 [ntri].
// Outputs: t f32, prim int32, u f32, v f32, each [n].
extern "C" int strelka_intersect_closest(const void* ox, const void* oy, const void* oz, const void* dx,
                                         const void* dy, const void* dz, const void* tmin, const void* tmax,
                                         const void* exclude, const void* v0, const void* e1, const void* e2,
                                         const void* mask, int ray_mask, long long n, int ntri, void* t_out,
                                         void* prim_out, void* u_out, void* v_out, void* stream) {
    closest_kernel<<<strelka_blocks(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, tmax, exclude), strelka_make_tris(v0, e1, e2, mask, ntri),
        ray_mask, n,
        static_cast<float*>(t_out), static_cast<int*>(prim_out), static_cast<float*>(u_out),
        static_cast<float*>(v_out));
    STRELKA_RETURN_LAUNCH_STATUS();
}

// Same rays and triangles; output occlusion as uint8 (torch.bool) [n].
extern "C" int strelka_intersect_any(const void* ox, const void* oy, const void* oz, const void* dx,
                                     const void* dy, const void* dz, const void* tmin, const void* tmax,
                                     const void* exclude, const void* v0, const void* e1, const void* e2,
                                     const void* mask, int ray_mask, long long n, int ntri, void* occ_out,
                                     void* stream) {
    any_kernel<<<strelka_blocks(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, tmax, exclude), strelka_make_tris(v0, e1, e2, mask, ntri),
        ray_mask, n,
        static_cast<unsigned char*>(occ_out));
    STRELKA_RETURN_LAUNCH_STATUS();
}
