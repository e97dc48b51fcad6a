// Kernels K5 (closest hit) and K6 (any hit) over a threaded BVH.
//
// Replace the large-scene intersection kernels of
// strelka_tpu/ops/pallas_intersect.py: the superblock sweeps
// (pallas_intersect_closest / _any and their _mxu forms), phase 1 of the
// residual two-pass (the four _fusedk kernels), pallas_open_w and the four
// work-list kernels (_wl, _wl_mxu). On the TPU those are dense sweeps of
// ray tiles against 8x256-triangle superblocks, culled by AABBs and ordered
// by tables, because the TPU has no per-lane gather. All of them compute one
// function: the closest (t, prim), or occlusion, of each ray against a large
// triangle set. On the card a per-thread pointer chase is cheap, so that
// function is the CPU reference's own: strelka_tpu/ops/bvh.py:intersect_bvh,
// the stackless walk over a DFS-ordered BVH with skip links.
//
// Contract (intersect_bvh, and its plain PyTorch version
// strelka_tpu_torch/ops/bvh.py:intersect_bvh_plain): per step a ray tests
// its node's box with the slab test of _slab_test (reciprocal direction
// 1 / (|d| > 1e-20 ? d : 1e-20), multiply by it, tnear <= tfar with
// equality, the far end clipped to the ray's best t), at a leaf tests its
// up to 4 triangles in order with Möller–Trumbore and a strict t < best t,
// then goes to node + 1 (entered an internal node) or skip[node]. A hit
// needs (geom_mask & ray_mask) != 0 and prim != exclude. This file is built
// with -fmad=false: every product and sum rounds on its own, so t, prim, u
// and v equal the plain version's bit for bit (same visiting order, same
// arithmetic). box_field is full of axis-aligned faces whose leaf boxes have
// zero thickness; a slab test rounded differently would drop their hits.
// A miss is t = 1e16, prim = -1, u = v = 0. K6 stops at the first hit.
// Dead lanes (tmax <= tmin) never walk.
//
// Bound on the H100: f32 operations (24 a slab test, 46 a triangle test)
// over the nodes and triangles each ray must visit; the tree and triangles
// are read once in the byte count but many times through L2 in fact.
// Design: one ray per thread, the ray and its best hit in registers; a node
// is one 32-byte row (bb_min, bb_max, skip, start << 3 | count) read as two
// 16-byte loads through the read-only cache. No stack, no shared memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kMiss = 1e16f;

template <bool kAny>
__global__ void __launch_bounds__(kThreads) bvh_kernel(StrelkaRays rays, const int4* __restrict__ nodes,
                                                       int n_nodes, StrelkaTris tris, int ray_mask, long long n,
                                                       float* __restrict__ t_out, int* __restrict__ prim_out,
                                                       float* __restrict__ u_out, float* __restrict__ v_out,
                                                       unsigned char* __restrict__ occ_out) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float tn = rays.tmin[i];
    float best_t = rays.tmax[i];
    float best_u = 0.f, best_v = 0.f;
    int best_p = -1;
    if (best_t > tn) {
        const float o0 = rays.ox[i], o1 = rays.oy[i], o2 = rays.oz[i];
        const float d0 = rays.dx[i], d1 = rays.dy[i], d2 = rays.dz[i];
        const int ex = rays.exclude ? rays.exclude[i] : -1;
        const float inv0 = 1.0f / (fabsf(d0) > 1e-20f ? d0 : 1e-20f);
        const float inv1 = 1.0f / (fabsf(d1) > 1e-20f ? d1 : 1e-20f);
        const float inv2 = 1.0f / (fabsf(d2) > 1e-20f ? d2 : 1e-20f);
        const int last_tri = tris.count - 1;
        int node = 0;
        while (node < n_nodes) {
            const int4 a = __ldg(nodes + 2 * static_cast<long long>(node));
            const int4 b = __ldg(nodes + 2 * static_cast<long long>(node) + 1);
            // slab test: (bound - o) * inv_d per axis
            const float x0 = (__int_as_float(a.x) - o0) * inv0, x1 = (__int_as_float(a.w) - o0) * inv0;
            const float y0 = (__int_as_float(a.y) - o1) * inv1, y1 = (__int_as_float(b.x) - o1) * inv1;
            const float z0 = (__int_as_float(a.z) - o2) * inv2, z1 = (__int_as_float(b.y) - o2) * inv2;
            const float tnear = fmaxf(fmaxf(fmaxf(fminf(x0, x1), fminf(y0, y1)), fminf(z0, z1)), tn);
            const float tfar = fminf(fminf(fminf(fmaxf(x0, x1), fmaxf(y0, y1)), fmaxf(z0, z1)), best_t);
            const int skip = b.z;
            if (!(tnear <= tfar)) {
                node = skip;
                continue;
            }
            const int cnt = b.w & 7;
            if (cnt == 0) {
                node = node + 1;
                continue;
            }
            const int start = b.w >> 3;
            for (int k = 0; k < cnt; ++k) {
                const int prim = min(start + k, last_tri);
                if ((__ldg(tris.mask + prim) & ray_mask) == 0 || prim == ex) continue;
                const float* pv = tris.v0 + 3 * static_cast<long long>(prim);
                const float* p1 = tris.e1 + 3 * static_cast<long long>(prim);
                const float* p2 = tris.e2 + 3 * static_cast<long long>(prim);
                float t, u, v;
                if (strelka_ray_tri(__ldg(pv), __ldg(pv + 1), __ldg(pv + 2), __ldg(p1), __ldg(p1 + 1),
                                    __ldg(p1 + 2), __ldg(p2), __ldg(p2 + 1), __ldg(p2 + 2), o0, o1, o2, d0, d1, d2,
                                    tn, best_t, t, u, v)) {
                    best_t = t;
                    best_p = prim;
                    best_u = u;
                    best_v = v;
                    if (kAny) break;
                }
            }
            node = (kAny && best_p >= 0) ? n_nodes : skip;
        }
    }
    if (kAny) {
        occ_out[i] = best_p >= 0 ? 1 : 0;
    } else {
        t_out[i] = best_p >= 0 ? best_t : kMiss;
        prim_out[i] = best_p;
        u_out[i] = best_u;
        v_out[i] = best_v;
    }
}

}  // namespace

// Rays: 8 f32 [n] component arrays + exclude int32 [n] (or null).
// nodes: [n_nodes, 8] int32 packed rows (ops/bvh.py:pack_nodes), 16-byte aligned.
// Triangles in leaf order: v0/e1/e2 f32 [ntri, 3], geometry mask int32 [ntri].
// Outputs: t f32, prim int32 (leaf-order id), u f32, v f32, each [n].
extern "C" int strelka_bvh_closest(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                                   const void* dz, const void* tmin, const void* tmax, const void* exclude,
                                   const void* nodes, int n_nodes, const void* v0, const void* e1,
                                   const void* e2, const void* mask, int ray_mask, long long n, int ntri,
                                   void* t_out, void* prim_out, void* u_out, void* v_out, void* stream) {
    if (n_nodes < 1 || ntri < 1) return static_cast<int>(cudaErrorInvalidValue);
    bvh_kernel<false><<<strelka_blocks(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, tmax, exclude), static_cast<const int4*>(nodes), n_nodes,
        strelka_make_tris(v0, e1, e2, mask, ntri), ray_mask, n, static_cast<float*>(t_out),
        static_cast<int*>(prim_out), static_cast<float*>(u_out), static_cast<float*>(v_out), nullptr);
    STRELKA_RETURN_LAUNCH_STATUS();
}

// Same rays, tree and triangles; output occlusion as uint8 (torch.bool) [n].
extern "C" int strelka_bvh_any(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                               const void* dz, const void* tmin, const void* tmax, const void* exclude,
                               const void* nodes, int n_nodes, const void* v0, const void* e1, const void* e2,
                               const void* mask, int ray_mask, long long n, int ntri, void* occ_out,
                               void* stream) {
    if (n_nodes < 1 || ntri < 1) return static_cast<int>(cudaErrorInvalidValue);
    bvh_kernel<true><<<strelka_blocks(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, tmax, exclude), static_cast<const int4*>(nodes), n_nodes,
        strelka_make_tris(v0, e1, e2, mask, ntri), ray_mask, n, nullptr, nullptr, nullptr, nullptr,
        static_cast<unsigned char*>(occ_out));
    STRELKA_RETURN_LAUNCH_STATUS();
}
