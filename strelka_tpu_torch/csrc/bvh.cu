// Kernels K5 (closest hit) and K6 (any hit) over a BVH.
//
// Replace the large-scene intersection kernels of
// strelka_tpu/ops/pallas_intersect.py: the superblock sweeps
// (pallas_intersect_closest / _any and their _mxu forms), phase 1 of the
// residual two-pass (the four _fusedk kernels), pallas_open_w and the four
// work-list kernels (_wl, _wl_mxu). On the TPU those are dense sweeps of
// ray tiles against 8x256-triangle superblocks, culled by AABBs and ordered
// by tables, because the TPU has no per-lane gather. All of them compute one
// function: the closest (t, prim), or occlusion, of each ray against a large
// triangle set. On the card a per-thread pointer chase is cheap.
//
// Contract of both: a hit needs (geom_mask & ray_mask) != 0, prim !=
// exclude and Möller–Trumbore's tmin < t < tmax (common.cuh:
// strelka_ray_tri). This file is built with -fmad=false: every product and
// sum rounds on its own, so t, u and v are the plain versions' bit for bit.
// A miss is t = 1e16, prim = -1, u = v = 0. Dead lanes (tmax <= tmin) never
// walk. prim is a leaf-order id.
//
// K5, closest hit: the dense sweep's (t, prim) on every lane, the least t
// and of equal t the lowest id (the North Star's brute force). Its walk
// (plain version: strelka_tpu_torch/ops/bvh.py:intersect_bvh_ordered_plain,
// the same order, test and counters) goes near to far over the child
// table of ops/bvh.py:child_rows: one 64-byte row an internal node, both
// children's boxes, references and box scales, read as four 16-byte loads.
// At an internal node the ray tests both child boxes with the port's box
// test (common.cuh:strelka_slab_safe) against [tmin, best t], goes to the
// nearer entered child (of equal tnear the left one, which holds the lower
// leaf ids) and pushes the farther one with its tnear on a per-thread stack
// of kStack entries (the wrapper refuses a deeper tree). At a leaf it tests
// the triangles and takes a hit on t < best t, or on equal t and a lower
// prim id, so the visiting order does not change the result. A pop drops an
// entry whose tnear is greater than best t (strict); an empty stack ends
// the walk. The box test's margin keeps every hit Möller–Trumbore accepts
// inside its leaf's and every ancestor's padded box at a tnear no greater
// than its t, so no box that holds the dense winner is culled or dropped.
// Bound on the H100: the bytes of the node rows and triangles these rays
// need, read once (they are read many times through L2 in fact); the walk
// is a chain of dependent loads a ray. Design: one ray per thread, the ray
// and its best hit in registers, the stack in local memory (L1).
//
// K6, any hit: occlusion on every lane, as the dense any-hit sweep finds it
// inside the box test's domain. Its walk (plain version:
// ops/bvh.py:intersect_bvh_ordered_plain with any_hit=True, the same
// order, test and counters) is K5's over the same child table: both child
// boxes tested against [tmin, tmax], the nearer entered child taken (of
// equal tnear the left), the farther pushed on a per-thread stack of kStack
// entries (the wrapper refuses a deeper tree); a leaf's triangles are
// tested in order and the first hit Möller–Trumbore accepts ends the walk,
// as does an empty stack. Best t stays tmax until that hit, so a pop never
// drops an entry and the stack holds references only. The order may change
// which occluder is found first, not whether there is one. Bound on the
// H100: the bytes of the node rows and triangles the reference's DFS walk
// with the margin (ops/bvh.py:intersect_bvh_plain, K6's former walk)
// needs, read once; the walk is a chain of dependent loads a ray. Design:
// one ray a thread; one row fetch (four 16-byte loads) decides two
// children, so a ray makes about half the dependent fetches of the DFS
// walk over 32-byte rows, and reads the boxes' scales instead of computing
// them; the triangles as 48-byte rows (kernels/bvh.py:tri_rows: v0, e1, e2 as
// three 16-byte loads, the geometry mask's bits in a spare word), which in
// one A/B call beat the four arrays of v0, e1, e2 and mask (PERF.md
// section 6).

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 64;  // ops/bvh.py:STACK
constexpr float kMiss = 1e16f;
constexpr int kCountBits = 3;
constexpr int kCountMask = (1 << kCountBits) - 1;

// One triangle of the 48-byte row table: v0, e1, e2 as three 16-byte
// loads, the geometry mask's bits in the third row's second word. Returns 0
// where the mask does not match the ray's, 1 for a miss, 2 for a hit.
__device__ __forceinline__ int strelka_ray_tri_row(const float4* __restrict__ rows, int prim, int ray_mask,
                                                   float o0, float o1, float o2, float d0, float d1, float d2,
                                                   float tn, float tx) {
    const float4* r = rows + 3 * static_cast<long long>(prim);
    const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
    if ((__float_as_int(c.y) & ray_mask) == 0) return 0;
    float t, u, v;
    return strelka_ray_tri(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, o0, o1, o2, d0, d1, d2, tn, tx, t, u, v) ? 2
                                                                                                                : 1;
}

// K6: the near-to-far walk over the child table, stopping at the first
// hit. nodes_out / tris_out (kStats): child boxes and triangles tested per
// ray.
template <bool kStats>
__global__ void __launch_bounds__(kThreads) bvh_any_kernel(StrelkaRays rays, const int4* __restrict__ rows,
                                                           const float4* __restrict__ tri_rows, int ntri,
                                                           int ray_mask, long long n,
                                                           unsigned char* __restrict__ occ_out,
                                                           int* __restrict__ nodes_out, int* __restrict__ tris_out) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float tn = rays.tmin[i];
    const float tx = rays.tmax[i];
    bool occluded = false;
    int n_nodes = 0, n_tris = 0;
    if (tx > tn) {
        const float o0 = rays.ox[i], o1 = rays.oy[i], o2 = rays.oz[i];
        const float d0 = rays.dx[i], d1 = rays.dy[i], d2 = rays.dz[i];
        const int ex = rays.exclude ? rays.exclude[i] : -1;
        const float inv0 = 1.0f / (fabsf(d0) > 1e-20f ? d0 : 1e-20f);
        const float inv1 = 1.0f / (fabsf(d1) > 1e-20f ? d1 : 1e-20f);
        const float inv2 = 1.0f / (fabsf(d2) > 1e-20f ? d2 : 1e-20f);
        const float om = fmaxf(fmaxf(fabsf(o0), fabsf(o1)), fabsf(o2));
        const int last_tri = ntri - 1;
        int stack[kStack];
        int sp = 0;
        int node = 0;  // a reference: row << 3 (internal) or start << 3 | count (leaf)
        while (true) {
            if ((node & kCountMask) == 0) {
                const int4* r = rows + 4 * static_cast<long long>(node >> kCountBits);
                const int4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2), e = __ldg(r + 3);
                // the row's layout as K5 reads it; both boxes against [tmin, tmax]
                float tl = strelka_slab_safe(__int_as_float(a.x), __int_as_float(a.y), __int_as_float(a.z),
                                             __int_as_float(a.w), __int_as_float(b.x), __int_as_float(b.y),
                                             __int_as_float(e.z), o0, o1, o2, inv0, inv1, inv2, om, tn, tx);
                float tr = strelka_slab_safe(__int_as_float(b.z), __int_as_float(b.w), __int_as_float(c.x),
                                             __int_as_float(c.y), __int_as_float(c.z), __int_as_float(c.w),
                                             __int_as_float(e.w), o0, o1, o2, inv0, inv1, inv2, om, tn, tx);
                if (!(__int_as_float(a.x) <= __int_as_float(a.w))) tl = INFINITY;  // an inverted box
                if (!(__int_as_float(b.z) <= __int_as_float(c.y))) tr = INFINITY;
                if (kStats) n_nodes += 2;
                const bool in_l = tl != INFINITY, in_r = tr != INFINITY;
                if (in_l && in_r) {
                    const bool left = tl <= tr;
                    stack[sp++] = left ? e.y : e.x;
                    node = left ? e.x : e.y;
                    continue;
                }
                if (in_l || in_r) {
                    node = in_l ? e.x : e.y;
                    continue;
                }
            } else {
                const int start = node >> kCountBits, cnt = node & kCountMask;
                for (int k = 0; k < cnt; ++k) {
                    const int prim = min(start + k, last_tri);
                    if (prim == ex) continue;
                    const int res = strelka_ray_tri_row(tri_rows, prim, ray_mask, o0, o1, o2, d0, d1, d2, tn, tx);
                    if (res == 0) continue;  // the geometry mask does not match the ray's
                    if (kStats) ++n_tris;
                    occluded = res == 2;
                    if (occluded) break;
                }
                if (occluded) break;
            }
            if (sp == 0) break;  // an empty stack ends the walk
            node = stack[--sp];
        }
    }
    occ_out[i] = occluded ? 1 : 0;
    if (kStats) {
        nodes_out[i] = n_nodes;
        tris_out[i] = n_tris;
    }
}

// K5: the near-to-far walk over the child table. nodes_out / tris_out
// (kStats): child boxes tested and triangles tested per ray.
template <bool kStats>
__global__ void __launch_bounds__(kThreads) bvh_closest_kernel(StrelkaRays rays, const int4* __restrict__ rows,
                                                               StrelkaTris tris, int ray_mask, long long n,
                                                               float* __restrict__ t_out, int* __restrict__ prim_out,
                                                               float* __restrict__ u_out, float* __restrict__ v_out,
                                                               int* __restrict__ nodes_out,
                                                               int* __restrict__ tris_out) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float tn = rays.tmin[i];
    const float tx = rays.tmax[i];
    float best_t = tx, best_u = 0.0f, best_v = 0.0f;
    int best_p = -1, n_nodes = 0, n_tris = 0;
    if (tx > tn) {
        const float o0 = rays.ox[i], o1 = rays.oy[i], o2 = rays.oz[i];
        const float d0 = rays.dx[i], d1 = rays.dy[i], d2 = rays.dz[i];
        const int ex = rays.exclude ? rays.exclude[i] : -1;
        const float inv0 = 1.0f / (fabsf(d0) > 1e-20f ? d0 : 1e-20f);
        const float inv1 = 1.0f / (fabsf(d1) > 1e-20f ? d1 : 1e-20f);
        const float inv2 = 1.0f / (fabsf(d2) > 1e-20f ? d2 : 1e-20f);
        const float om = fmaxf(fmaxf(fabsf(o0), fabsf(o1)), fabsf(o2));
        const int last_tri = tris.count - 1;
        int stack_ref[kStack];
        float stack_t[kStack];
        int sp = 0;
        int node = 0;  // a reference: row << 3 (internal) or start << 3 | count (leaf)
        while (true) {
            if ((node & kCountMask) == 0) {
                const int4* r = rows + 4 * static_cast<long long>(node >> kCountBits);
                const int4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2), e = __ldg(r + 3);
                // a: left lo xyz, left hi x; b: left hi yz, right lo xy; c: right lo z, right hi xyz;
                // e: left ref, right ref, left scale, right scale
                const float llx = __int_as_float(a.x), lly = __int_as_float(a.y), llz = __int_as_float(a.z);
                const float lhx = __int_as_float(a.w), lhy = __int_as_float(b.x), lhz = __int_as_float(b.y);
                const float rlx = __int_as_float(b.z), rly = __int_as_float(b.w), rlz = __int_as_float(c.x);
                const float rhx = __int_as_float(c.y), rhy = __int_as_float(c.z), rhz = __int_as_float(c.w);
                float tl = strelka_slab_safe(llx, lly, llz, lhx, lhy, lhz, __int_as_float(e.z), o0, o1, o2, inv0, inv1,
                                             inv2, om, tn, best_t);
                float tr = strelka_slab_safe(rlx, rly, rlz, rhx, rhy, rhz, __int_as_float(e.w), o0, o1, o2, inv0, inv1,
                                             inv2, om, tn, best_t);
                if (!(llx <= lhx)) tl = INFINITY;  // an inverted box: the empty side of a one-leaf tree
                if (!(rlx <= rhx)) tr = INFINITY;
                if (kStats) n_nodes += 2;
                const bool in_l = tl != INFINITY, in_r = tr != INFINITY;
                if (in_l && in_r) {
                    const bool left = tl <= tr;
                    stack_ref[sp] = left ? e.y : e.x;
                    stack_t[sp] = left ? tr : tl;
                    ++sp;
                    node = left ? e.x : e.y;
                    continue;
                }
                if (in_l || in_r) {
                    node = in_l ? e.x : e.y;
                    continue;
                }
            } else {
                const int start = node >> kCountBits, cnt = node & kCountMask;
                for (int k = 0; k < cnt; ++k) {
                    const int prim = min(start + k, last_tri);
                    if ((__ldg(tris.mask + prim) & ray_mask) == 0 || prim == ex) continue;
                    if (kStats) ++n_tris;
                    const float* pv = tris.v0 + 3 * static_cast<long long>(prim);
                    const float* p1 = tris.e1 + 3 * static_cast<long long>(prim);
                    const float* p2 = tris.e2 + 3 * static_cast<long long>(prim);
                    float t, u, v;
                    // against tmax, not best t: a hit of equal t and a lower id replaces the best one
                    if (strelka_ray_tri(__ldg(pv), __ldg(pv + 1), __ldg(pv + 2), __ldg(p1), __ldg(p1 + 1),
                                        __ldg(p1 + 2), __ldg(p2), __ldg(p2 + 1), __ldg(p2 + 2), o0, o1, o2, d0, d1,
                                        d2, tn, tx, t, u, v) &&
                        (t < best_t || (t == best_t && prim < best_p))) {
                        best_t = t;
                        best_p = prim;
                        best_u = u;
                        best_v = v;
                    }
                }
            }
            // pop the next entry whose tnear is not beyond best t; an empty stack ends the walk
            bool popped = false;
            while (sp > 0) {
                --sp;
                if (!(stack_t[sp] > best_t)) {
                    node = stack_ref[sp];
                    popped = true;
                    break;
                }
            }
            if (!popped) break;
        }
    }
    t_out[i] = best_p >= 0 ? best_t : kMiss;
    prim_out[i] = best_p;
    u_out[i] = best_u;
    v_out[i] = best_v;
    if (kStats) {
        nodes_out[i] = n_nodes;
        tris_out[i] = n_tris;
    }
}

}  // namespace

// Rays: 8 f32 [n] component arrays + exclude int32 [n] (or null).
// rows: [n_rows, 16] int32 child table (ops/bvh.py:child_rows), 16-byte
// aligned; depth: the tree's depth, at most kStack (else nothing launches).
// Triangles in leaf order: v0/e1/e2 f32 [ntri, 3], geometry mask int32 [ntri].
// Outputs: t f32, prim int32 (leaf-order id), u f32, v f32, each [n]; nodes
// and tris int32 [n] (child boxes and triangles tested per ray), or both null.
extern "C" int strelka_bvh_closest(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                                   const void* dz, const void* tmin, const void* tmax, const void* exclude,
                                   const void* rows, int n_rows, int depth, const void* v0, const void* e1,
                                   const void* e2, const void* mask, int ray_mask, long long n, int ntri,
                                   void* t_out, void* prim_out, void* u_out, void* v_out, void* nodes_out,
                                   void* tris_out, void* stream) {
    if (n_rows < 1 || ntri < 1 || depth > kStack) return static_cast<int>(cudaErrorInvalidValue);
    const StrelkaRays r = strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, tmax, exclude);
    const StrelkaTris t = strelka_make_tris(v0, e1, e2, mask, ntri);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned int blocks = strelka_blocks(n, kThreads);
    if (nodes_out)
        bvh_closest_kernel<true><<<blocks, kThreads, 0, st>>>(
            r, static_cast<const int4*>(rows), t, ray_mask, n, static_cast<float*>(t_out), static_cast<int*>(prim_out),
            static_cast<float*>(u_out), static_cast<float*>(v_out), static_cast<int*>(nodes_out),
            static_cast<int*>(tris_out));
    else
        bvh_closest_kernel<false><<<blocks, kThreads, 0, st>>>(
            r, static_cast<const int4*>(rows), t, ray_mask, n, static_cast<float*>(t_out), static_cast<int*>(prim_out),
            static_cast<float*>(u_out), static_cast<float*>(v_out), nullptr, nullptr);
    STRELKA_RETURN_LAUNCH_STATUS();
}

// Rays as above; rows: the child table as for K5, depth at most kStack;
// tri_rows: [ntri, 12] f32, the triangles in leaf order as 48-byte rows
// (kernels/bvh.py:tri_rows: v0, e1, e2, the mask's bits, 0, 0), 16-byte
// aligned. Output: occlusion as uint8 (torch.bool) [n]; nodes and tris
// int32 [n] (child boxes and triangles tested per ray), or both null.
extern "C" int strelka_bvh_any(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                               const void* dz, const void* tmin, const void* tmax, const void* exclude,
                               const void* rows, int n_rows, int depth, const void* tri_rows, int ray_mask,
                               long long n, int ntri, void* occ_out, void* nodes_out, void* tris_out, void* stream) {
    if (n_rows < 1 || ntri < 1 || depth > kStack) return static_cast<int>(cudaErrorInvalidValue);
    const StrelkaRays r = strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, tmax, exclude);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned int blocks = strelka_blocks(n, kThreads);
    const int4* table = static_cast<const int4*>(rows);
    const float4* tr = static_cast<const float4*>(tri_rows);
    unsigned char* occ = static_cast<unsigned char*>(occ_out);
    if (nodes_out)
        bvh_any_kernel<true><<<blocks, kThreads, 0, st>>>(r, table, tr, ntri, ray_mask, n, occ,
                                                           static_cast<int*>(nodes_out), static_cast<int*>(tris_out));
    else
        bvh_any_kernel<false><<<blocks, kThreads, 0, st>>>(r, table, tr, ntri, ray_mask, n, occ, nullptr, nullptr);
    STRELKA_RETURN_LAUNCH_STATUS();
}
