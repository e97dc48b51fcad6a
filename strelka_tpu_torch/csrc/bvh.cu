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
// K6, any hit: the reference's walk, strelka_tpu/ops/bvh.py:intersect_bvh
// (plain version: ops/bvh.py:intersect_bvh_plain with margin=True), the
// stackless skip-link walk in DFS order over the packed 32-byte rows of
// pack_nodes (bb_min, bb_max, skip, start << 3 | count) read as two 16-byte
// loads: per step the ray tests its node's box with the port's box test
// (common.cuh:strelka_slab_safe, the box's scale from the row's six bounds,
// the far end the ray's tmax; entered where the lowered tnear is finite and
// the box is not inverted, as ops/slab.py:slab_tnear decides), tests a
// leaf's up to 4 triangles in order and stops at the first hit, and goes to
// node + 1 (entered an internal node) or skip[node]. The reference's exact
// slab test drops a hit that Möller–Trumbore's rounding puts just outside
// its leaf's box (a grazing ray at the shared edges of a coplanar grid);
// the margin keeps every hit the walk's triangle test accepts at a
// normalised determinant of ops/slab.py:NU_MIN or more. Any hit needs no
// order, so the walk stays the reference's.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 64;  // ops/bvh.py:STACK
constexpr float kMiss = 1e16f;
constexpr int kCountBits = 3;
constexpr int kCountMask = (1 << kCountBits) - 1;

// K6: the stackless DFS walk, stopping at the first hit.
__global__ void __launch_bounds__(kThreads) bvh_any_kernel(StrelkaRays rays, const int4* __restrict__ nodes,
                                                           int n_nodes, StrelkaTris tris, int ray_mask, long long n,
                                                           unsigned char* __restrict__ occ_out) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const float tn = rays.tmin[i];
    const float tx = rays.tmax[i];
    int best_p = -1;
    if (tx > tn) {
        const float o0 = rays.ox[i], o1 = rays.oy[i], o2 = rays.oz[i];
        const float d0 = rays.dx[i], d1 = rays.dy[i], d2 = rays.dz[i];
        const int ex = rays.exclude ? rays.exclude[i] : -1;
        const float inv0 = 1.0f / (fabsf(d0) > 1e-20f ? d0 : 1e-20f);
        const float inv1 = 1.0f / (fabsf(d1) > 1e-20f ? d1 : 1e-20f);
        const float inv2 = 1.0f / (fabsf(d2) > 1e-20f ? d2 : 1e-20f);
        const float om = fmaxf(fmaxf(fabsf(o0), fabsf(o1)), fabsf(o2));
        const int last_tri = tris.count - 1;
        int node = 0;
        while (node < n_nodes) {
            const int4 a = __ldg(nodes + 2 * static_cast<long long>(node));
            const int4 b = __ldg(nodes + 2 * static_cast<long long>(node) + 1);
            const float lx = __int_as_float(a.x), ly = __int_as_float(a.y), lz = __int_as_float(a.z);
            const float hx = __int_as_float(a.w), hy = __int_as_float(b.x), hz = __int_as_float(b.y);
            const float tnear = strelka_slab_safe(lx, ly, lz, hx, hy, hz, strelka_box_scale(lx, ly, lz, hx, hy, hz), o0,
                                                  o1, o2, inv0, inv1, inv2, om, tn, tx);
            const int skip = b.z;
            if (tnear == INFINITY || !(lx <= hx)) {
                node = skip;
                continue;
            }
            const int cnt = b.w & kCountMask;
            if (cnt == 0) {
                node = node + 1;
                continue;
            }
            const int start = b.w >> kCountBits;
            for (int k = 0; k < cnt; ++k) {
                const int prim = min(start + k, last_tri);
                if ((__ldg(tris.mask + prim) & ray_mask) == 0 || prim == ex) continue;
                const float* pv = tris.v0 + 3 * static_cast<long long>(prim);
                const float* p1 = tris.e1 + 3 * static_cast<long long>(prim);
                const float* p2 = tris.e2 + 3 * static_cast<long long>(prim);
                float t, u, v;
                if (strelka_ray_tri(__ldg(pv), __ldg(pv + 1), __ldg(pv + 2), __ldg(p1), __ldg(p1 + 1),
                                    __ldg(p1 + 2), __ldg(p2), __ldg(p2 + 1), __ldg(p2 + 2), o0, o1, o2, d0, d1, d2,
                                    tn, tx, t, u, v)) {
                    best_p = prim;
                    break;
                }
            }
            node = best_p >= 0 ? n_nodes : skip;
        }
    }
    occ_out[i] = best_p >= 0 ? 1 : 0;
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

// Rays as above; nodes: [n_nodes, 8] int32 packed rows (ops/bvh.py:pack_nodes),
// 16-byte aligned; the same triangles. Output: occlusion as uint8
// (torch.bool) [n].
extern "C" int strelka_bvh_any(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                               const void* dz, const void* tmin, const void* tmax, const void* exclude,
                               const void* nodes, int n_nodes, const void* v0, const void* e1, const void* e2,
                               const void* mask, int ray_mask, long long n, int ntri, void* occ_out,
                               void* stream) {
    if (n_nodes < 1 || ntri < 1) return static_cast<int>(cudaErrorInvalidValue);
    bvh_any_kernel<<<strelka_blocks(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, tmax, exclude), static_cast<const int4*>(nodes), n_nodes,
        strelka_make_tris(v0, e1, e2, mask, ntri), ray_mask, n, static_cast<unsigned char*>(occ_out));
    STRELKA_RETURN_LAUNCH_STATUS();
}
