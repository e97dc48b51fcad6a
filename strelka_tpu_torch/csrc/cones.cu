// Kernels K7 (closest hit) and K8 (any hit) over round cones (hair).
//
// Replace the three cone kernels of strelka_tpu/ops/curves.py:
// pallas_intersect_cones (a near-to-far sweep of ray tiles over 8x256-cone
// superblocks), pallas_intersect_cones_fusedk (phase 1 of the residual
// two-pass, with its open flag) and pallas_intersect_cones_wl (a work-list
// sweep). All three compute one function: per ray the closest (t, cone), or
// occlusion, over all round cones with ra >= 0 and tmin < t < tmax. They
// differ in TPU schedule only; fused-K phase 1 and the work lists answer a
// cost per grid step that this card does not have.
//
// Contract (the plain PyTorch version is
// strelka_tpu_torch/ops/curves.py:intersect_curves_closest_plain, the dense
// sweep of strelka_tpu/ops/curves.py:intersect_curves_closest): t is the
// least of the cone body's root and the two cap spheres' roots, rounded as
// the JAX package's CPU render rounds _ray_round_cone. XLA's CPU backend
// compiles that sweep's loops with LLVM, which contracts a product with one
// use into an FMA with the sum or difference it feeds (fadd(x*y, z) ->
// fma(x, y, z), the first operand first; fsub(x*y, z) -> fma(x, y, -z);
// fsub(x, y*z) -> fma(-y, z, x)) and folds `x - y > 0` into `x > y`. So
// each three-term dot product is fma(x2, y2, fma(x0, y0, x1*y1)), d2, k2,
// k1, k0, h and y are the chains of __fmaf_rn in ray_cone, the body is
// accepted on k1*k1 > k2*k0 (two rounded products), 0 < y < d2, and a cap
// on bq*bq > cq in K7 and on the contracted hq > 0 in K8 (XLA's any-hit
// loop also takes the cap's root and keeps the difference). This file is
// built with -fmad=false, so every other product and sum rounds on its
// own; the plain twin rounds each fma once (ops/vec.py:fma). K7 returns
// the least t, its cone index and the axial position y in [0, 1] on that
// cone (0 or 1 on a cap, by float equality of t with the cap's root), so
// that u = fma(u1 - u0, y, u0) is the CPU reference's. Of equal t the
// lowest cone index wins. A miss is t = 1e16, cone = -1, y = 0. A lane with
// tmax <= tmin reads nothing else and misses. K8 stops at the first hit.
//
// Cull: the cones are Morton-sorted and stored cone-major (a.xyz, ra,
// b.xyz, rb; padding has ra = -1), and a tree of boxes is built over them in
// that order (ops/curves.py:cone_tree; the cones are not moved): a leaf is
// kLeaf consecutive cones, an inner node kWide consecutive children, the top
// level at most kWide boxes, the depth as the number of cones asks. A ray
// tests boxes with common.cuh:strelka_slab_safe (the slab test of
// pallas_intersect.py:_tile_hits_block per ray with the port's margin, which
// keeps a hit the closed form puts just outside its box; inverted boxes
// rejected, the far end clipped to the ray's best t for K7) and tests the
// cones of the leaves it reaches. cull = 0 sweeps every cone: the brute
// force the tree walk is held against.
//
// The walk (the order in which a ray meets the boxes; the result is the
// same whatever the order, since a cone replaces the best hit on t < best or
// on t == best with a lower index): the lanes slab-test the top level's
// boxes at once and push the entered ones as (tnear, box) on the warp's
// stack in shared memory, K7 the nearest on top (of equal tnear the lower
// box), K8 the lowest box on top (ranking them cost K8 7% and saved it
// nothing: an any-hit walk ends at its first hit, wherever it lies). The
// warp pops the top entry. K7 drops it when its tnear is greater than best
// t: such a box holds no cone with t <= best t, and the slab test against
// the final interval would reject it too. The test is strict, since a box
// with tnear equal to best t can still hold a cone of equal t and a lower
// index. An inner box has its kWide children slab-tested, a lane each,
// against [tmin, min(best t, tmax)] (K8: [tmin, tmax]) and the entered ones
// pushed the same way. A leaf has its kLeaf cones, a lane each, slab-tested
// by their own boxes (lo = min(a - ra, b - rb), hi = max(a + ra, b + rb),
// computed from the rows) against the same interval; only where one or
// more is entered does the warp run the closed form, and it takes the hits
// of the cones whose box is entered (most leaves a ray sweeps hold no cone
// it comes near: on hair_long's bounce-1 rays, 2.8 cones a ray have a box
// that the final interval enters, in 11 leaves swept). An empty stack ends the walk; K8 also
// ends it after the leaf with its first hit (a ballot). The stack holds at
// most the top level's boxes and kWide - 1 more a level below it:
// kMaxLevels x kWide entries a warp. The margin of the box test keeps every
// hit in its cone's own box as in the leaf and node boxes (ROADMAP C.4,
// measured on scene/grazing.py's rays at those boxes' faces).
// ops/curves.py:cone_tree_walk counts this walk in plain PyTorch.
//
// Bound on the H100: f32 operations, 119 a ray-cone test (3 square roots,
// 1 division), over the cones whose own box a ray's final interval enters
// (benchmark/bounds.py);
// the cones are a few MB to 26 MB and stay in the 50 MB L2. Under
// -fmad=false every product and sum issues on its own but the closed form's
// 27 explicit FMAs (54 of the 119), where the 67 TFLOP/s peak counts an FMA
// as two: about 0.65 of the bound is the most this arithmetic can reach.
// Design: persistent warps, one ray a warp. The grid is as many blocks as
// fit on the card at once (the wrapper takes the count from the occupancy of
// the built kernel). A warp takes its next ray from a global counter (one
// atomicAdd; a dead ray costs it one load and a miss written) and walks it
// with all its lanes: a box or a cone a lane, each lane's own best hit kept
// inside a leaf and met (shuffles: least t, then lowest index) before the
// next pop where a lane's best changed. Every lane of a warp works on one ray, so no lane idles for a
// neighbour's longer ray; the counter balances the warps, and the rays in
// flight at a time are a few thousand neighbours whose boxes and cones share
// the caches. One ray a lane, refilled between chunks of 32 cones, left half
// the lane slots idle. The cones are stored cone-major, [M_pad, 8] = (a.xyz,
// ra, b.xyz, rb): one 32-byte sector a cone, two 16-byte loads through the
// read-only path; the boxes [8, total], a box's coordinate rows 'total'
// apart, so a node's children are coalesced loads. Outputs are written by
// ray index.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 32;
constexpr int kWarps = kThreads / kLanes;
constexpr int kLeaf = 32;      // cones a leaf, a lane each (ops/curves.py:CONE_LEAF)
constexpr int kWide = 32;      // children an inner node, a lane each (ops/curves.py:CONE_WIDE)
constexpr int kMaxLevels = 6;  // box levels (ops/curves.py:CONE_MAX_LEVELS)
constexpr int kStack = kMaxLevels * kWide;  // stack entries a warp
constexpr float kMiss = 1e16f;
constexpr float kNone = 1e30f;  // "no box": above any best t
constexpr unsigned kFull = 0xffffffffu;

struct Cones {
    const float4* aos;    // [m_pad, 2]: (a.xyz, ra), (b.xyz, rb)
    const float* boxes;   // [8, total] the tree's boxes, level by level from the top
    int m_pad;
    int total;
    int levels;
    int leaf0;  // the first leaf's box: first[levels - 1]
    int first[kMaxLevels + 1];  // level l's boxes are [first[l], first[l + 1]); first[levels] = total
};

struct Ray {
    float o0, o1, o2, d0, d1, d2, inv0, inv1, inv2, om, tn;  // om: |o|_inf, the box test's pad scale
};

// The lowered tnear of the ray's interval [tn, tfar] against box j of the
// [8, total] table (common.cuh:strelka_slab_safe), or kNone where the
// interval does not enter it or the box is inverted.
__device__ __forceinline__ float slab_tnear(const Cones& c, int j, const Ray& r, float tfar) {
    const float* p = c.boxes + j;
    const long long s = c.total;
    const float lx = __ldg(p), ly = __ldg(p + s), lz = __ldg(p + 2 * s);
    const float hx = __ldg(p + 3 * s), hy = __ldg(p + 4 * s), hz = __ldg(p + 5 * s);
    const float tnear = strelka_slab_safe(lx, ly, lz, hx, hy, hz, strelka_box_scale(lx, ly, lz, hx, hy, hz), r.o0,
                                          r.o1, r.o2, r.inv0, r.inv1, r.inv2, r.om, r.tn, tfar);
    return lx <= hx && tnear != INFINITY ? tnear : kNone;
}

// Lane k slab-tests box first + k (k < count) against [tn, tfar]; the
// entered boxes go on the warp's stack above sp: for K7 the nearest on top
// (of equal tnear the lower box), for K8 the lowest box on top (the order
// does not change what an any-hit walk tests before its first hit much,
// and the ranking costs K8 more than it saves). Returns the new stack size
// and adds the boxes tested to `boxes`.
template <bool kAny>
__device__ __forceinline__ int push_boxes(const Cones& c, int first, int count, const Ray& r, float tfar,
                                          float* s_t, int* s_n, int sp, int lane, int& boxes) {
    const float v = lane < count ? slab_tnear(c, first + lane, r, tfar) : kNone;
    boxes += count;
    const unsigned in = __ballot_sync(kFull, v != kNone);
    if (!in) return sp;
    // the rank of the lane's box among the entered ones, the first popped first
    int rank = __popc(in & ((1u << lane) - 1u));
    if (!kAny) {
        rank = 0;
        for (unsigned m = in; m; m &= m - 1) {
            const int k = __ffs(m) - 1;
            const float vk = __shfl_sync(kFull, v, k);
            rank += vk < v || (vk == v && k < lane);
        }
    }
    const int n_in = __popc(in);
    if (v != kNone) {
        s_t[sp + n_in - 1 - rank] = v;
        s_n[sp + n_in - 1 - rank] = first + lane;
    }
    __syncwarp();
    return sp + n_in;
}

// x0*y0 + x1*y1 + x2*y2 as XLA's CPU backend contracts it (see the contract above).
__device__ __forceinline__ float dot3(float x0, float x1, float x2, float y0, float y1, float y2) {
    return __fmaf_rn(x2, y2, __fmaf_rn(x0, y0, x1 * y1));
}

// One ray against one round cone: the least root in (., 1e16], and what the
// axial position needs (y, d2 and the caps' roots). kAny: the caps' test of
// the any-hit sweep (the contracted hq > 0), else the closest sweep's.
template <bool kAny>
__device__ __forceinline__ float ray_cone(float ax, float ay, float az, float bx, float by, float bz, float ra,
                                          float rb, const Ray& r, float& y, float& dd, float& t_ca_m,
                                          float& t_cb_m) {
    const float bax = bx - ax, bay = by - ay, baz = bz - az;
    const float oax = r.o0 - ax, oay = r.o1 - ay, oaz = r.o2 - az;
    const float rr = ra - rb;
    const float m0 = dot3(bax, bay, baz, bax, bay, baz);
    const float m1 = dot3(oax, oay, oaz, bax, bay, baz);
    const float m2 = dot3(r.d0, r.d1, r.d2, bax, bay, baz);
    const float m3 = dot3(r.d0, r.d1, r.d2, oax, oay, oaz);
    const float m5 = dot3(oax, oay, oaz, oax, oay, oaz);
    dd = __fmaf_rn(-rr, rr, m0);
    const float k2 = __fmaf_rn(-m2, m2, dd);
    const float k1 = __fmaf_rn(ra, rr * m2, __fmaf_rn(m3, dd, -(m1 * m2)));
    const float k0 = __fmaf_rn(-ra, ra * dd, __fmaf_rn(ra, (rr * 2.0f) * m1, __fmaf_rn(m5, dd, -(m1 * m1))));
    const float k0k2 = k2 * k0;
    const float h = __fmaf_rn(k1, k1, -k0k2);
    const float safe_k2 = fabsf(k2) > 1e-12f ? k2 : 1e-12f;
    const float t_body = (-sqrtf(fmaxf(h, 0.0f)) - k1) / safe_k2;
    y = __fmaf_rn(m2, t_body, m1);
    const bool body_ok = k1 * k1 > k0k2 && y > 0.0f && y < dd;
    // cap sphere at a (radius ra)
    const float bqa = m3;
    const float cqa = __fmaf_rn(-ra, ra, m5);
    const float hqa = __fmaf_rn(bqa, bqa, -cqa);
    const float t_ca = -bqa - sqrtf(fmaxf(hqa, 0.0f));
    const bool ok_ca = kAny ? hqa > 0.0f : bqa * bqa > cqa;
    // cap sphere at b (radius rb)
    const float obx = r.o0 - bx, oby = r.o1 - by, obz = r.o2 - bz;
    const float bqb = dot3(r.d0, r.d1, r.d2, obx, oby, obz);
    const float cqb = __fmaf_rn(-rb, rb, dot3(obx, oby, obz, obx, oby, obz));
    const float hqb = __fmaf_rn(bqb, bqb, -cqb);
    const float t_cb = -bqb - sqrtf(fmaxf(hqb, 0.0f));
    const bool ok_cb = kAny ? hqb > 0.0f : bqb * bqb > cqb;
    const float t_body_m = body_ok ? t_body : kMiss;
    t_ca_m = ok_ca ? t_ca : kMiss;
    t_cb_m = ok_cb ? t_cb : kMiss;
    return fminf(t_body_m, fminf(t_ca_m, t_cb_m));
}

// Whether the ray's interval [tn, tfar] enters the cone's own box (ops/
// curves.py:cone_boxes: lo = min(a - ra, b - rb), hi = max(a + ra, b + rb);
// padding, with ra = -1, is inverted and never entered).
__device__ __forceinline__ bool enters_cone_box(const float4& ca, const float4& cb, const Ray& r, float tfar) {
    const float lx = fminf(ca.x - ca.w, cb.x - cb.w), ly = fminf(ca.y - ca.w, cb.y - cb.w),
                lz = fminf(ca.z - ca.w, cb.z - cb.w);
    const float hx = fmaxf(ca.x + ca.w, cb.x + cb.w), hy = fmaxf(ca.y + ca.w, cb.y + cb.w),
                hz = fmaxf(ca.z + ca.w, cb.z + cb.w);
    const float tnear = strelka_slab_safe(lx, ly, lz, hx, hy, hz, strelka_box_scale(lx, ly, lz, hx, hy, hz), r.o0,
                                          r.o1, r.o2, r.inv0, r.inv1, r.inv2, r.om, r.tn, tfar);
    return lx <= hx && tnear != INFINITY;
}

// The lane's cone `cone` (rows ca, cb) against the ray where `enter`; a hit
// in (tn, tx) replaces the lane's best on t < best or on t == best with a
// lower index. Returns whether the best changed.
template <bool kAny>
__device__ __forceinline__ bool test_cone(const float4& ca, const float4& cb, int cone, bool enter, const Ray& r,
                                          float tx, float& best_t, int& best_c, float& best_y) {
    float y, dd, t_ca_m, t_cb_m;
    const float t = ray_cone<kAny>(ca.x, ca.y, ca.z, cb.x, cb.y, cb.z, ca.w, cb.w, r, y, dd, t_ca_m, t_cb_m);
    if (enter && t < kMiss && t > r.tn && t < tx && (t < best_t || (t == best_t && cone < best_c))) {
        best_t = t;
        best_c = cone;
        if (!kAny) {
            const float y_norm = fminf(fmaxf(y / fmaxf(dd, 1e-12f), 0.0f), 1.0f);
            best_y = t == t_ca_m ? 0.0f : (t == t_cb_m ? 1.0f : y_norm);
        }
        return true;
    }
    return false;
}

// The lane's cone rows (a.xyz, ra), (b.xyz, rb).
__device__ __forceinline__ void load_cone(const Cones& c, int cone, float4& ca, float4& cb) {
    const float4* __restrict__ q = c.aos + 2 * static_cast<long long>(cone);
    ca = __ldg(q);
    cb = __ldg(q + 1);
}

// The warp's best: the least t, of equal t the lowest cone, in every lane.
__device__ __forceinline__ void warp_best(float& best_t, int& best_c, float& best_y) {
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
        const float ot = __shfl_xor_sync(kFull, best_t, o);
        const int oc = __shfl_xor_sync(kFull, best_c, o);
        const float oy = __shfl_xor_sync(kFull, best_y, o);
        if (ot < best_t || (ot == best_t && oc < best_c)) {
            best_t = ot;
            best_c = oc;
            best_y = oy;
        }
    }
}

// stats: [3, n] per ray (inner boxes slab-tested, leaves swept, cones whose
// own box the interval entered, which the closed form then tested; with
// cull = 0 a leaf is a step of kLeaf cones and every live cone is tested)
// or null; slots: [2] launch-wide (lane slots of the closed form's steps,
// kLeaf a step, and those that tested a cone) or null.
template <bool kAny>
__global__ void __launch_bounds__(kThreads) cone_kernel(StrelkaRays rays, Cones cones, int cull, long long n,
                                                        int* __restrict__ next_ray, float* __restrict__ t_out,
                                                        int* __restrict__ cone_out, float* __restrict__ y_out,
                                                        unsigned char* __restrict__ occ_out, int* __restrict__ stats,
                                                        unsigned long long* __restrict__ slots) {
    __shared__ float s_tn[kWarps][kStack];
    __shared__ int s_box[kWarps][kStack];
    const int lane = threadIdx.x & (kLanes - 1);
    float* s_t = s_tn[threadIdx.x / kLanes];
    int* s_n = s_box[threadIdx.x / kLanes];
    unsigned issued = 0, tested = 0;
    while (true) {
        // the next ray, one atomicAdd a warp: the rays in flight on the card
        // at a time are a few thousand neighbours, whose boxes and cones share the caches
        int next = 0;
        if (lane == 0) next = atomicAdd(next_ray, 1);
        next = __shfl_sync(kFull, next, 0);
        if (next >= n) break;
        const long long i = next;
        if (!(rays.tmax[i] > rays.tmin[i])) {  // a dead lane reads nothing else and misses
            if (lane == 0) {
                if (kAny) {
                    occ_out[i] = 0;
                } else {
                    t_out[i] = kMiss;
                    cone_out[i] = -1;
                    y_out[i] = 0.0f;
                }
                if (stats) {
                    stats[i] = 0;
                    stats[n + i] = 0;
                    stats[2 * n + i] = 0;
                }
            }
            continue;
        }
        Ray r;
        r.tn = rays.tmin[i];
        const float tx = rays.tmax[i];
        r.o0 = rays.ox[i]; r.o1 = rays.oy[i]; r.o2 = rays.oz[i];
        r.d0 = rays.dx[i]; r.d1 = rays.dy[i]; r.d2 = rays.dz[i];
        r.inv0 = 1.0f / (fabsf(r.d0) > 1e-20f ? r.d0 : 1e-20f);
        r.inv1 = 1.0f / (fabsf(r.d1) > 1e-20f ? r.d1 : 1e-20f);
        r.inv2 = 1.0f / (fabsf(r.d2) > 1e-20f ? r.d2 : 1e-20f);
        r.om = fmaxf(fmaxf(fabsf(r.o0), fabsf(r.o1)), fabsf(r.o2));
        // best hit: the same in every lane between leaves; each lane's own within one
        float best_t = kMiss, best_y = 0.0f;
        int best_c = -1, boxes = 0, leaves = 0, live = 0;
        if (!cull) {
            for (int base = 0; base < cones.m_pad; base += kLeaf) {
                float4 ca, cb;
                load_cone(cones, base + lane, ca, cb);
                const bool in = ca.w >= 0.0f;  // padding has ra = -1
                test_cone<kAny>(ca, cb, base + lane, in, r, tx, best_t, best_c, best_y);
                live += __popc(__ballot_sync(kFull, in));
                tested += in;
                issued += 1;
                ++leaves;
                if (kAny && __ballot_sync(kFull, best_c >= 0)) break;
            }
            if (!kAny) warp_best(best_t, best_c, best_y);
        } else {
            int sp = push_boxes<kAny>(cones, 0, cones.first[1] - cones.first[0], r, tx, s_t, s_n, 0, lane, boxes);
            while (sp > 0) {
                --sp;
                const float tn = s_t[sp];
                const int box = s_n[sp];
                __syncwarp();  // every lane has read the entry before a push writes over it
                if (!kAny && tn > best_t) continue;  // no cone in it has t <= best t
                if (box >= cones.leaf0) {  // a leaf: its cones' own boxes, then the closed form, a lane each
                    const int cone = (box - cones.leaf0) * kLeaf + lane;
                    float4 ca, cb;
                    load_cone(cones, cone, ca, cb);
                    const bool in = enters_cone_box(ca, cb, r, kAny ? tx : fminf(best_t, tx));
                    const unsigned entered = __ballot_sync(kFull, in);
                    ++leaves;
                    if (!entered) continue;  // no cone of the leaf can hit in the interval
                    const bool better = test_cone<kAny>(ca, cb, cone, in, r, tx, best_t, best_c, best_y);
                    const unsigned hits = __ballot_sync(kFull, better);
                    live += __popc(entered);
                    tested += in;
                    issued += 1;
                    if (kAny && hits) break;
                    if (!kAny && hits) warp_best(best_t, best_c, best_y);  // a lane's best changed: meet
                } else {  // an inner box: its children, a box a lane
                    int lo = cones.first[0], below = cones.first[1];
#pragma unroll
                    for (int l = 1; l < kMaxLevels; ++l) {
                        if (l < cones.levels - 1 && box >= cones.first[l]) {
                            lo = cones.first[l];
                            below = cones.first[l + 1];
                        }
                    }
                    sp = push_boxes<kAny>(cones, below + kWide * (box - lo), kWide, r, kAny ? tx : fminf(best_t, tx),
                                          s_t, s_n, sp, lane, boxes);
                }
            }
        }
        const bool occluded = kAny && __ballot_sync(kFull, best_c >= 0);
        if (lane == 0) {
            if (kAny) {
                occ_out[i] = occluded ? 1 : 0;
            } else {
                t_out[i] = best_t;
                cone_out[i] = best_c;
                y_out[i] = best_y;
            }
            if (stats) {
                stats[i] = boxes;
                stats[n + i] = leaves;
                stats[2 * n + i] = live;
            }
        }
    }
    if (slots) {
        const unsigned all_issued = __reduce_add_sync(kFull, issued), all_tested = __reduce_add_sync(kFull, tested);
        if (lane == 0) {
            atomicAdd(slots, static_cast<unsigned long long>(all_issued));
            atomicAdd(slots + 1, static_cast<unsigned long long>(all_tested));
        }
    }
}

// The cones and their tree; levels: the first box of each level, [nlevels + 1] on the host.
int make_cones(const void* aos, const void* boxes, const void* levels, int nlevels, int m_pad, Cones& c) {
    if (nlevels < 1 || nlevels > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
    c.aos = static_cast<const float4*>(aos);
    c.boxes = static_cast<const float*>(boxes);
    c.m_pad = m_pad;
    c.levels = nlevels;
    const int* lv = static_cast<const int*>(levels);
    for (int l = 0; l <= kMaxLevels; ++l) c.first[l] = l <= nlevels ? lv[l] : lv[nlevels];
    c.total = lv[nlevels];
    c.leaf0 = lv[nlevels - 1];
    if (c.first[1] - c.first[0] > kWide) return static_cast<int>(cudaErrorInvalidValue);
    return 0;
}

template <bool kAny>
int launch(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy, const void* dz,
           const void* tmin, const void* tmax, const void* aos, const void* boxes, const void* levels, int nlevels,
           int m_pad, int cull, long long n, int blocks, void* next_ray, void* t_out, void* cone_out, void* y_out,
           void* occ_out, void* stats, void* slots, void* stream) {
    Cones c;
    const int bad = make_cones(aos, boxes, levels, nlevels, m_pad, c);
    if (bad) return bad;
    cone_kernel<kAny><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, tmax, nullptr), c, cull, n, static_cast<int*>(next_ray),
        static_cast<float*>(t_out), static_cast<int*>(cone_out), static_cast<float*>(y_out),
        static_cast<unsigned char*>(occ_out), static_cast<int*>(stats), static_cast<unsigned long long*>(slots));
    STRELKA_RETURN_LAUNCH_STATUS();
}

}  // namespace

// Blocks of kThreads threads that fit on one SM at once for K8 (any = 1) or
// K7 -> *blocks_per_sm, *threads.
extern "C" int strelka_cone_occupancy(int any, void* blocks_per_sm, void* threads) {
    *static_cast<int*>(threads) = kThreads;
    return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        static_cast<int*>(blocks_per_sm), any ? cone_kernel<true> : cone_kernel<false>, kThreads, 0));
}

// Rays: 8 f32 [n] component arrays. Cones: the cone-major rows f32
// [m_pad, 8] = (a.xyz, ra, b.xyz, rb), 16-byte aligned; the tree's boxes f32
// [8, total] (ops/curves.py:cone_tree) and levels, a host int32 array of
// nlevels + 1 entries: the first box of each level, top first, then total
// (ops/curves.py:cone_tree_levels). cull = 0 sweeps every cone. blocks: the
// grid; next_ray: an int32 zeroed before the launch. Outputs: t f32, cone
// int32, y f32, each [n]; stats int32 [3, n] or null; slots uint64 [2]
// zeroed, or null.
extern "C" int strelka_cone_closest(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                                    const void* dz, const void* tmin, const void* tmax, const void* aos,
                                    const void* boxes, const void* levels, int nlevels, int m_pad, int cull,
                                    long long n, int blocks, void* next_ray, void* t_out, void* cone_out, void* y_out,
                                    void* stats, void* slots, void* stream) {
    return launch<false>(ox, oy, oz, dx, dy, dz, tmin, tmax, aos, boxes, levels, nlevels, m_pad, cull, n, blocks,
                         next_ray, t_out, cone_out, y_out, nullptr, stats, slots, stream);
}

// Same rays and cones; output occlusion as uint8 (torch.bool) [n].
extern "C" int strelka_cone_any(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                                const void* dz, const void* tmin, const void* tmax, const void* aos,
                                const void* boxes, const void* levels, int nlevels, int m_pad, int cull, long long n,
                                int blocks, void* next_ray, void* occ_out, void* stats, void* slots, void* stream) {
    return launch<true>(ox, oy, oz, dx, dy, dz, tmin, tmax, aos, boxes, levels, nlevels, m_pad, cull, n, blocks,
                        next_ray, nullptr, nullptr, nullptr, occ_out, stats, slots, stream);
}
