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
// Cull: the cones are Morton-sorted and packed (a.xyz, b.xyz, ra, rb; padding
// has ra = -1) with a box per 256-cone sub-block and per superblock of 8
// sub-blocks. A ray tests boxes with common.cuh:strelka_slab_safe (the slab
// test of pallas_intersect.py:_tile_hits_block per ray with the port's
// margin, which keeps a hit the closed form puts just outside its box;
// inverted boxes rejected, the far end clipped to the ray's best t for K7)
// and tests the cones of the sub-blocks it enters. cull = 0 sweeps every cone: the brute
// force the culled sweep is held against.
//
// Walks (the order in which a ray meets the boxes; the result is the same,
// since a cone replaces the best hit on t < best or on t == best with a
// lower index):
//  - list walk (K8, and K7 when asked): the superblocks in ascending order,
//    or in the order of a list per tile of `order_tile` consecutive rays
//    (order [n_tiles, nsb] and the entries that count, [n_tiles]: kernel
//    K9's superblocks that some ray of the tile passes, nearest first for the
//    tile), each superblock's sub-blocks in ascending order, every box
//    slab-tested against the interval the ray has when the walk reaches it.
//  - near to far per ray (K7's main path): the ray slab-tests its candidate
//    superblocks (all, or its tile's list) once against its own interval and
//    keeps the entered ones as (tnear, superblock) in shared memory, up to
//    `list_cap` at a time; it takes them nearest first by a lazy selection
//    (the lowest list position of equal tnear), and inside a superblock its
//    entered sub-blocks nearest first (the lowest of equal tnear first). It
//    stops at the first box whose tnear is greater than its best t: such a
//    box holds no cone with t <= best t, and the slab test against the final
//    interval would reject it too. The test is strict, since a box with
//    tnear equal to best t can still hold a cone of equal t and a lower
//    index. When the list is full the ray scans the rest of its candidates
//    in another round, against its best t by then; it never drops a box.
//    With the tile's list it stops scanning at the first entry whose least
//    tnear over the tile's rays (order_tn, ascending) is greater than best t:
//    no later entry is entered before best t. ops/curves.py:
//    near_to_far_sweep counts the sub-blocks this walk sweeps in plain
//    PyTorch.
//
// Bound on the H100: f32 operations, 119 a ray-cone test (3 square roots,
// 1 division), over the cones of the sub-blocks a ray's final interval
// enters; the cones are a few MB to 26 MB and stay in the 50 MB L2. Under
// -fmad=false every product and sum issues on its own but the closed form's
// 27 explicit FMAs (54 of the 119), where the 67 TFLOP/s peak counts an FMA
// as two: about 0.65 of the bound is the most this arithmetic can reach. Design: persistent warps, one ray a warp. The grid is
// as many blocks as fit on the card at once (the wrapper takes the count from
// the occupancy of the built kernel). A warp takes its next ray from a global
// counter (one atomicAdd; a dead ray costs it one load and a miss written)
// and sweeps it with all its lanes: they test kPair cones each of the same
// sub-block a step (64 consecutive cones: coalesced 32-byte rows, two
// independent tests in flight a lane), keep their own best hit inside a
// sub-block and meet (shuffles: least t, then lowest index) before the walk's
// next choice; K8 stops after the step with the first hit (a ballot). The
// walks run on the lanes too: 32 candidate boxes or a superblock's sub-blocks
// are slab-tested at once and the choice is the sequential walk's. Every lane
// of a warp works on one ray, so no lane idles for a neighbour's longer ray;
// the counter balances the warps, and the rays in flight at a time are a few
// thousand neighbours whose cones share the caches. One ray a lane, refilled
// between chunks of 32 cones, left half the lane slots idle: with 1.1-1.5
// live rays a lane, the last rays set each warp's length; 32 rays taken at
// once by a warp spread the rays in flight over a third of the image. The
// cones are stored cone-major, [M_pad, 8] = (a.xyz, ra, b.xyz, rb): one
// 32-byte sector a cone, two 16-byte loads through the read-only path.
// Outputs are written by ray index.

#include "common.cuh"

#include <climits>

namespace {

constexpr int kThreads = 128;
constexpr int kLanes = 32;
constexpr int kPair = 2;                  // cones a lane tests a step: independent tests in flight
constexpr int kStep = kLanes * kPair;     // cones a warp tests a step
constexpr int kSuper = 8;                 // sub-blocks a superblock on the near-to-far walk
constexpr float kMiss = 1e16f;
constexpr float kNone = 1e30f;  // "no box": above any best t
constexpr unsigned kFull = 0xffffffffu;

struct Cones {
    const float4* aos;     // [m_pad, 2]: (a.xyz, ra), (b.xyz, rb)
    const float* bounds;   // [8, nb] sub-block boxes
    const float* sbounds;  // [8, nb / super_] superblock boxes
    int m_pad;
    int nb;
    int super_;
    const int* order;  // [n_tiles, nb / super_] superblocks in sweep order, or null (ascending)
    const int* count;  // [n_tiles] entries of a tile's row that count
    int order_tile;    // rays a tile
    const float* order_tn;  // [n_tiles, nb / super_] the least tnear of a tile's rays at each entry, or null
    int list_cap;      // near to far: entries of a warp's superblock list in shared memory
};

struct Ray {
    float o0, o1, o2, d0, d1, d2, inv0, inv1, inv2, om, tn;  // om: |o|_inf, the box test's pad scale
};

// Where the warp's ray is in its walk; the same in every lane but `sub`.
struct Walk {
    const int* list;       // the tile's superblock list, or null (ascending)
    const float* list_tn;  // near to far: the least tnear of the tile's rays at each entry of list, or null
    int limit;             // entries of the list that count
    int pos;               // the next entry of the list
    int k;                 // list walk: the next sub-block of the superblock at pos
    int sb;                // near to far: the superblock being swept, -1 none
    int fill;              // near to far: entries in the shared list this round
    float sub;             // near to far: lane k < 8 holds sub-block k of sb's tnear, kNone once taken or not entered
};

// The lowered tnear of the ray's interval [tn, tfar] against box j of an
// [8, count] table (common.cuh:strelka_slab_safe), or kNone where the
// interval does not enter it or the box is inverted.
__device__ __forceinline__ float slab_tnear(const float* __restrict__ tbl, int count, int j, const Ray& r,
                                            float tfar) {
    const float* p = tbl + j;
    const float lx = __ldg(p), ly = __ldg(p + count), lz = __ldg(p + 2 * static_cast<long long>(count));
    const float hx = __ldg(p + 3 * static_cast<long long>(count)), hy = __ldg(p + 4 * static_cast<long long>(count)),
                hz = __ldg(p + 5 * static_cast<long long>(count));
    const float tnear = strelka_slab_safe(lx, ly, lz, hx, hy, hz, strelka_box_scale(lx, ly, lz, hx, hy, hz), r.o0,
                                          r.o1, r.o2, r.inv0, r.inv1, r.inv2, r.om, r.tn, tfar);
    return lx <= hx && tnear != INFINITY ? tnear : kNone;
}

// The least (v, at) over the warp, of equal v the least at; in every lane.
__device__ __forceinline__ void warp_argmin(float& v, int& at) {
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, v, o);
        const int oa = __shfl_xor_sync(kFull, at, o);
        if (ov < v || (ov == v && oa < at)) {
            v = ov;
            at = oa;
        }
    }
}

// List walk: the next sub-block the ray's interval [tn, tfar] enters (every
// sub-block with cull = 0), or -1 when none is left. The lanes slab-test 32
// superblocks, or a superblock's sub-blocks, at once, and the walk takes the
// first that is entered: each box is tested against the interval the ray
// has when the walk reaches it.
__device__ __forceinline__ int next_listed(const Cones& c, const Ray& r, float tfar, int cull, Walk& w, int lane) {
    const int nsb = c.nb / c.super_;
    while (w.pos < w.limit) {
        if (w.k == 0 && cull) {
            const int p = w.pos + lane;
            bool in = false;
            if (p < w.limit) in = slab_tnear(c.sbounds, nsb, w.list ? __ldg(w.list + p) : p, r, tfar) != kNone;
            const unsigned m = __ballot_sync(kFull, in);
            if (!m) {
                w.pos = min(w.pos + kLanes, w.limit);
                continue;
            }
            w.pos += __ffs(m) - 1;
        }
        const int sb = w.list ? __ldg(w.list + w.pos) : w.pos;
        const bool in = lane >= w.k && lane < c.super_ &&
                        (!cull || slab_tnear(c.bounds, c.nb, sb * c.super_ + lane, r, tfar) != kNone);
        const unsigned m = __ballot_sync(kFull, in);
        if (m) {
            const int k = __ffs(m) - 1;
            w.k = k + 1;
            if (w.k == c.super_) {
                w.k = 0;
                ++w.pos;
            }
            return sb * c.super_ + k;
        }
        w.k = 0;
        ++w.pos;
    }
    return -1;
}

// Near to far per ray: the nearest entered sub-block whose tnear is not
// above best_t, or -1 when none is left. s_tn and s_sb are the warp's list
// ([list_cap] each); lanes keep a sub-block's tnear each, scan the list and
// slab-test 32 candidates at once, and every choice is the sequential walk's.
__device__ __forceinline__ int next_near_far(const Cones& c, const Ray& r, float best_t, float tx, Walk& w,
                                             float* s_tn, int* s_sb, int lane) {
    const int nsb = c.nb / kSuper;
    const float bound = fminf(best_t, tx);
    while (true) {
        if (w.sb >= 0) {
            float tb = w.sub;
            int kb = lane;
            warp_argmin(tb, kb);
            if (tb <= best_t) {
                if (lane == kb) w.sub = kNone;
                return w.sb * kSuper + kb;
            }
            w.sb = -1;
        }
        float tb = kNone;
        int at = INT_MAX;
        for (int e = lane; e < w.fill; e += kLanes) {
            const float v = s_tn[e];
            if (v < tb) {
                tb = v;
                at = e;
            }
        }
        warp_argmin(tb, at);
        if (tb <= best_t) {
            w.sb = s_sb[at];
            __syncwarp();
            if (lane == 0) s_tn[at] = kNone;
            __syncwarp();
            w.sub = lane < kSuper ? slab_tnear(c.bounds, c.nb, w.sb * kSuper + lane, r, bound) : kNone;
            continue;
        }
        // this round's list holds nothing nearer than best t: scan on
        w.fill = 0;
        if (w.pos >= w.limit) return -1;
        while (w.pos < w.limit && w.fill < c.list_cap) {
            const int p = w.pos + lane;
            bool valid = p < w.limit;
            if (w.list_tn) {
                // the list goes by the least tnear of the tile's rays: none from the first
                // entry beyond best t on is entered before best t
                const unsigned beyond = __ballot_sync(kFull, valid && __ldg(w.list_tn + p) > best_t);
                if (beyond) {
                    const int cut = __ffs(beyond) - 1;
                    w.limit = w.pos + cut;
                    valid = lane < cut;
                }
            }
            int sb = 0;
            float tn = kNone;
            if (valid) {
                sb = w.list ? __ldg(w.list + p) : p;
                tn = slab_tnear(c.sbounds, nsb, sb, r, bound);
            }
            const unsigned e = __ballot_sync(kFull, tn != kNone);
            const int need = c.list_cap - w.fill;
            const int rank = __popc(e & ((1u << lane) - 1u));
            if (tn != kNone && rank < need) {
                s_tn[w.fill + rank] = tn;
                s_sb[w.fill + rank] = sb;
            }
            if (__popc(e) >= need) {  // full at the need-th entered candidate: the next round starts after it
                unsigned m = e;
                for (int q = 1; q < need; ++q) m &= m - 1;
                w.pos += __ffs(m);
                w.fill = c.list_cap;
            } else {
                w.pos = min(w.pos + kLanes, w.limit);
                w.fill += __popc(e);
            }
        }
        __syncwarp();
    }
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

// stats: [2, n] per ray (sub-blocks swept, cone positions stepped through,
// kStep a step of the warp, padding included) or null; slots: [2]
// launch-wide (lane slots the cone loop issued, lane slots that tested a
// cone) or null.
template <bool kAny, bool kNearFar>
__global__ void __launch_bounds__(kThreads) cone_kernel(StrelkaRays rays, Cones cones, int cull, long long n,
                                                        int* __restrict__ next_ray, float* __restrict__ t_out,
                                                        int* __restrict__ cone_out, float* __restrict__ y_out,
                                                        unsigned char* __restrict__ occ_out, int* __restrict__ stats,
                                                        unsigned long long* __restrict__ slots) {
    extern __shared__ float s_list[];  // near to far: per warp [list_cap] tnear, then [list_cap] superblock
    const int lane = threadIdx.x & (kLanes - 1);
    float* s_tn = s_list + (threadIdx.x / kLanes) * 2 * cones.list_cap;
    int* s_sb = reinterpret_cast<int*>(s_tn + cones.list_cap);
    const int tblk = cones.m_pad / cones.nb;
    const int nsb = cones.nb / cones.super_;
    const bool near_far = kNearFar && cull;
    unsigned issued = 0, tested = 0;
    while (true) {
        // the next ray, one atomicAdd a warp: the rays in flight on the card
        // at a time are a few thousand neighbours, whose cones share the caches
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
        const long long tile = cones.order ? i / cones.order_tile : 0;
        Walk w;
        w.list = cones.order ? cones.order + tile * nsb : nullptr;
        w.list_tn = cones.order_tn ? cones.order_tn + tile * nsb : nullptr;
        w.limit = cones.order ? __ldg(cones.count + tile) : nsb;
        w.pos = w.k = w.fill = 0;
        w.sb = -1;
        w.sub = kNone;
        // best hit: the same in every lane between sub-blocks; each lane's own within one
        float best_t = kMiss, best_y = 0.0f;
        int best_c = -1, swept = 0, steps = 0;
        bool occluded = false;
        while (!occluded) {
            const int blk = near_far ? next_near_far(cones, r, best_t, tx, w, s_tn, s_sb, lane)
                                     : next_listed(cones, r, kAny ? tx : fminf(best_t, tx), cull, w, lane);
            if (blk < 0) break;
            ++swept;
            for (int j = 0; j < tblk; j += kStep) {
                const int base = blk * tblk + j + lane;
                const float4* __restrict__ q = cones.aos + 2 * static_cast<long long>(base);
                float4 ca[kPair], cb[kPair];
#pragma unroll
                for (int u = 0; u < kPair; ++u) {
                    ca[u] = __ldg(q + 2 * kLanes * u);
                    cb[u] = __ldg(q + 2 * kLanes * u + 1);
                }
                float t[kPair], y[kPair], dd[kPair], t_ca_m[kPair], t_cb_m[kPair];
#pragma unroll
                for (int u = 0; u < kPair; ++u) {
                    t[u] = ray_cone<kAny>(ca[u].x, ca[u].y, ca[u].z, cb[u].x, cb[u].y, cb[u].z, ca[u].w, cb[u].w, r,
                                    y[u], dd[u], t_ca_m[u], t_cb_m[u]);
                }
#pragma unroll
                for (int u = 0; u < kPair; ++u) {
                    const int cone = base + kLanes * u;
                    if (!(ca[u].w >= 0.0f)) continue;  // padding
                    ++tested;
                    if (t[u] < kMiss && t[u] > r.tn && t[u] < tx &&
                        (t[u] < best_t || (t[u] == best_t && cone < best_c))) {
                        best_t = t[u];
                        best_c = cone;
                        if (!kAny) {
                            const float y_norm = fminf(fmaxf(y[u] / fmaxf(dd[u], 1e-12f), 0.0f), 1.0f);
                            best_y = t[u] == t_ca_m[u] ? 0.0f : (t[u] == t_cb_m[u] ? 1.0f : y_norm);
                        }
                    }
                }
                issued += kPair;
                steps += kStep;
                if (kAny && __ballot_sync(kFull, best_c >= 0)) {
                    occluded = true;
                    break;
                }
            }
            if (!kAny) {  // the warp's best: the least t, of equal t the lowest cone
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
        }
        if (lane == 0) {
            if (kAny) {
                occ_out[i] = occluded ? 1 : 0;
            } else {
                t_out[i] = best_t;
                cone_out[i] = best_c;
                y_out[i] = best_y;
            }
            if (stats) {
                stats[i] = swept;
                stats[n + i] = steps;
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

Cones make_cones(const void* aos, const void* bounds, const void* sbounds, int m_pad, int nb, int super_,
                 const void* order, const void* count, int order_tile, const void* order_tn, int list_cap) {
    Cones c;
    c.aos = static_cast<const float4*>(aos);
    c.bounds = static_cast<const float*>(bounds);
    c.sbounds = static_cast<const float*>(sbounds);
    c.m_pad = m_pad;
    c.nb = nb;
    c.super_ = super_;
    c.order = static_cast<const int*>(order);
    c.count = static_cast<const int*>(count);
    c.order_tile = order_tile;
    c.order_tn = static_cast<const float*>(order_tn);
    c.list_cap = list_cap;
    return c;
}

using ConeKernel = void (*)(StrelkaRays, Cones, int, long long, int*, float*, int*, float*, unsigned char*, int*,
                           unsigned long long*);

// The kernel a launch takes, and its dynamic shared memory.
template <bool kAny>
ConeKernel pick(int cull, int near_far, int list_cap, int& smem) {
    if (!kAny && cull && near_far) {
        smem = list_cap * (kThreads / kLanes) * 8;
        return cone_kernel<false, true>;
    }
    smem = 0;
    return cone_kernel<kAny, false>;
}

template <bool kAny>
int launch(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy, const void* dz,
           const void* tmin, const void* tmax, const void* aos, const void* bounds, const void* sbounds, int m_pad,
           int nb, int super_, int cull, int near_far, const void* order, const void* count, int order_tile,
           const void* order_tn, int list_cap, long long n, int blocks, void* next_ray, void* t_out, void* cone_out,
           void* y_out, void* occ_out, void* stats, void* slots, void* stream) {
    int smem = 0;
    const ConeKernel kernel = pick<kAny>(cull, near_far, list_cap, smem);
    if (smem > 48 * 1024) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, tmax, nullptr),
        make_cones(aos, bounds, sbounds, m_pad, nb, super_, order, count, order_tile, order_tn, list_cap), cull, n,
        static_cast<int*>(next_ray), static_cast<float*>(t_out), static_cast<int*>(cone_out),
        static_cast<float*>(y_out), static_cast<unsigned char*>(occ_out), static_cast<int*>(stats),
        static_cast<unsigned long long*>(slots));
    STRELKA_RETURN_LAUNCH_STATUS();
}

}  // namespace

// Blocks of kThreads threads that fit on one SM at once for the kernel that
// a launch with these arguments takes -> *blocks_per_sm, *threads.
extern "C" int strelka_cone_occupancy(int any, int cull, int near_far, int list_cap, void* blocks_per_sm,
                                      void* threads) {
    int smem = 0;
    const ConeKernel kernel =
        any ? pick<true>(cull, near_far, list_cap, smem) : pick<false>(cull, near_far, list_cap, smem);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    *static_cast<int*>(threads) = kThreads;
    return static_cast<int>(
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(static_cast<int*>(blocks_per_sm), kernel, kThreads, smem));
}

// Rays: 8 f32 [n] component arrays. Cones: the cone-major rows f32
// [m_pad, 8] = (a.xyz, ra, b.xyz, rb), 16-byte aligned, sub-block boxes f32
// [8, nb], superblock boxes f32 [8, nb / super_]; order int32
// [ceil(n / order_tile), nb / super_] and count int32 [ceil(n / order_tile)],
// or both null (ascending, or every superblock a candidate; always with
// cull = 0); order_tn f32 like order, the least tnear of a tile's rays at
// each entry (ascending along a row), or null. near_far = 1 takes the near-to-far walk per ray (super_ = 8,
// list_cap entries a thread of shared memory). blocks: the grid; next_ray:
// an int32 zeroed before the launch. Outputs: t f32, cone int32, y f32, each
// [n]; stats int32 [2, n] or null; slots uint64 [2] zeroed, or null.
extern "C" int strelka_cone_closest(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                                    const void* dz, const void* tmin, const void* tmax, const void* aos,
                                    const void* bounds, const void* sbounds, int m_pad, int nb, int super_,
                                    int cull, int near_far, const void* order, const void* count, int order_tile,
                                    const void* order_tn, int list_cap, long long n, int blocks, void* next_ray,
                                    void* t_out,
                                    void* cone_out, void* y_out, void* stats, void* slots, void* stream) {
    return launch<false>(ox, oy, oz, dx, dy, dz, tmin, tmax, aos, bounds, sbounds, m_pad, nb, super_, cull, near_far,
                         order, count, order_tile, order_tn, list_cap, n, blocks, next_ray, t_out, cone_out, y_out,
                         nullptr,
                         stats, slots, stream);
}

// Same rays and cones, the list walk; output occlusion as uint8 (torch.bool) [n].
extern "C" int strelka_cone_any(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                                const void* dz, const void* tmin, const void* tmax, const void* aos,
                                const void* bounds, const void* sbounds, int m_pad, int nb, int super_, int cull,
                                const void* order, const void* count, int order_tile, long long n, int blocks,
                                void* next_ray, void* occ_out, void* stats, void* slots, void* stream) {
    return launch<true>(ox, oy, oz, dx, dy, dz, tmin, tmax, aos, bounds, sbounds, m_pad, nb, super_, cull, 0, order,
                        count, order_tile, nullptr, 0, n, blocks, next_ray, nullptr, nullptr, nullptr, occ_out, stats,
                        slots, stream);
}
