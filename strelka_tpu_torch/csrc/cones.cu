// Kernels K7 (closest hit) and K8 (any hit) over round cones (hair).
//
// Replace the three cone kernels of strelka_tpu/ops/curves.py:
// pallas_intersect_cones (a near-to-far sweep of ray tiles over 8x256-cone
// superblocks), pallas_intersect_cones_fusedk (phase 1 of the residual
// two-pass, with its open flag) and pallas_intersect_cones_wl (a work-list
// sweep). All three compute one function: per ray the closest (t, cone), or
// occlusion, over all round cones with ra >= 0 and tmin < t < tmax. They
// differ in TPU schedule only. Of that schedule the near-to-far order per
// ray tile is carried over (below, from kernel K9); fused-K phase 1 and the
// work lists answer a cost per grid step that this card does not have.
//
// Contract (the plain PyTorch version is
// strelka_tpu_torch/ops/curves.py:intersect_curves_closest_plain, the dense
// sweep of strelka_tpu/ops/curves.py:intersect_curves_closest): t is the
// least of the cone body's root and the two cap spheres' roots, in the f32
// operation order of _ray_round_cone; this file is built with -fmad=false,
// so every product and sum rounds on its own (k0, h and y are differences
// of products, and the body is accepted on h > 0, 0 < y < d2). K7 returns
// the least t, its cone index and the axial position y in [0, 1] on that
// cone (0 or 1 on a cap, by float equality of t with the cap's root), so
// that u = u0 + (u1 - u0) * y is the CPU reference's. Of equal t the
// lowest cone index wins. A
// miss is t = 1e16, cone = -1, y = 0. A lane with tmax <= tmin reads
// nothing and misses. K8 stops at the first hit.
//
// Cull: the cones are Morton-sorted and packed (a.xyz, b.xyz, ra, rb; padding
// has ra = -1) with a box per 256-cone sub-block and per superblock of 8
// sub-blocks. A ray slab-tests the superblock boxes, then the sub-block boxes
// of a superblock it enters, with
// the test of pallas_intersect.py:_tile_hits_block taken per ray (inv =
// 1 / (|d| > 1e-20 ? d : 1e-20), tnear <= tfar with equality, inverted
// boxes rejected, the far end clipped to the ray's best t for K7), and tests
// the cones of a sub-block it enters. The slab arithmetic rounds, so a
// grazing ray could lose a hit the unculled sweep finds; on the hair scenes'
// ray sets it loses none (chip_smoke.py holds the two equal on every lane).
// cull = 0 sweeps every cone: the brute force the culled sweep is held
// against.
//
// Order: the superblocks go by in ascending order, or, given a list per tile
// of `order_tile` consecutive rays (order [n_tiles, nsb] and the number of
// entries that count, [n_tiles]), in the list's order and no further than its
// count. The list comes from kernel K9 (open_w.cu): the superblocks that some
// ray of the tile passes, nearest first, so that a ray's best t shrinks early
// and the slab test rejects what lies behind it. A cone replaces the best hit
// on t < best, or on t == best with a lower index, so the result is the
// ascending sweep's whatever the order.
//
// Bound on the H100: f32 operations, 119 a ray-cone test (3 square roots,
// 1 division), over the cones of the sub-blocks a ray's final interval
// enters; the cones are a few MB and stay in L2. Design: one ray per thread,
// the ray and its best hit in registers. Each lane finds its own next
// sub-block (`next_block`) and then all lanes of a warp run the 256-cone
// loop together, each on its own sub-block: a lane never waits for a
// sub-block that only its neighbours enter (a first version that walked the
// sub-blocks in lockstep made every warp of incoherent bounce rays test the
// union of its lanes' sub-blocks, nearly all of them). For that the cones
// are stored cone-major, [M_pad, 8] = (a.xyz, ra, b.xyz, rb): one 32-byte
// sector a cone, two 16-byte loads through the read-only path. No shared
// memory.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr float kMiss = 1e16f;

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
};

struct Ray {
    float o0, o1, o2, d0, d1, d2, inv0, inv1, inv2, tn;
};

// Does the ray's interval [tn, tfar] enter box j of an [8, count] table?
__device__ __forceinline__ bool enters(const float* __restrict__ tbl, int count, int j, const Ray& r, float tfar) {
    const float* p = tbl + j;
    const float lx = __ldg(p), ly = __ldg(p + count), lz = __ldg(p + 2 * static_cast<long long>(count));
    const float hx = __ldg(p + 3 * static_cast<long long>(count)), hy = __ldg(p + 4 * static_cast<long long>(count)),
                hz = __ldg(p + 5 * static_cast<long long>(count));
    const float x0 = (lx - r.o0) * r.inv0, x1 = (hx - r.o0) * r.inv0;
    const float y0 = (ly - r.o1) * r.inv1, y1 = (hy - r.o1) * r.inv1;
    const float z0 = (lz - r.o2) * r.inv2, z1 = (hz - r.o2) * r.inv2;
    const float tnear = fmaxf(fmaxf(fmaxf(r.tn, fminf(x0, x1)), fminf(y0, y1)), fminf(z0, z1));
    tfar = fminf(fminf(fminf(tfar, fmaxf(x0, x1)), fmaxf(y0, y1)), fmaxf(z0, z1));
    return tnear <= tfar && lx <= hx;
}

// The walk over the boxes: pos, the place in the sweep order (`list`, `limit`
// entries, or ascending over all superblocks when list is null), and k, the
// next sub-block of that superblock to look at. Returns the next sub-block the
// ray's interval [tn, tfar] enters (every sub-block with cull = 0), or nb when
// none is left.
__device__ __forceinline__ int next_block(const Cones& c, const Ray& r, float tfar, int cull,
                                          const int* __restrict__ list, int limit, int& pos, int& k) {
    const int nsb = c.nb / c.super_;
    while (pos < limit) {
        const int sb = list ? __ldg(list + pos) : pos;
        if (k == 0 && cull && !enters(c.sbounds, nsb, sb, r, tfar)) {
            ++pos;
            continue;
        }
        while (k < c.super_) {
            const int blk = sb * c.super_ + k;
            ++k;
            if (!cull || enters(c.bounds, c.nb, blk, r, tfar)) return blk;
        }
        k = 0;
        ++pos;
    }
    return c.nb;
}

// One ray against one round cone: the least root in (., 1e16], and what the
// axial position needs (y, d2 and the caps' roots).
__device__ __forceinline__ float ray_cone(float ax, float ay, float az, float bx, float by, float bz, float ra,
                                          float rb, const Ray& r, float& y, float& dd, float& t_ca_m,
                                          float& t_cb_m) {
    const float bax = bx - ax, bay = by - ay, baz = bz - az;
    const float oax = r.o0 - ax, oay = r.o1 - ay, oaz = r.o2 - az;
    const float rr = ra - rb;
    const float m0 = bax * bax + bay * bay + baz * baz;
    const float m1 = oax * bax + oay * bay + oaz * baz;
    const float m2 = r.d0 * bax + r.d1 * bay + r.d2 * baz;
    const float m3 = r.d0 * oax + r.d1 * oay + r.d2 * oaz;
    const float m5 = oax * oax + oay * oay + oaz * oaz;
    dd = m0 - rr * rr;
    const float k2 = dd - m2 * m2;
    const float k1 = dd * m3 - m1 * m2 + m2 * rr * ra;
    const float k0 = dd * m5 - m1 * m1 + 2.0f * m1 * rr * ra - dd * ra * ra;
    const float h = k1 * k1 - k0 * k2;
    const float safe_k2 = fabsf(k2) > 1e-12f ? k2 : 1e-12f;
    const float t_body = (-sqrtf(fmaxf(h, 0.0f)) - k1) / safe_k2;
    y = m1 + t_body * m2;
    const bool body_ok = h > 0.0f && y > 0.0f && y < dd;
    // cap sphere at a (radius ra)
    const float bqa = oax * r.d0 + oay * r.d1 + oaz * r.d2;
    const float cqa = oax * oax + oay * oay + oaz * oaz - ra * ra;
    const float hqa = bqa * bqa - cqa;
    const float t_ca = -bqa - sqrtf(fmaxf(hqa, 0.0f));
    // cap sphere at b (radius rb)
    const float obx = r.o0 - bx, oby = r.o1 - by, obz = r.o2 - bz;
    const float bqb = obx * r.d0 + oby * r.d1 + obz * r.d2;
    const float cqb = obx * obx + oby * oby + obz * obz - rb * rb;
    const float hqb = bqb * bqb - cqb;
    const float t_cb = -bqb - sqrtf(fmaxf(hqb, 0.0f));
    const float t_body_m = body_ok ? t_body : kMiss;
    t_ca_m = hqa > 0.0f ? t_ca : kMiss;
    t_cb_m = hqb > 0.0f ? t_cb : kMiss;
    return fminf(t_body_m, fminf(t_ca_m, t_cb_m));
}

template <bool kAny>
__global__ void __launch_bounds__(kThreads) cone_kernel(StrelkaRays rays, Cones cones, int cull, long long n, float* __restrict__ t_out,
                                                        int* __restrict__ cone_out, float* __restrict__ y_out,
                                                        unsigned char* __restrict__ occ_out,
                                                        int* __restrict__ stats) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= n) return;
    Ray r;
    r.tn = rays.tmin[i];
    const float tx = rays.tmax[i];
    float best_t = kMiss, best_y = 0.0f;
    int best_c = -1;
    int blocks_swept = 0, cones_tested = 0;
    if (tx > r.tn) {
        r.o0 = rays.ox[i]; r.o1 = rays.oy[i]; r.o2 = rays.oz[i];
        r.d0 = rays.dx[i]; r.d1 = rays.dy[i]; r.d2 = rays.dz[i];
        r.inv0 = 1.0f / (fabsf(r.d0) > 1e-20f ? r.d0 : 1e-20f);
        r.inv1 = 1.0f / (fabsf(r.d1) > 1e-20f ? r.d1 : 1e-20f);
        r.inv2 = 1.0f / (fabsf(r.d2) > 1e-20f ? r.d2 : 1e-20f);
        const int tblk = cones.m_pad / cones.nb;
        const int nsb = cones.nb / cones.super_;
        const long long tile = cones.order ? i / cones.order_tile : 0;
        const int* __restrict__ list = cones.order ? cones.order + tile * nsb : nullptr;
        const int limit = cones.order ? __ldg(cones.count + tile) : nsb;
        int pos = 0, k = 0;
        int blk = next_block(cones, r, tx, cull, list, limit, pos, k);
        while (blk < cones.nb) {
            ++blocks_swept;
            const int base = blk * tblk;
            const float4* __restrict__ q = cones.aos + 2 * static_cast<long long>(base);
            int j = 0;
            for (; j < tblk; ++j) {
                const float4 ca = __ldg(q + 2 * j), cb = __ldg(q + 2 * j + 1);
                if (!(ca.w >= 0.0f)) continue;  // padding
                float y, dd, t_ca_m, t_cb_m;
                const float t = ray_cone(ca.x, ca.y, ca.z, cb.x, cb.y, cb.z, ca.w, cb.w, r, y, dd, t_ca_m, t_cb_m);
                if (t < kMiss && t > r.tn && t < tx && (t < best_t || (t == best_t && base + j < best_c))) {
                    best_t = t;
                    best_c = base + j;
                    if (kAny) break;
                    const float y_norm = fminf(fmaxf(y / fmaxf(dd, 1e-12f), 0.0f), 1.0f);
                    best_y = t == t_ca_m ? 0.0f : (t == t_cb_m ? 1.0f : y_norm);
                }
            }
            cones_tested += min(j + 1, tblk);
            if (kAny && best_c >= 0) break;
            blk = next_block(cones, r, kAny ? tx : fminf(best_t, tx), cull, list, limit, pos, k);
        }
    }
    if (kAny) {
        occ_out[i] = best_c >= 0 ? 1 : 0;
    } else {
        t_out[i] = best_t;
        cone_out[i] = best_c;
        y_out[i] = best_y;
    }
    if (stats) {
        stats[i] = blocks_swept;
        stats[n + i] = cones_tested;
    }
}

Cones make_cones(const void* aos, const void* bounds, const void* sbounds, int m_pad, int nb, int super_,
                 const void* order, const void* count, int order_tile) {
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
    return c;
}

}  // namespace

// Rays: 8 f32 [n] component arrays. Cones: the cone-major rows f32
// [m_pad, 8] = (a.xyz, ra, b.xyz, rb), 16-byte aligned, sub-block boxes f32
// [8, nb], superblock boxes f32 [8, nb / super_]; order int32
// [ceil(n / order_tile), nb / super_] and count int32 [ceil(n / order_tile)],
// or both null (ascending order; always with cull = 0). Outputs: t f32,
// cone int32, y f32, each [n]; stats int32 [2, n] or null (sub-blocks swept
// and cones tested per ray).
extern "C" int strelka_cone_closest(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                                    const void* dz, const void* tmin, const void* tmax, const void* aos,
                                    const void* bounds, const void* sbounds, int m_pad, int nb, int super_,
                                    int cull, const void* order, const void* count, int order_tile, long long n,
                                    void* t_out, void* cone_out, void* y_out, void* stats, void* stream) {
    cone_kernel<false><<<strelka_blocks(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, tmax, nullptr),
        make_cones(aos, bounds, sbounds, m_pad, nb, super_, order, count, order_tile), cull, n,
        static_cast<float*>(t_out),
        static_cast<int*>(cone_out), static_cast<float*>(y_out), nullptr, static_cast<int*>(stats));
    STRELKA_RETURN_LAUNCH_STATUS();
}

// Same rays and cones; output occlusion as uint8 (torch.bool) [n].
extern "C" int strelka_cone_any(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy,
                                const void* dz, const void* tmin, const void* tmax, const void* aos,
                                const void* bounds, const void* sbounds, int m_pad, int nb, int super_, int cull,
                                const void* order, const void* count, int order_tile, long long n, void* occ_out,
                                void* stats, void* stream) {
    cone_kernel<true><<<strelka_blocks(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, tmax, nullptr),
        make_cones(aos, bounds, sbounds, m_pad, nb, super_, order, count, order_tile), cull, n, nullptr, nullptr,
        nullptr,
        static_cast<unsigned char*>(occ_out), static_cast<int*>(stats));
    STRELKA_RETURN_LAUNCH_STATUS();
}
