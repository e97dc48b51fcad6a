// Kernels K2 (closest hit) and K3 (any hit) over a flat triangle list.
//
// Replace strelka_tpu/ops/pallas_intersect.py:pallas_intersect_closest_mxu_small
// and pallas_intersect_any_mxu_small (and the _flat/_mxu_flat kernels, which
// compute the same function with a cull per sub-block). On the TPU those run
// Möller–Trumbore as four matmuls over ray features (bf16 passes, a packed
// t/row fold). None of that carries over: here MT is the f32 arithmetic of
// strelka_tpu/ops/intersect.py:_ray_tri_block term by term, and this file is
// built with -fmad=false so that every product and sum rounds on its own, as
// on the CPU reference.
//
// Contract (same as intersect_closest_bruteforce / intersect_any_bruteforce):
//   hit = |det| > 1e-12, u >= 0, v >= 0, u + v <= 1, tmin < t < tmax,
//         (geom_mask & ray_mask) != 0, prim != exclude.
//   K2 keeps the smallest t; on equal t the lowest prim id wins. A miss is
//   t = 1e16, prim = -1, u = v = 0. K3 reports whether any triangle hits.
//
// Cull: the triangles, in the table's own order, form groups of 32 (group g
// holds triangles 32g .. 32g + 31), each with its box (the [8, G] table of
// kernels/intersect.py:tri_group_bounds, the reference's block_bounds with
// tblk = 32; padding and mask-0 triangles give inverted boxes). A ray
// tests the boxes with common.cuh:strelka_slab_safe (the slab test of
// pallas_intersect.py:_tile_hits_block per ray, with the margin that keeps
// every hit Möller–Trumbore accepts inside its group's box; inverted boxes
// rejected) and tests the triangles of the groups its interval enters, so
// the result is the dense sweep's on every lane. cull = 0 takes every group:
// the sweep the culled one is held against.
//
// Bound on the H100: f32 operations, 46 per ray-triangle test, over the
// triangles of the groups a ray's final interval enters, and 24 per slab
// test (the margin's 21 more are the kernel's overhead, not the function's
// work); rays and triangles are a few MB at most. The dense sweep issued 94
// instructions a test (the operations, 10 shared-memory loads, compares and
// branches) for every triangle: culling is what cuts the work, since the
// arithmetic has to stay as it is.
//
// Two schedules, the same results:
//  - one ray a warp (schedule 0): persistent warps; a warp takes its next 32
//    rays from a global counter (one atomicAdd), each lane loads one of them,
//    and the warp walks the live ones in turn (a dead ray, tmax <= tmin, is
//    a miss written). Its lanes slab-test 32 group boxes at once.
//    K2 takes the entered groups of those 32 nearest first (a warp argmin
//    over (tnear, group)), each lane testing one triangle of the group, and
//    the lanes meet by shuffles on the least (t, prim); it stops at the first
//    group whose tnear is greater than its best t (strict: a group with tnear
//    equal to best t may hold a triangle of equal t and a lower id), then
//    slab-tests the next 32 boxes against its interval by then. K3 takes the
//    entered groups in ascending order and stops after the group with the
//    first hit (a ballot). A ray's groups tested can be counted per ray.
//    kernels/intersect.py:closest_walk_plain and any_walk_plain repeat both
//    walks in plain PyTorch.
//  - one ray a thread (schedule 1): blocks of 256 rays stream the triangles
//    through shared memory in tiles of up to 32 groups (40 KB, less for a
//    smaller scene, and the groups' boxes); each thread walks the tile's groups in ascending order, skips a
//    group its interval [tmin, min(best t, tmax)] does not enter and tests
//    the triangles whose mask matches (the mask is the same for every lane,
//    so the skip costs the warp nothing). K3 stops per thread at the first
//    hit, and a block loads no more tiles once all its rays are done.
// A replaced best hit needs t < best, or equal t and a lower id; with one
// ray a thread the ids come in ascending order and t < best is that rule.

#include "common.cuh"

namespace {

constexpr int kLanes = 32;
constexpr int kGroup = 32;  // triangles a group: one a lane
constexpr int kWarpThreads = 128;
constexpr int kThreads = 256;
constexpr int kTileGroups = 32;
constexpr int kTriTile = kTileGroups * kGroup;  // 40 KB of triangles: under the 48 KB a block takes unasked
constexpr float kMiss = 1e16f;
constexpr float kNone = INFINITY;  // "not entered": above any best t
constexpr unsigned kFull = 0xffffffffu;

struct Ray {
    float o0, o1, o2, d0, d1, d2, inv0, inv1, inv2, om, tn, tx;  // om: |o|_inf, the box test's pad scale
    int ex;
};

__device__ __forceinline__ Ray load_ray(const StrelkaRays& rays, long long i, float tn, float tx) {
    Ray r;
    r.tn = tn;
    r.tx = tx;
    r.o0 = rays.ox[i]; r.o1 = rays.oy[i]; r.o2 = rays.oz[i];
    r.d0 = rays.dx[i]; r.d1 = rays.dy[i]; r.d2 = rays.dz[i];
    r.inv0 = 1.0f / (fabsf(r.d0) > 1e-20f ? r.d0 : 1e-20f);
    r.inv1 = 1.0f / (fabsf(r.d1) > 1e-20f ? r.d1 : 1e-20f);
    r.inv2 = 1.0f / (fabsf(r.d2) > 1e-20f ? r.d2 : 1e-20f);
    r.om = fmaxf(fmaxf(fabsf(r.o0), fabsf(r.o1)), fabsf(r.o2));
    r.ex = rays.exclude ? rays.exclude[i] : -1;
    return r;
}

// The lowered tnear of the ray's interval [tn, tfar] against a box, or
// kNone where the interval does not enter it or the box is inverted
// (common.cuh:strelka_slab_safe).
__device__ __forceinline__ float slab_tnear(float lx, float ly, float lz, float hx, float hy, float hz, const Ray& r,
                                            float tfar) {
    const float tnear = strelka_slab_safe(lx, ly, lz, hx, hy, hz, strelka_box_scale(lx, ly, lz, hx, hy, hz), r.o0,
                                          r.o1, r.o2, r.inv0, r.inv1, r.inv2, r.om, r.tn, tfar);
    return lx <= hx ? tnear : kNone;
}

// Group g's box from the [8, ngroups] table.
__device__ __forceinline__ float group_tnear(const float* __restrict__ bounds, int ngroups, int g, const Ray& r,
                                             float tfar) {
    const float* p = bounds + g;
    const long long s = ngroups;
    return slab_tnear(__ldg(p), __ldg(p + s), __ldg(p + 2 * s), __ldg(p + 3 * s), __ldg(p + 4 * s), __ldg(p + 5 * s),
                      r, tfar);
}

// Triangle j against the ray: mask, exclude and MT (t, u, v set on a hit).
__device__ __forceinline__ bool tri_hit(const StrelkaTris& tris, int j, int ray_mask, const Ray& r, float& t,
                                        float& u, float& v) {
    if (j >= tris.count || (__ldg(tris.mask + j) & ray_mask) == 0 || j == r.ex) return false;
    const float* a = tris.v0 + 3LL * j;
    const float* b = tris.e1 + 3LL * j;
    const float* c = tris.e2 + 3LL * j;
    return strelka_ray_tri(__ldg(a), __ldg(a + 1), __ldg(a + 2), __ldg(b), __ldg(b + 1), __ldg(b + 2), __ldg(c),
                           __ldg(c + 1), __ldg(c + 2), r.o0, r.o1, r.o2, r.d0, r.d1, r.d2, r.tn, r.tx, t, u, v);
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

// Ray `src` of the warp's batch, from the lane that loaded it.
__device__ __forceinline__ Ray shfl_ray(const Ray& mine, int src) {
    Ray r;
    r.o0 = __shfl_sync(kFull, mine.o0, src); r.o1 = __shfl_sync(kFull, mine.o1, src);
    r.o2 = __shfl_sync(kFull, mine.o2, src);
    r.d0 = __shfl_sync(kFull, mine.d0, src); r.d1 = __shfl_sync(kFull, mine.d1, src);
    r.d2 = __shfl_sync(kFull, mine.d2, src);
    r.inv0 = __shfl_sync(kFull, mine.inv0, src); r.inv1 = __shfl_sync(kFull, mine.inv1, src);
    r.inv2 = __shfl_sync(kFull, mine.inv2, src);
    r.om = __shfl_sync(kFull, mine.om, src);
    r.tn = __shfl_sync(kFull, mine.tn, src); r.tx = __shfl_sync(kFull, mine.tx, src);
    r.ex = __shfl_sync(kFull, mine.ex, src);
    return r;
}

struct Best {
    float t, u, v;
    int prim, tested;
    bool occluded;
};

// One live ray's walk with all the warp's lanes; the result in every lane.
template <bool kAny>
__device__ __forceinline__ Best walk(const Ray& r, const StrelkaTris& tris, const float* __restrict__ bounds,
                                     int ngroups, int ray_mask, int cull, int lane) {
    Best b = {kMiss, 0.0f, 0.0f, -1, 0, false};
    for (int base = 0; base < ngroups && !b.occluded; base += kLanes) {
        // the lane's group: its tnear against the interval the ray has now (without the cull every
        // group is entered, and the walk takes them in ascending order)
        const int g = base + lane;
        float tnear = kNone;
        if (g < ngroups) tnear = cull ? group_tnear(bounds, ngroups, g, r, kAny ? r.tx : fminf(b.t, r.tx)) : -kNone;
        if (kAny) {
            unsigned entered = __ballot_sync(kFull, tnear != kNone);
            while (entered) {
                const int grp = base + __ffs(entered) - 1;
                entered &= entered - 1;
                ++b.tested;
                float t = 0.0f, u = 0.0f, v = 0.0f;
                if (__any_sync(kFull, tri_hit(tris, grp * kGroup + lane, ray_mask, r, t, u, v))) {
                    b.occluded = true;
                    break;
                }
            }
            continue;
        }
        while (true) {
            float tb = tnear;
            int at = lane;
            warp_argmin(tb, at);
            if (!(tb <= b.t)) break;  // nothing of these 32 groups holds a t <= best t
            if (lane == at) tnear = kNone;
            const int grp = base + at;
            ++b.tested;
            const int j = grp * kGroup + lane;
            float t = 0.0f, u = 0.0f, v = 0.0f;
            const bool hit = tri_hit(tris, j, ray_mask, r, t, u, v);
            const bool better = hit && (t < b.t || (t == b.t && j < b.prim));
            if (__any_sync(kFull, better)) {  // the warp's best: the least t, of equal t the lowest id
                float bt = better ? t : b.t;
                int bp = better ? j : b.prim;
#pragma unroll
                for (int o = kLanes / 2; o > 0; o >>= 1) {
                    const float ot = __shfl_xor_sync(kFull, bt, o);
                    const int op = __shfl_xor_sync(kFull, bp, o);
                    if (ot < bt || (ot == bt && op < bp)) {
                        bt = ot;
                        bp = op;
                    }
                }
                const int src = bp - grp * kGroup;  // the lane that holds it
                b.u = __shfl_sync(kFull, u, src);
                b.v = __shfl_sync(kFull, v, src);
                b.t = bt;
                b.prim = bp;
            }
        }
    }
    return b;
}

// One ray a warp. A warp takes 32 consecutive rays at a time (one atomicAdd);
// each lane loads one of them (coalesced, with its reciprocal direction),
// the warp walks the live ones in turn, each broadcast by shuffles, and each
// lane writes its ray's result. groups_out: [n] groups whose triangles the
// ray's walk tested, or null.
template <bool kAny>
__global__ void __launch_bounds__(kWarpThreads) tri_warp_kernel(StrelkaRays rays, StrelkaTris tris,
                                                                const float* __restrict__ bounds, int ngroups,
                                                                int ray_mask, int cull, long long n,
                                                                int* __restrict__ next_ray, float* __restrict__ t_out,
                                                                int* __restrict__ prim_out, float* __restrict__ u_out,
                                                                float* __restrict__ v_out,
                                                                unsigned char* __restrict__ occ_out,
                                                                int* __restrict__ groups_out) {
    const int lane = threadIdx.x & (kLanes - 1);
    while (true) {
        int first = 0;
        if (lane == 0) first = atomicAdd(next_ray, kLanes);
        first = __shfl_sync(kFull, first, 0);
        if (first >= n) break;
        const long long i = static_cast<long long>(first) + lane;
        Ray mine = {};
        bool live = false;
        if (i < n) {
            const float tn = rays.tmin[i], tx = rays.tmax[i];
            live = tx > tn;
            if (live) mine = load_ray(rays, i, tn, tx);
        }
        Best out = {kMiss, 0.0f, 0.0f, -1, 0, false};
        for (unsigned todo = __ballot_sync(kFull, live); todo; todo &= todo - 1) {
            const int src = __ffs(todo) - 1;
            const Best b = walk<kAny>(shfl_ray(mine, src), tris, bounds, ngroups, ray_mask, cull, lane);
            if (lane == src) out = b;
        }
        if (i < n) {
            if (kAny) {
                occ_out[i] = out.occluded ? 1 : 0;
            } else {
                t_out[i] = out.t;
                prim_out[i] = out.prim;
                u_out[i] = out.u;
                v_out[i] = out.v;
            }
            if (groups_out) groups_out[i] = out.tested;
        }
    }
}

// A tile of triangles in shared memory: v0 xyz, e1 xyz, e2 xyz and the mask,
// `tile` entries each, then the boxes of its kTileGroups groups (6 rows).
// tile is the scene's triangle count rounded up to a group, at most kTriTile.
struct Tile {
    float* v;
    int* mask;
    float* box;
    int tile;
};

__device__ __forceinline__ Tile tile_at(float* smem, int tile) {
    return Tile{smem, reinterpret_cast<int*>(smem + 9 * tile), smem + 10 * tile, tile};
}

__host__ __device__ inline int tile_of(int ntri) { return min(kTriTile, (ntri + kGroup - 1) / kGroup * kGroup); }

inline size_t tile_bytes(int ntri) { return (static_cast<size_t>(tile_of(ntri)) * 10 + 6 * kTileGroups) * 4; }

__device__ inline void load_tile(const Tile& s, const StrelkaTris& tris, const float* __restrict__ bounds,
                                 int ngroups, int base, int cnt, int cull) {
    for (int k = threadIdx.x; k < cnt * 3; k += blockDim.x) {
        const long long g = static_cast<long long>(base) * 3 + k;
        const int j = k / 3;
        const int c = k - j * 3;
        s.v[c * s.tile + j] = tris.v0[g];
        s.v[(3 + c) * s.tile + j] = tris.e1[g];
        s.v[(6 + c) * s.tile + j] = tris.e2[g];
    }
    for (int j = threadIdx.x; j < cnt; j += blockDim.x) s.mask[j] = tris.mask[base + j];
    if (cull) {
        const int g0 = base / kGroup, ng = (cnt + kGroup - 1) / kGroup;
        for (int k = threadIdx.x; k < 6 * ng; k += blockDim.x) {
            const int row = k / ng, gl = k - row * ng;
            s.box[row * kTileGroups + gl] = bounds[static_cast<long long>(row) * ngroups + g0 + gl];
        }
    }
}

// One ray a thread; dynamic shared memory of tile_bytes(ntri).
template <bool kAny>
__global__ void __launch_bounds__(kThreads) tri_thread_kernel(StrelkaRays rays, StrelkaTris tris,
                                                              const float* __restrict__ bounds, int ngroups,
                                                              int ray_mask, int cull, long long n,
                                                              float* __restrict__ t_out, int* __restrict__ prim_out,
                                                              float* __restrict__ u_out, float* __restrict__ v_out,
                                                              unsigned char* __restrict__ occ_out) {
    extern __shared__ float smem[];
    const Tile s = tile_at(smem, tile_of(tris.count));
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
    const bool in_range = i < n;
    Ray r = {};
    r.ex = -1;
    bool live = false;
    if (in_range) {
        const float tn = rays.tmin[i], tx = rays.tmax[i];
        live = tx > tn;
        if (live) r = load_ray(rays, i, tn, tx);
    }
    float best_t = kMiss, best_u = 0.0f, best_v = 0.0f;
    int best_p = -1;
    bool occ = false;
    for (int base = 0; base < tris.count; base += s.tile) {
        const bool searching = live && !occ;
        if (!__syncthreads_or(searching)) break;  // also orders the previous tile's reads
        const int cnt = min(s.tile, tris.count - base);
        load_tile(s, tris, bounds, ngroups, base, cnt, cull);
        __syncthreads();
        if (!searching) continue;
        const int ng = (cnt + kGroup - 1) / kGroup;
        for (int gl = 0; gl < ng && !occ; ++gl) {
            const float* bx = s.box + gl;
            if (cull && slab_tnear(bx[0], bx[kTileGroups], bx[2 * kTileGroups], bx[3 * kTileGroups],
                                   bx[4 * kTileGroups], bx[5 * kTileGroups], r,
                                   kAny ? r.tx : fminf(best_t, r.tx)) == kNone)
                continue;
            const int j1 = min(cnt, (gl + 1) * kGroup);
            for (int jl = gl * kGroup; jl < j1; ++jl) {
                if ((s.mask[jl] & ray_mask) == 0) continue;  // the same for every lane
                const float* q = s.v + jl;
                const int w = s.tile;
                float t, u, v;
                const int j = base + jl;
                if (!strelka_ray_tri(q[0], q[w], q[2 * w], q[3 * w], q[4 * w], q[5 * w], q[6 * w], q[7 * w], q[8 * w],
                                     r.o0, r.o1, r.o2, r.d0, r.d1, r.d2, r.tn, r.tx, t, u, v) ||
                    j == r.ex)
                    continue;
                if (kAny) {
                    occ = true;
                    break;
                }
                if (t < best_t) {
                    best_t = t;
                    best_p = j;
                    best_u = u;
                    best_v = v;
                }
            }
        }
    }
    if (in_range) {
        if (kAny) {
            occ_out[i] = occ ? 1 : 0;
        } else {
            t_out[i] = best_t;
            prim_out[i] = best_p;
            u_out[i] = best_u;
            v_out[i] = best_v;
        }
    }
}

using WarpKernel = void (*)(StrelkaRays, StrelkaTris, const float*, int, int, int, long long, int*, float*, int*,
                            float*, float*, unsigned char*, int*);

// Blocks of a persistent launch: as many as fit on the card at once (the
// occupancy of the built kernel x the SMs, asked once per kernel and
// device), fewer where the rays are fewer.
int persistent_blocks(WarpKernel kernel, int slot, long long n, int& blocks) {
    static int cached[2][64] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
    if (!cached[slot][dev]) {
        int sms = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarpThreads, 0);
        if (e != cudaSuccess) return static_cast<int>(e);
        cached[slot][dev] = per_sm * sms;
    }
    const long long want = (n + kWarpThreads - 1) / kWarpThreads;  // a warp a batch of 32 rays
    blocks = static_cast<int>(want < cached[slot][dev] ? want : cached[slot][dev]);
    if (blocks < 1) blocks = 1;
    return 0;
}

template <bool kAny>
int launch(const void* ox, const void* oy, const void* oz, const void* dx, const void* dy, const void* dz,
           const void* tmin, const void* tmax, const void* exclude, const void* v0, const void* e1, const void* e2,
           const void* mask, const void* bounds, int ray_mask, long long n, int ntri, int ngroups, int cull,
           int schedule, void* next_ray, void* t_out, void* prim_out, void* u_out, void* v_out, void* occ_out,
           void* groups_out, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const StrelkaRays rays = strelka_make_rays(ox, oy, oz, dx, dy, dz, tmin, tmax, exclude);
    const StrelkaTris tris = strelka_make_tris(v0, e1, e2, mask, ntri);
    const float* b = static_cast<const float*>(bounds);
    if (schedule == 1) {
        tri_thread_kernel<kAny><<<strelka_blocks(n, kThreads), kThreads, tile_bytes(ntri), st>>>(
            rays, tris, b, ngroups, ray_mask, cull, n, static_cast<float*>(t_out), static_cast<int*>(prim_out),
            static_cast<float*>(u_out), static_cast<float*>(v_out), static_cast<unsigned char*>(occ_out));
        STRELKA_RETURN_LAUNCH_STATUS();
    }
    int blocks = 0;
    const int rc = persistent_blocks(tri_warp_kernel<kAny>, kAny ? 1 : 0, n, blocks);
    if (rc) return rc;
    const cudaError_t e = cudaMemsetAsync(next_ray, 0, sizeof(int), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    tri_warp_kernel<kAny><<<blocks, kWarpThreads, 0, st>>>(
        rays, tris, b, ngroups, ray_mask, cull, n, static_cast<int*>(next_ray), static_cast<float*>(t_out),
        static_cast<int*>(prim_out), static_cast<float*>(u_out), static_cast<float*>(v_out),
        static_cast<unsigned char*>(occ_out), static_cast<int*>(groups_out));
    STRELKA_RETURN_LAUNCH_STATUS();
}

}  // namespace

// Rays: 8 f32 [n] component arrays + exclude int32 [n] (or null).
// Triangles: v0/e1/e2 f32 [ntri, 3], geometry mask int32 [ntri]; group boxes
// f32 [8, ngroups] (ngroups = ceil(ntri / 32); null with cull = 0).
// schedule: 0 one ray a warp (next_ray: an int32 scratch, zeroed here before
// the launch; groups_out int32 [n] or null), 1 one ray a thread (next_ray and
// groups_out unused). Outputs: t f32, prim int32, u f32, v f32, each [n].
extern "C" int strelka_intersect_closest(const void* ox, const void* oy, const void* oz, const void* dx,
                                         const void* dy, const void* dz, const void* tmin, const void* tmax,
                                         const void* exclude, const void* v0, const void* e1, const void* e2,
                                         const void* mask, const void* bounds, int ray_mask, long long n, int ntri,
                                         int ngroups, int cull, int schedule, void* next_ray, void* t_out,
                                         void* prim_out, void* u_out, void* v_out, void* groups_out, void* stream) {
    return launch<false>(ox, oy, oz, dx, dy, dz, tmin, tmax, exclude, v0, e1, e2, mask, bounds, ray_mask, n, ntri,
                         ngroups, cull, schedule, next_ray, t_out, prim_out, u_out, v_out, nullptr, groups_out,
                         stream);
}

// Same rays, triangles and schedules; output occlusion as uint8 (torch.bool) [n].
extern "C" int strelka_intersect_any(const void* ox, const void* oy, const void* oz, const void* dx,
                                     const void* dy, const void* dz, const void* tmin, const void* tmax,
                                     const void* exclude, const void* v0, const void* e1, const void* e2,
                                     const void* mask, const void* bounds, int ray_mask, long long n, int ntri,
                                     int ngroups, int cull, int schedule, void* next_ray, void* occ_out,
                                     void* groups_out, void* stream) {
    return launch<true>(ox, oy, oz, dx, dy, dz, tmin, tmax, exclude, v0, e1, e2, mask, bounds, ray_mask, n, ntri,
                        ngroups, cull, schedule, next_ray, nullptr, nullptr, nullptr, nullptr, occ_out, groups_out,
                        stream);
}
