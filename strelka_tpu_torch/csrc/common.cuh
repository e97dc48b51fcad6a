// Shared helpers of the port's CUDA kernels (plain C interface, bound with
// ctypes from strelka_tpu_torch/kernels/build.py).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Every C entry ends with this: a launch the CUDA runtime refused (too many
// threads, too much shared memory) never runs, and only this reports it.
#define STRELKA_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())

static inline unsigned int strelka_blocks(long long n, int threads) {
    return static_cast<unsigned int>((n + threads - 1) / threads);
}

// A wavefront of rays as component arrays, each [n].
struct StrelkaRays {
    const float *ox, *oy, *oz, *dx, *dy, *dz, *tmin, *tmax;
    const int* exclude;  // may be null
};

static inline StrelkaRays strelka_make_rays(const void* ox, const void* oy, const void* oz, const void* dx,
                                            const void* dy, const void* dz, const void* tmin,
                                            const void* tmax, const void* exclude) {
    StrelkaRays r;
    r.ox = static_cast<const float*>(ox);
    r.oy = static_cast<const float*>(oy);
    r.oz = static_cast<const float*>(oz);
    r.dx = static_cast<const float*>(dx);
    r.dy = static_cast<const float*>(dy);
    r.dz = static_cast<const float*>(dz);
    r.tmin = static_cast<const float*>(tmin);
    r.tmax = static_cast<const float*>(tmax);
    r.exclude = static_cast<const int*>(exclude);
    return r;
}

// The scene's triangles: v0 and the edges e1, e2, each [count, 3], and the
// geometry mask [count].
struct StrelkaTris {
    const float* v0;
    const float* e1;
    const float* e2;
    const int* mask;
    int count;
};

static inline StrelkaTris strelka_make_tris(const void* v0, const void* e1, const void* e2, const void* mask,
                                            int count) {
    StrelkaTris t;
    t.v0 = static_cast<const float*>(v0);
    t.e1 = static_cast<const float*>(e1);
    t.e2 = static_cast<const float*>(e2);
    t.mask = static_cast<const int*>(mask);
    t.count = count;
    return t;
}

#ifdef __CUDACC__
// Möller–Trumbore of one ray against one triangle (v0 and the edges e1, e2),
// in the operation order of strelka_tpu/ops/intersect.py:_ray_tri_block and
// ops/bvh.py:_tri_test. The sources that call it are built with -fmad=false,
// so every product and sum rounds on its own, as on the CPU reference.
__device__ __forceinline__ bool strelka_ray_tri(float v0x, float v0y, float v0z, float e1x, float e1y,
                                                float e1z, float e2x, float e2y, float e2z, float o0,
                                                float o1, float o2, float d0, float d1, float d2, float tn,
                                                float tx, float& t, float& u, float& v) {
    // pvec = cross(d, e2)
    const float p0 = d1 * e2z - d2 * e2y;
    const float p1 = d2 * e2x - d0 * e2z;
    const float p2 = d0 * e2y - d1 * e2x;
    const float det = e1x * p0 + e1y * p1 + e1z * p2;
    const bool det_ok = fabsf(det) > 1e-12f;
    const float inv_det = det_ok ? 1.0f / det : 0.0f;
    const float tv0 = o0 - v0x, tv1 = o1 - v0y, tv2 = o2 - v0z;
    u = (tv0 * p0 + tv1 * p1 + tv2 * p2) * inv_det;
    // qvec = cross(tv, e1)
    const float q0 = tv1 * e1z - tv2 * e1y;
    const float q1 = tv2 * e1x - tv0 * e1z;
    const float q2 = tv0 * e1y - tv1 * e1x;
    v = (d0 * q0 + d1 * q1 + d2 * q2) * inv_det;
    t = (e2x * q0 + e2y * q1 + e2z * q2) * inv_det;
    return det_ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tn && t < tx;
}

// The port's one ray-box test (plain twin: strelka_tpu_torch/ops/slab.py:
// slab_tnear, the same operations in the same order). The reference's slab
// test with a margin that keeps every hit strelka_ray_tri accepts at a
// normalised determinant >= 0.077 (PERF.md section 6, "The margin,
// derived"): the box padded by kStrelkaPad * (|o|_inf + |box|_inf) on
// every side, and tnear lowered by kStrelkaSlack * |tnear| before it is
// compared with tfar (the interval's end, min(best t, tmax) in a walk). inv: 1 / (|d| > 1e-20 ? d : 1e-20) per
// axis; om = |o|_inf; bm = strelka_box_scale of the box. Returns the lowered
// tnear, or INFINITY where the interval does not enter the padded box. The
// caller rejects inverted boxes (lo > hi).
constexpr float kStrelkaPad = 0x1p-13f;
constexpr float kStrelkaSlack = 0x1p-20f;

__device__ __forceinline__ float strelka_box_scale(float lx, float ly, float lz, float hx, float hy, float hz) {
    return fmaxf(fmaxf(fmaxf(fabsf(lx), fabsf(ly)), fmaxf(fabsf(lz), fabsf(hx))), fmaxf(fabsf(hy), fabsf(hz)));
}

// The same test with the pad p given (kernels/cones: the closed form's reach).
__device__ __forceinline__ float strelka_slab_padded(float lx, float ly, float lz, float hx, float hy, float hz,
                                                     float p, float o0, float o1, float o2, float inv0, float inv1,
                                                     float inv2, float tn, float tfar) {
    const float x0 = ((lx - p) - o0) * inv0, x1 = ((hx + p) - o0) * inv0;
    const float y0 = ((ly - p) - o1) * inv1, y1 = ((hy + p) - o1) * inv1;
    const float z0 = ((lz - p) - o2) * inv2, z1 = ((hz + p) - o2) * inv2;
    float tnear = fmaxf(fmaxf(fmaxf(tn, fminf(x0, x1)), fminf(y0, y1)), fminf(z0, z1));
    tfar = fminf(fminf(fminf(tfar, fmaxf(x0, x1)), fmaxf(y0, y1)), fmaxf(z0, z1));
    tnear = tnear - fabsf(tnear) * kStrelkaSlack;
    return tnear <= tfar ? tnear : INFINITY;
}

__device__ __forceinline__ float strelka_slab_safe(float lx, float ly, float lz, float hx, float hy, float hz,
                                                   float bm, float o0, float o1, float o2, float inv0, float inv1,
                                                   float inv2, float om, float tn, float tfar) {
    return strelka_slab_padded(lx, ly, lz, hx, hy, hz, (om + bm) * kStrelkaPad, o0, o1, o2, inv0, inv1, inv2, tn,
                               tfar);
}
#endif
