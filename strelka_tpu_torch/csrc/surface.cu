// Kernel K13: one bounce's surface phase less its texture lookups
// (ops/integrator.py:trace_paths, the bounce.surface phase) in one pass,
// bit-equal to its plain version kernels/surface.py:shade_surface_plain on
// the card.
//
// The TPU package leaves this phase to XLA; the plain PyTorch code runs it as
// 2,500-5,400 elementwise kernels a bounce (the refinement's Newton steps and
// the curve frame on a scene with curves), each a pass over the whole
// wavefront, after a K4 gather of all 68 columns of the hit triangle's attr
// row into a [68, N] tensor. Here one thread takes one lane and keeps
// everything in registers:
//   1. with curves, the refinement of the cone sweep's winner (its segment's
//      four control points and radii, the Newton steps of
//      ops/curve_refine.py with its count and tolerance, the sphere fallback,
//      the ghost test) on the live lanes that hit a cone, then the curve test;
//   2. the miss and its background;
//   3. the hit triangle's row read in place from the attr table (float4
//      loads of its columns 0-47; the light columns 48-67 only on a lane that
//      hit an emissive triangle): position, the octahedral normal and
//      tangent, the geometric normal, the `inside` flip, the binormal, the
//      light id and, on a textured scene, the uv and the prim's uv density;
//   4. the light hit for the lane's own light type only (its normal and pdf,
//      the balance heuristic);
//   5. the material of the row;
//   6. with curves, the curve's point, frame and material row (the material
//      table by the segment's material id) on the lanes that hit one;
//   7. on a textured scene, the texture rows (ids -1 on the curve lanes) and
//      the ray cone's path length at the hit.
// A curve lane of an untextured scene reads no triangle row: every output
// the triangle would give there is the curve's.
//
// Bound on the H100: bytes. A live lane reads about 100 bytes of its own
// state and 160-190 of its triangle's row (from L2 after the bounce sort) and
// writes about 150 (200 with the uv outputs); the refinement's ~1,000 f32
// operations on a curve lane stay under that time.
//
// One instance per (curves, refine, uv), picked from what the launch
// observes. Built with -fmad=false (bsdf.cuh lists the rules of PyTorch's
// CUDA kernels these functions follow; besides them, torch.clamp with tensor
// bounds returns a NaN of the value, then of either bound).

#include "bsdf.cuh"
#include "common.cuh"

namespace {

using namespace strelka_bsdf;

constexpr int kThreads = 128;
constexpr int kAttrCols = 68;  // a row of the joined attr table (render/device_scene.py: ATTR_JOINED)
constexpr int kMatCols = 24;   // a row of the material table
constexpr int kIters = 5;      // ops/curve_refine.py:refine_scene_curve_hit's Newton steps
constexpr double kTol = 1e-4;  // and refine_curve_hit's tolerance

// The inputs, in the order of kernels/surface.py:IN_FIELDS: each an [n] array
// (f32 unless named: prim and seg int32, the flags bool). The curve inputs
// are read by the curve instances only, t_total by the uv instances.
enum : int {
    kHitT, kPrim, kHitU, kHitV, kCurveT, kSeg, kCurveU, kOriginX, kOriginY, kOriginZ,
    kDirectionX, kDirectionY, kDirectionZ, kInside, kAlive, kSpecularBounce, kLastBsdfPdf,
    kRadianceX, kRadianceY, kRadianceZ, kThroughputX, kThroughputY, kThroughputZ, kTTotal, kInCount
};

// The outputs, in the order of kernels/surface.py:OUT_FIELDS (those from
// kTexDiffuse on written by the uv instances only)
enum : int {
    kRadianceOutX, kRadianceOutY, kRadianceOutZ, kThroughputOutX, kThroughputOutY, kThroughputOutZ,
    kPositionX, kPositionY, kPositionZ, kNormalX, kNormalY, kNormalZ, kTangentUX, kTangentUY, kTangentUZ,
    kTangentVX, kTangentVY, kTangentVZ, kGeomNormalX, kGeomNormalY, kGeomNormalZ,
    kType, kDiffuseX, kDiffuseY, kDiffuseZ, kMetallic, kRoughness, kSpecularLevel, kIor, kGlassX, kGlassY,
    kGlassZ, kOpacity, kEmissionX, kEmissionY, kEmissionZ, kThinWalled, kHitSurface, kIsCurve,
    kTexDiffuse, kTexNormal, kTexRoughness, kTexMetallic, kUvScaleU, kUvScaleV, kUvOffsetU, kUvOffsetV,
    kUvU, kUvV, kUvDensityLog2, kTHit, kOutCount
};

// The tables, in the order of kernels/surface.py:TABLE_FIELDS (the curve
// tables NULL on a scene without curves)
enum : int { kAttrTable, kMatTable, kBg, kP0, kP1, kP2, kP3, kW0, kW1, kW2, kW3, kMaterialId, kTableCount };

using SurfacePtrs = Lanes<kInCount, kOutCount>;

struct Tables {
    const float* attr;  // [attr_rows, 68]
    const float* mat;   // [mat_rows, 24]
    const float* bg;    // [3]
    const float* p[4];  // [segments, 3] control points
    const float* w[4];  // [segments] radii
    const int* material_id;
    int attr_rows, mat_rows;
};

__device__ __forceinline__ float length(F3 a) { return sqrtf(dot(a, a)); }

// torch.clamp(v, lo, hi) with tensor bounds: a NaN of v, then of lo, then of hi, else min(max)
__device__ __forceinline__ float clamp_t(float v, float lo, float hi) {
    return isnan(v) ? v : isnan(lo) ? lo : isnan(hi) ? hi : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float div6(float v) { return div_scalar(v, 6.0); }

// ops/vec.py:normalize with its eps
__device__ __forceinline__ F3 normalize_eps(F3 a, float eps) { return a * recip(clamp_min(length(a), eps)); }

// kernels/surface.py:oct_decode24
__device__ __forceinline__ F3 oct_decode24(float code) {
    const float qu = floorf(code * SB_F(1.0 / 4096.0));
    const float qv = code - qu * 4096.0f;
    const float u = qu * SB_F(2.0 / 4094.0) - 1.0f;
    const float v = qv * SB_F(2.0 / 4094.0) - 1.0f;
    const float z = 1.0f - fabsf(u) - fabsf(v);
    const float t = clamp_min(-z, 0.0f);
    return normalize({u + (u >= 0.0f ? -t : t), v + (v >= 0.0f ? -t : t), z});
}

// --- the refinement (ops/curve_refine.py)

// power-basis coefficients of a uniform cubic B-spline (_bspline_coeffs)
struct Cubic {
    float c0, c1, c2, c3;
};

__device__ __forceinline__ Cubic bspline_coeffs(float q0, float q1, float q2, float q3) {
    return {div6(q0 + q1 * 4.0f + q2), (q2 - q0) * 0.5f, (q0 - q1 * 2.0f + q2) * 0.5f,
            div6(q3 - q0) + (q1 - q2) * 0.5f};
}

__device__ __forceinline__ float cubic_at(const Cubic& c, float u, float u2, float u3) {
    return c.c0 + c.c1 * u + c.c2 * u2 + c.c3 * u3;
}
__device__ __forceinline__ float cubic_d1(const Cubic& c, float u, float u2) {
    return c.c1 + c.c2 * 2.0f * u + c.c3 * 3.0f * u2;
}
__device__ __forceinline__ float cubic_d2(const Cubic& c, float u) { return c.c2 * 2.0f + c.c3 * 6.0f * u; }

// refine_scene_curve_hit and the integrator's keep rule for one lane whose
// sweep hit segment `seg` at (t, u): t, seg and u become the refined hit, or
// a miss (1e30, -1, 0) where the hit is a ghost of the inflated radii
__device__ __forceinline__ void refine(const Tables& tb, F3 o, F3 d, float& t_io, int& seg_io, float& u_io) {
    const long long s = seg_io;
    Cubic cs[3];
    float q[4][3];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int a = 0; a < 3; ++a) q[j][a] = __ldg(tb.p[j] + s * 3 + a);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) cs[a] = bspline_coeffs(q[0][a], q[1][a], q[2][a], q[3][a]);
    const Cubic rc = bspline_coeffs(__ldg(tb.w[0] + s), __ldg(tb.w[1] + s), __ldg(tb.w[2] + s), __ldg(tb.w[3] + s));
    const float ov[3] = {o.x, o.y, o.z};
    const float dv[3] = {d.x, d.y, d.z};
    const float t0 = t_io, u0 = u_io;
    float t = t0, u = clamp(u0, 0.0f, 1.0f);
    const float lo = fabsf(t0) * -0.5f - SB_F(1e-3);
    const float hi = fabsf(t0) * 0.5f + SB_F(1e-3);
#pragma unroll 1
    for (int it = 0; it < kIters; ++it) {
        const float u2 = u * u, u3 = u2 * u;
        float w[3], c1[3], c2[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            w[a] = ov[a] + t * dv[a] - cubic_at(cs[a], u, u2, u3);
            c1[a] = cubic_d1(cs[a], u, u2);
            c2[a] = cubic_d2(cs[a], u);
        }
        const float r = cubic_at(rc, u, u2, u3), dr = cubic_d1(rc, u, u2), d2r = cubic_d2(rc, u);
        const float w_dot_w = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
        const float w_dot_d = w[0] * dv[0] + w[1] * dv[1] + w[2] * dv[2];
        const float w_dot_c1 = w[0] * c1[0] + w[1] * c1[1] + w[2] * c1[2];
        const float w_dot_c2 = w[0] * c2[0] + w[1] * c2[1] + w[2] * c2[2];
        const float d_dot_c1 = dv[0] * c1[0] + dv[1] * c1[1] + dv[2] * c1[2];
        const float c1_dot_c1 = c1[0] * c1[0] + c1[1] * c1[1] + c1[2] * c1[2];
        const float F = w_dot_w - r * r;
        const float G = w_dot_c1 + r * dr;
        const float Ft = w_dot_d * 2.0f;
        const float Fu = w_dot_c1 * -2.0f - r * 2.0f * dr;
        const float Gt = d_dot_c1;
        const float Gu = -c1_dot_c1 + w_dot_c2 + dr * dr + r * d2r;
        const float det = Ft * Gu - Fu * Gt;
        const float inv = fabsf(det) > SB_F(1e-12) ? recip(det) : 0.0f;
        const float dt = clamp_t((F * Gu - G * Fu) * inv, lo, hi);
        const float du = clamp((Ft * G - Gt * F) * inv, SB_F(-0.25), SB_F(0.25));
        t = t - dt;
        u = clamp(u - du, 0.0f, 1.0f);
    }
    // the residual at the final u, and the exact sphere test there
    const float u2 = u * u, u3 = u2 * u;
    float w[3], wo[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        const float pos = cubic_at(cs[a], u, u2, u3);
        w[a] = ov[a] + t * dv[a] - pos;
        wo[a] = ov[a] - pos;
    }
    const float r = cubic_at(rc, u, u2, u3);
    const float F = w[0] * w[0] + w[1] * w[1] + w[2] * w[2] - r * r;
    const float rel = fabsf(F) / clamp_min(r * r, SB_F(1e-12));
    const bool converged = (rel < SB_F(kTol)) & (t > 0.0f) & isfinite(t);
    const float b = wo[0] * dv[0] + wo[1] * dv[1] + wo[2] * dv[2];
    const float cq = wo[0] * wo[0] + wo[1] * wo[1] + wo[2] * wo[2] - r * r;
    const float disc = b * b - cq;
    const float t_sphere = -b - sqrtf(clamp_min(disc, 0.0f));
    const bool sphere_hit = (disc >= 0.0f) & (t_sphere > 0.0f) & isfinite(t_sphere);
    const bool graze = !converged & sphere_hit;
    if (converged | graze) {
        t_io = converged ? t : t_sphere;
        u_io = u;
    } else {  // a ghost: the integrator's miss
        t_io = SB_F(1e30);
        seg_io = -1;
        u_io = 0.0f;
    }
}

// --- the curve's frame (ops/curves.py:curve_shading_frame_vec) and its
// material: the curve lanes' frame, written over the triangle's

__device__ __forceinline__ void curve_frame(const Tables& tb, int seg, float u, F3 hit_position, float flip,
                                            Frame& fr) {
    const long long s = seg;  // >= 0 on a curve lane
    const float u2 = u * u, u3 = u2 * u;
    const float b[4] = {div6(1.0f - u * 3.0f + u2 * 3.0f - u3), div6(4.0f - u2 * 6.0f + u3 * 3.0f),
                        div6(1.0f + u * 3.0f + u2 * 3.0f - u3 * 3.0f), div6(u3)};
    const float db[4] = {div6(-3.0f + u * 6.0f - u2 * 3.0f), div6(u * -12.0f + u2 * 9.0f),
                         div6(3.0f + u * 6.0f - u2 * 9.0f), div6(u2 * 3.0f)};
    F3 spine, tan;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const F3 pj = {__ldg(tb.p[j] + s * 3), __ldg(tb.p[j] + s * 3 + 1), __ldg(tb.p[j] + s * 3 + 2)};
        spine = j == 0 ? pj * b[0] : spine + pj * b[j];
        tan = j == 0 ? pj * db[0] : tan + pj * db[j];
    }
    const F3 tangent = normalize_eps(tan, SB_F(1e-12));
    F3 nv = hit_position - spine;
    nv = nv - tangent * dot(nv, tangent);
    const float norm = length(nv);
    nv = norm > SB_F(1e-9) ? nv * recip(clamp_min(norm, SB_F(1e-9))) : F3{0.0f, 0.0f, 1.0f};
    const F3 cn = nv * flip;
    fr.normal = cn;
    fr.tangent_u = tangent;
    fr.tangent_v = cross(cn, tangent);
    fr.geom_normal = cn;
}

// --- the light hit (ops/light_sampling.py: calc_light_normal, get_light_pdf)

// The light at a hit on an emissive triangle: columns 48-67 of its row (the
// row's float4 12-16)
struct HitLight {
    F3 p0, p1, p3, color, normal;
    int type;
};

__device__ __forceinline__ HitLight load_hit_light(const float4* row) {
    const float4 a = __ldg(row + 12), b = __ldg(row + 13), c = __ldg(row + 14), d = __ldg(row + 15),
                 e = __ldg(row + 16);
    HitLight l;
    l.p0 = {a.x, a.y, a.z};
    l.p1 = {a.w, b.x, b.y};
    l.p3 = {c.y, c.z, c.w};
    l.color = {d.x, d.y, d.z};
    l.normal = {d.w, e.x, e.y};
    l.type = static_cast<int>(e.z);  // .to(torch.int32)
    return l;
}

// __closesthit__light for the lane's own light type: the radiance it adds
// (the lane's throughput is zeroed after it). A distant light, and any other
// type, has a zero normal at a hit and adds nothing.
__device__ __forceinline__ F3 light_hit(const HitLight& l, F3 origin, F3 direction, float hit_t, float lbp,
                                        bool direct_vis, float inv_num, F3 radiance, F3 throughput) {
    if (l.type < 0 || l.type > 2) return radiance;
    const F3 hit_point = origin + direction * hit_t;
    F3 light_n;
    float pdf = 0.0f;  // get_light_pdf: 0 for a disc
    if (l.type == 0) {  // a rect: the uniform area pdf (the reference's quirk)
        const F3 c = cross(l.p1 - l.p0, l.p3 - l.p0);
        light_n = -normalize(c);
        const float area = length(c);
        const F3 to_light = hit_point - origin;
        const float dist = length(to_light);
        const F3 L = to_light * recip(clamp_min(dist, SB_F(1e-20)));
        pdf = dist * dist / (dot(-L, light_n) * area);
    } else if (l.type == 1) {
        light_n = l.normal;
    } else {  // a sphere: the visible cap
        light_n = normalize(hit_point - l.p1);
        const float radius = l.p0.x;
        const float dc = length(l.p1 - origin);
        const float sin_a = clamp(radius / clamp_min(dc, SB_F(1e-20)), 0.0f, 1.0f);
        const float cos_a = sqrtf(clamp_min(1.0f - sin_a * sin_a, 0.0f));
        const float one_minus_cos = sin_a * sin_a / (1.0f + cos_a);
        pdf = dc > radius ? recip(SB_F(2.0 * kPi) * clamp_min(one_minus_cos, SB_F(1e-12))) : 0.0f;
    }
    const float cos_l = -dot(direction, light_n);
    const float light_pdf_hit = pdf * inv_num;
    const float mis_w = recip(1.0f + light_pdf_hit / lbp);  // mis_weight_balance
    const float w = cos_l * (direct_vis ? 1.0f : mis_w);
    return cos_l > 0.0f ? radiance + throughput * l.color * w : radiance;
}

template <bool kCurves, bool kRefine, bool kUv>
__global__ void __launch_bounds__(kThreads) shade_surface_kernel(const SurfacePtrs p, const Tables tb, long long n,
                                                                 int num_lights, bool bounced, float inv_num) {
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= n) return;
    const bool alive = p.ld<bool>(kAlive, i);
    const float hit_t = p.ld<float>(kHitT, i);
    const int prim = p.ld<int>(kPrim, i);
    const float flip = p.ld<bool>(kInside, i) ? -1.0f : 1.0f;
    F3 origin = splat(0.0f), direction = splat(0.0f);
    bool have_ray = false;
    const auto ray = [&]() {
        if (!have_ray) {
            origin = p.ld3(kOriginX, i);
            direction = p.ld3(kDirectionX, i);
            have_ray = true;
        }
    };

    // 1. the curve test, after the refinement
    bool is_curve = false;
    int seg = -1;
    float ct = 0.0f, cu = 0.0f;
    if constexpr (kCurves) {
        if (alive) {
            seg = p.ld<int>(kSeg, i);
            if (seg >= 0) {
                ct = p.ld<float>(kCurveT, i);
                cu = p.ld<float>(kCurveU, i);
                if constexpr (kRefine) {
                    ray();
                    refine(tb, origin, direction, ct, seg, cu);
                }
                is_curve = (seg >= 0) & (ct < hit_t);
            }
        }
    }

    // 2. the miss (__miss__ms)
    const bool missed = alive & (prim < 0) & !is_curve;
    F3 radiance = p.ld3(kRadianceX, i);
    F3 throughput = p.ld3(kThroughputX, i);
    if (missed) {
        const F3 bg = {__ldg(tb.bg), __ldg(tb.bg + 1), __ldg(tb.bg + 2)};
        radiance = radiance + throughput * bg;
        throughput = splat(0.0f);
    }

    // 3-5. the triangle's row: its attributes, the light hit, its material
    F3 position = splat(0.0f);
    Frame fr = {splat(0.0f), splat(0.0f), splat(0.0f), splat(0.0f)};
    Material m = {};
    float opacity = 0.0f;
    F3 emission = splat(0.0f);
    bool hit_light = false;
    if (kUv || !is_curve) {
        const int row_id = min(max(prim, 0), tb.attr_rows - 1);
        const float4* row = reinterpret_cast<const float4*>(tb.attr + static_cast<long long>(row_id) * kAttrCols);
        const float wu = p.ld<float>(kHitU, i), wv = p.ld<float>(kHitV, i);
        const float w0 = 1.0f - wu - wv;
        const float4 r0 = __ldg(row), r1 = __ldg(row + 1), r2 = __ldg(row + 2), r3 = __ldg(row + 3);
        const float4 r5 = __ldg(row + 5);
        const F3 v0 = {r0.x, r0.y, r0.z}, e1 = {r0.w, r1.x, r1.y}, e2 = {r1.z, r1.w, r2.x};
        position = v0 + e1 * wu + e2 * wv;
        const F3 normal = normalize(oct_decode24(r2.y) * w0 + oct_decode24(r2.z) * wu + oct_decode24(r2.w) * wv);
        const F3 tangent = normalize(oct_decode24(r3.x) * w0 + oct_decode24(r3.y) * wu + oct_decode24(r3.z) * wv);
        const F3 gcross = cross(e1, e2);
        if constexpr (kUv) {
            const float4 r4 = __ldg(row + 4);
            const float uv[6] = {r3.w, r4.x, r4.y, r4.z, r4.w, r5.x};  // columns 15-20
            p.st(kUvU, i, uv[0] * w0 + uv[2] * wu + uv[4] * wv);
            p.st(kUvV, i, uv[1] * w0 + uv[3] * wu + uv[5] * wv);
            const float uv_area2 = fabsf((uv[2] - uv[0]) * (uv[5] - uv[1]) - (uv[4] - uv[0]) * (uv[3] - uv[1]));
            const float world_area2 = length(gcross);
            p.st(kUvDensityLog2, i, (log2f(clamp_min(uv_area2, SB_F(1e-20))) -
                                     log2f(clamp_min(world_area2, SB_F(1e-20)))) * 0.5f);
        }
        fr.normal = normal * flip;
        fr.tangent_u = tangent;
        fr.tangent_v = cross(fr.normal, tangent);
        fr.geom_normal = normalize(gcross) * flip;
        const int light_id = prim >= 0 ? static_cast<int>(r5.z) : -1;  // column 22
        hit_light = alive & !missed & (light_id >= 0) & !is_curve;
        if (hit_light) {  // __closesthit__light
            if (num_lights > 0) {
                ray();
                const float lbp = clamp_min(p.ld<float>(kLastBsdfPdf, i), SB_F(1e-20));
                const bool direct_vis = !bounced || p.ld<bool>(kSpecularBounce, i);
                radiance = light_hit(load_hit_light(row), origin, direction, hit_t, lbp, direct_vis, inv_num, radiance,
                                     throughput);
            }
            throughput = splat(0.0f);
        }
        // the material: columns 24-47 (the row's float4 6-11)
        const float4 m0 = __ldg(row + 6), m1 = __ldg(row + 7), m2 = __ldg(row + 8), m5 = __ldg(row + 11);
        m.type = static_cast<int>(m0.x);
        m.diffuse = {m0.y, m0.z, m0.w};
        m.metallic = m1.x;
        m.roughness = m1.y;
        m.specular_level = m1.z;
        m.ior = m1.w;
        m.glass = {m2.x, m2.y, m2.z};
        opacity = m2.w;
        emission = {m5.x, m5.y, m5.z};
        m.thin_walled = m5.w > 0.5f;
        if constexpr (kUv) {
            const float4 m3 = __ldg(row + 9), m4 = __ldg(row + 10);
            p.st(kTexDiffuse, i, is_curve ? -1.0f : m3.x);
            p.st(kTexNormal, i, is_curve ? -1.0f : m3.y);
            p.st(kTexRoughness, i, is_curve ? -1.0f : m3.z);
            p.st(kTexMetallic, i, is_curve ? -1.0f : m3.w);
            p.st(kUvScaleU, i, m4.x);
            p.st(kUvScaleV, i, m4.y);
            p.st(kUvOffsetU, i, m4.z);
            p.st(kUvOffsetV, i, m4.w);
        }
    }

    // 6. the curve's point, frame and material (fillCurveGeomData)
    if (is_curve) {
        ray();
        position = origin + direction * ct;
        curve_frame(tb, seg, cu, position, flip, fr);
        const int mid = min(max(__ldg(tb.material_id + seg), 0), tb.mat_rows - 1);
        const float* row = tb.mat + static_cast<long long>(mid) * kMatCols;
        m.type = static_cast<int>(__ldg(row));
        m.diffuse = {__ldg(row + 1), __ldg(row + 2), __ldg(row + 3)};
        m.metallic = __ldg(row + 4);
        m.roughness = __ldg(row + 5);
        m.specular_level = __ldg(row + 6);
        m.ior = __ldg(row + 7);
        m.glass = {__ldg(row + 8), __ldg(row + 9), __ldg(row + 10)};
        opacity = __ldg(row + 11);
        emission = {__ldg(row + 20), __ldg(row + 21), __ldg(row + 22)};
        m.thin_walled = __ldg(row + 23) > 0.5f;
    }

    // 7. the ray cone's path length at the hit (a curve hit by its cone t)
    if constexpr (kUv) {
        p.st(kTHit, i, p.ld<float>(kTTotal, i) + (alive & !missed ? (is_curve ? ct : hit_t) : 0.0f));
    }
    p.st3(kRadianceOutX, i, radiance);
    p.st3(kThroughputOutX, i, throughput);
    p.st3(kPositionX, i, position);
    p.st3(kNormalX, i, fr.normal);
    p.st3(kTangentUX, i, fr.tangent_u);
    p.st3(kTangentVX, i, fr.tangent_v);
    p.st3(kGeomNormalX, i, fr.geom_normal);
    p.st(kType, i, m.type);
    p.st3(kDiffuseX, i, m.diffuse);
    p.st(kMetallic, i, m.metallic);
    p.st(kRoughness, i, m.roughness);
    p.st(kSpecularLevel, i, m.specular_level);
    p.st(kIor, i, m.ior);
    p.st3(kGlassX, i, m.glass);
    p.st(kOpacity, i, opacity);
    p.st3(kEmissionX, i, emission);
    p.st(kThinWalled, i, m.thin_walled);
    const bool hit_surface = alive & !missed & !hit_light;
    p.st(kHitSurface, i, hit_surface);
    p.st(kIsCurve, i, is_curve);
}

template <bool kCurves, bool kRefine, bool kUv>
void launch(const SurfacePtrs& p, const Tables& tb, long long n, int num_lights, bool bounced, float inv_num,
            cudaStream_t s) {
    shade_surface_kernel<kCurves, kRefine, kUv>
        <<<strelka_blocks(n, kThreads), kThreads, 0, s>>>(p, tb, n, num_lights, bounced, inv_num);
}

}  // namespace

// in: kInCount device pointers, out: kOutCount, tables: kTableCount (host
// arrays, the orders above; NULL where the instance reads or writes none);
// the tables' rows; n; the scene's light count; the bounce (0 or more);
// the instance: curves, refine (with curves only), uv.
extern "C" int strelka_shade_surface(const void* const* in, void* const* out, const void* const* tables, int attr_rows,
                                     int mat_rows, int segments, long long n, int num_lights, int depth, int curves,
                                     int refine, int uv, void* stream) {
    if (n < 1 || attr_rows < 1 || mat_rows < 1 || num_lights < 0 || depth < 0 || (curves && segments < 1) ||
        (refine && !curves))
        return static_cast<int>(cudaErrorInvalidValue);
    const SurfacePtrs p = make_lanes<kInCount, kOutCount>(in, out);
    Tables tb;
    tb.attr = static_cast<const float*>(tables[kAttrTable]);
    tb.mat = static_cast<const float*>(tables[kMatTable]);
    tb.bg = static_cast<const float*>(tables[kBg]);
    for (int j = 0; j < 4; ++j) {
        tb.p[j] = static_cast<const float*>(tables[kP0 + j]);
        tb.w[j] = static_cast<const float*>(tables[kW0 + j]);
    }
    tb.material_id = static_cast<const int*>(tables[kMaterialId]);
    tb.attr_rows = attr_rows;
    tb.mat_rows = mat_rows;
    // get_light_pdf(...) / num_lights: the product with the f32 reciprocal of the cast count
    const float inv_num = num_lights > 0 ? 1.0f / static_cast<float>(num_lights) : 0.0f;
    const bool bounced = depth > 0;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (curves && refine)
        uv ? launch<true, true, true>(p, tb, n, num_lights, bounced, inv_num, s)
           : launch<true, true, false>(p, tb, n, num_lights, bounced, inv_num, s);
    else if (curves)
        uv ? launch<true, false, true>(p, tb, n, num_lights, bounced, inv_num, s)
           : launch<true, false, false>(p, tb, n, num_lights, bounced, inv_num, s);
    else
        uv ? launch<false, false, true>(p, tb, n, num_lights, bounced, inv_num, s)
           : launch<false, false, false>(p, tb, n, num_lights, bounced, inv_num, s);
    STRELKA_RETURN_LAUNCH_STATUS();
}
