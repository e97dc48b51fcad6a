// Kernels K11 and K12: one bounce's next-event estimation less its shadow
// sweep (ops/integrator.py:trace_paths, the bounce.nee phase), as two passes
// around the sweep, bit-equal to their plain versions kernels/nee.py:
// nee_light_plain and nee_shade_plain on the card.
//
// The TPU package leaves this phase to XLA; the plain PyTorch code runs it as
// about 780 elementwise kernels a bounce (1,560 with the fibre lobes), every
// light type's sample and every material type's evaluation on every lane.
// Here one thread takes one lane and keeps everything in registers:
//
//   K11 nee_light, before the sweep: the lane's light (its row of the light
//   table, through the read-only cache), the sample of that light's type
//   only (ops/light_sampling.py: the rect light uniformly or by its spherical
//   quad, the sphere's visible cap, the distant light's cone; a disc has pdf
//   0), the shadow ray (offset_ray), the masks and the light pdf. It samples
//   every lane, as the plain code does, so the sweep reads the rays it reads
//   today on every lane.
//   K12 nee_shade, after the sweep: visibility, bsdf_evaluate for the lane's
//   own material type (bsdf.cuh), the balance heuristic, the radiance and the
//   two NaN canaries. A lane that is not nee_able keeps its state, as the
//   plain masks leave it.
//
// Bound on the H100: bytes. K11 reads about 60 bytes a lane and writes 42;
// K12 reads about 130 on a nee_able lane (26 on the others) and writes 25.
//
// K11 has one instance per rect light sampling method, K12 one per fibre
// variant (none, Chiang, Kajiya-Kay), as K10. Built with -fmad=false (bsdf.cuh
// lists the rules of PyTorch's CUDA kernels these functions follow; besides
// them, torch.minimum / maximum return a NaN of either operand).

#include "bsdf.cuh"
#include "common.cuh"

namespace {

using namespace strelka_bsdf;

constexpr int kThreads = 128;
constexpr int kLightCols = 20;  // a light_table row (render/device_scene.py:_light_table)

namespace k11 {
// The inputs, in the order of kernels/nee.py:LIGHT_IN_FIELDS: each an [n]
// array (f32 unless named: event_type and prim int32, the flags bool)
enum : int {
    kShade, kEventType, kULight, kUX, kUY, kPositionX, kPositionY, kPositionZ, kNormalX, kNormalY, kNormalZ,
    kGeomNormalX, kGeomNormalY, kGeomNormalZ, kIsCurve, kPrim, kInCount
};

// The outputs, in the order of kernels/nee.py:LIGHT_OUT_FIELDS
enum : int {
    kOrgX, kOrgY, kOrgZ, kToLightX, kToLightY, kToLightZ, kDist, kExclude, kActive, kNeeAble, kLightPdf, kLightId,
    kOutCount
};
}  // namespace k11

namespace k12 {
// The inputs, in the order of kernels/nee.py:SHADE_IN_FIELDS
enum : int {
    kOccluded, kActive, kNeeAble, kLightPdf, kLightId, kToLightX, kToLightY, kToLightZ, kInside,
    kType, kDiffuseX, kDiffuseY, kDiffuseZ, kMetallic, kRoughness, kSpecularLevel, kIor,
    kNormalX, kNormalY, kNormalZ, kTangentUX, kTangentUY, kTangentUZ, kTangentVX, kTangentVY, kTangentVZ,
    kDirectionX, kDirectionY, kDirectionZ, kRadianceX, kRadianceY, kRadianceZ, kThroughputX, kThroughputY,
    kThroughputZ, kShade, kInCount
};

// The outputs, in the order of kernels/nee.py:SHADE_OUT_FIELDS
enum : int {
    kRadianceOutX, kRadianceOutY, kRadianceOutZ, kThroughputOutX, kThroughputOutY, kThroughputOutZ, kShadeOut,
    kOutCount
};
}  // namespace k12

using LightPtrs = Lanes<k11::kInCount, k11::kOutCount>;
using NeeShadePtrs = Lanes<k12::kInCount, k12::kOutCount>;

// light types (ops/light_sampling.py) and rect light sampling methods
constexpr int kRect = 0, kSphere = 2, kDistant = 3;
constexpr int kUniform = 0, kSphQuad = 1;

// torch.maximum / torch.minimum: a NaN of either operand, the first's first
__device__ __forceinline__ float nan_max(float a, float b) { return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b); }
__device__ __forceinline__ float nan_min(float a, float b) { return isnan(a) ? a : isnan(b) ? b : fminf(a, b); }

__device__ __forceinline__ float length(F3 a) { return sqrtf(dot(a, a)); }

// a row of the [rows, 20] light table (ops/light_sampling.py:light_rows, the
// id clamped to the table)
__device__ __forceinline__ const float* light_row(const float* table, int rows, int id) {
    return table + static_cast<long long>(min(max(id, 0), rows - 1)) * kLightCols;
}

__device__ __forceinline__ F3 ld3g(const float* row, int col) {
    return {__ldg(row + col), __ldg(row + col + 1), __ldg(row + col + 2)};
}

// ops/light_sampling.py:LightParams
struct Light {
    F3 p0, p1, p3, color, normal;
    int type;
    float half_angle, radius;
};

__device__ __forceinline__ Light load_light(const float* row) {
    Light l;
    l.p0 = ld3g(row, 0);
    l.p1 = ld3g(row, 3);
    l.p3 = ld3g(row, 9);
    l.color = ld3g(row, 12);
    l.normal = ld3g(row, 15);
    l.type = static_cast<int>(__ldg(row + 18));  // .to(torch.int32)
    l.half_angle = __ldg(row + 19);
    l.radius = l.p0.x;
    return l;
}

// ops/light_sampling.py:LightSampleData, the fields NEE reads
struct LightSample {
    F3 L, normal;
    float pdf, dist;
};

// _fill_light_data's direction and distance to a point on the light
__device__ __forceinline__ void toward(F3 hit_point, F3 point_on_light, F3& L, float& dist) {
    const F3 to_light = point_on_light - hit_point;
    dist = length(to_light);
    L = to_light * recip(clamp_min(dist, SB_F(1e-20)));
}

// sample_rect_light_uniform
__device__ __forceinline__ LightSample rect_uniform(const Light& l, float u, float v, F3 hit_point) {
    const F3 e1 = l.p1 - l.p0;
    const F3 e2 = l.p3 - l.p0;
    const F3 pol = l.p0 + e1 * u + e2 * v;
    const F3 c = cross(e1, e2);
    const float area = length(c);
    LightSample s;
    s.normal = -normalize(c);
    toward(hit_point, pol, s.L, s.dist);
    s.pdf = s.dist * s.dist / (-dot(s.L, s.normal) * area);
    return s;
}

// sph_quad_init and sph_quad_sample (Urena's spherical rectangle) -> the
// sampled point; S (the solid angle) through the reference
__device__ __forceinline__ F3 sph_quad_point(const Light& l, F3 o, float u, float v, float& S) {
    const F3 ex = l.p1 - l.p0;
    const F3 ey = l.p3 - l.p0;
    const float exl = length(ex);
    const float eyl = length(ey);
    const F3 x = ex * recip(clamp_min(exl, SB_F(1e-20)));
    const F3 y = ey * recip(clamp_min(eyl, SB_F(1e-20)));
    F3 z = cross(x, y);
    const F3 d = l.p0 - o;
    float z0 = dot(d, z);
    if (z0 > 0.0f) {
        z = -z;
        z0 = -z0;
    }
    const float x0 = dot(d, x);
    const float y0 = dot(d, y);
    const float x1 = x0 + exl;
    const float y1 = y0 + eyl;
    const F3 v00 = {x0, y0, z0}, v01 = {x0, y1, z0}, v10 = {x1, y0, z0}, v11 = {x1, y1, z0};
    const F3 n0 = normalize(cross(v00, v10));
    const F3 n1 = normalize(cross(v10, v11));
    const F3 n2 = normalize(cross(v11, v01));
    const F3 n3 = normalize(cross(v01, v00));
    const float g0 = acosf(clamp(-dot(n0, n1), -1.0f, 1.0f));
    const float g1 = acosf(clamp(-dot(n1, n2), -1.0f, 1.0f));
    const float g2 = acosf(clamp(-dot(n2, n3), -1.0f, 1.0f));
    const float g3 = acosf(clamp(-dot(n3, n0), -1.0f, 1.0f));
    const float b0 = n0.z;
    const float b1 = n2.z;
    const float k = SB_F(2.0 * kPi) - g2 - g3;
    S = g0 + g1 - k;
    // sph_quad_sample
    const float au = u * S + k;
    const float sin_au = sinf(au);
    const float fu = (cosf(au) * b0 - b1) / (fabsf(sin_au) > SB_F(1e-20) ? sin_au : SB_F(1e-20));
    float cu = recip(sqrtf(fu * fu + b0 * b0)) * (fu > 0.0f ? 1.0f : -1.0f);
    cu = clamp(cu, -1.0f, 1.0f);
    float xu = -(cu * z0) / sqrtf(clamp_min(1.0f - cu * cu, SB_F(1e-20)));
    xu = nan_min(nan_max(xu, x0), x1);
    const float dd = sqrtf(xu * xu + z0 * z0);
    const float h0 = y0 / sqrtf(dd * dd + y0 * y0);
    const float h1 = y1 / sqrtf(dd * dd + y1 * y1);
    const float hv = h0 + v * (h1 - h0);
    const float hv2 = hv * hv;
    const float yv = hv < SB_F(1.0 - 1e-5) ? (hv * dd) / sqrtf(clamp_min(1.0f - hv2, SB_F(1e-20))) : y1;
    return o + x * xu + y * yv + z * z0;
}

// sample_rect_light_sphquad: the spherical quad where its solid angle is at
// least 1e-3, else the uniform sample; pdf 0 where the angle is not positive
__device__ __forceinline__ LightSample rect_sphquad(const Light& l, float u, float v, F3 hit_point) {
    float S;
    const F3 pol = sph_quad_point(l, hit_point, u, v, S);
    LightSample s;
    if (S >= SB_F(1e-3)) {
        s.normal = -normalize(cross(l.p1 - l.p0, l.p3 - l.p0));
        toward(hit_point, pol, s.L, s.dist);
        s.pdf = recip(clamp_min(S, SB_F(1e-20)));
    } else {
        s = rect_uniform(l, u, v, hit_point);
    }
    if (S <= 0.0f) s.pdf = 0.0f;
    return s;
}

// create_coordinate_system
__device__ __forceinline__ void coordinate_system(F3 n, F3& nt, F3& nb) {
    const bool use_x = fabsf(n.x) > fabsf(n.y);
    const float inv_len_x = recip(sqrtf(n.x * n.x + n.z * n.z + SB_F(1e-20)));
    const float inv_len_y = recip(sqrtf(n.y * n.y + n.z * n.z + SB_F(1e-20)));
    nt = {use_x ? -n.z * inv_len_x : 0.0f, use_x ? 0.0f : n.z * inv_len_y,
          use_x ? n.x * inv_len_x : -n.y * inv_len_y};
    nb = cross(n, nt);
}

// a direction about `axis` at (cos, sin) of its polar angle, at azimuth phi
__device__ __forceinline__ F3 about(F3 axis, float phi, float cos_t, float sin_t) {
    F3 tu, tv;
    coordinate_system(axis, tu, tv);
    return normalize(tu * (cosf(phi) * sin_t) + tv * (sinf(phi) * sin_t) + axis * cos_t);
}

// sample_sphere_light: the visible cap by solid angle
__device__ __forceinline__ LightSample sphere(const Light& l, float u, float v, F3 hit_point) {
    const F3 c = l.p1 - hit_point;
    const float d = length(c);
    const float d_safe = clamp_min(d, SB_F(1e-20));
    const F3 axis = c * recip(d_safe);
    const float sin_a = clamp(l.radius / d_safe, 0.0f, 1.0f);
    const float cos_a = sqrtf(clamp_min(1.0f - sin_a * sin_a, 0.0f));
    const float one_minus_cos = sin_a * sin_a / (1.0f + cos_a);
    const float phi = SB_F(2.0 * kPi) * u;
    const float cos_t = 1.0f - v * one_minus_cos;
    const float sin_t = sqrtf(clamp_min(1.0f - cos_t * cos_t, 0.0f));
    LightSample s;
    s.L = about(axis, phi, cos_t, sin_t);
    const float disc = clamp_min(l.radius * l.radius - d * d * sin_t * sin_t, 0.0f);
    s.dist = clamp_min(d * cos_t - sqrtf(disc), 0.0f);
    s.normal = normalize(hit_point + s.L * s.dist - l.p1);
    s.pdf = d > l.radius ? recip(SB_F(2.0 * kPi) * clamp_min(one_minus_cos, SB_F(1e-12))) : 0.0f;
    return s;
}

// sample_distant_light: sample_cone about the light's direction
__device__ __forceinline__ LightSample distant(const Light& l, float u, float v) {
    const F3 dir = -l.normal;
    const float phi = SB_F(2.0 * kPi) * u;
    const float cos_theta = 1.0f - v * (1.0f - cosf(l.half_angle));
    const float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta, 0.0f));
    LightSample s;
    s.L = about(dir, phi, cos_theta, sin_theta);
    s.pdf = recip(SB_F(2.0 * kPi) * (1.0f - cosf(l.half_angle)));
    s.normal = l.normal;
    s.dist = SB_F(1e9);
    return s;
}

// sample_light for the lane's own light type; a disc (and any other type)
// gives zeros and pdf 0
template <int kMethod>
__device__ __forceinline__ LightSample sample_light(const Light& l, float u, float v, F3 hit_point) {
    if (l.type == kRect) return kMethod == kSphQuad ? rect_sphquad(l, u, v, hit_point) : rect_uniform(l, u, v, hit_point);
    if (l.type == kSphere) return sphere(l, u, v, hit_point);
    if (l.type == kDistant) return distant(l, u, v);
    LightSample s;
    s.L = splat(0.0f);
    s.normal = splat(0.0f);
    s.pdf = 0.0f;
    s.dist = 0.0f;
    return s;
}

// ops/intersect.py:_offset_component (RT Gems' offset_ray), the int32 sum
// wrapping as PyTorch's does
__device__ __forceinline__ float offset_component(float p, float n) {
    const int of_i = static_cast<int>(n * 256.0f);  // (256.0 * n).to(torch.int32): toward zero
    const unsigned int step = p < 0.0f ? 0u - static_cast<unsigned int>(of_i) : static_cast<unsigned int>(of_i);
    const float p_i = __uint_as_float(__float_as_uint(p) + step);
    return fabsf(p) < SB_F(1.0 / 32.0) ? p + SB_F(1.0 / 65536.0) * n : p_i;
}

template <int kMethod>
__global__ void __launch_bounds__(kThreads) nee_light_kernel(const LightPtrs p, const float* __restrict__ table,
                                                             int rows, long long n, int num_lights, float inv_num) {
    using namespace k11;
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= n) return;
    const bool nee_able = p.ld<bool>(kShade, i) & ((p.ld<int>(kEventType, i) & (kEventDiffuse | kEventGlossy)) != 0);
    const int light_id = min(max(static_cast<int>(p.ld<float>(kULight, i) * SB_F(num_lights)), 0), num_lights - 1);
    const Light l = load_light(light_row(table, rows, light_id));
    const F3 position = p.ld3(kPositionX, i);
    const LightSample s = sample_light<kMethod>(l, p.ld<float>(kUX, i), p.ld<float>(kUY, i), position);
    const float cos_nl = dot(p.ld3(kNormalX, i), s.L);
    const bool lit = (l.color.x != 0.0f) & (l.color.y != 0.0f) & (l.color.z != 0.0f);
    const bool geom_ok = (cos_nl > 0.0f) & (-dot(s.L, s.normal) > 0.0f) & lit;
    const F3 gn = p.ld3(kGeomNormalX, i);
    p.st3(kOrgX, i, F3{offset_component(position.x, gn.x), offset_component(position.y, gn.y),
                       offset_component(position.z, gn.z)});
    p.st3(kToLightX, i, s.L);
    p.st(kDist, i, s.dist);
    p.st(kExclude, i, p.ld<bool>(kIsCurve, i) ? -1 : p.ld<int>(kPrim, i));  // a curve hit excludes no triangle
    const bool active = nee_able & geom_ok;  // the sweep's lanes
    p.st(kActive, i, active);
    p.st(kNeeAble, i, nee_able);
    p.st(kLightPdf, i, (geom_ok ? s.pdf : 0.0f) * inv_num);
    p.st(kLightId, i, light_id);
}

// ops/bsdf.py:bsdf_evaluate for one lane, its material type's lobes only:
// (f*cos diffuse, f*cos glossy) through the references, -> pdf
template <int kFibre>
__device__ __forceinline__ float bsdf_evaluate(const Material& m, const Frame& fr, F3 k1, F3 k2, F3& diff, F3& gloss) {
    diff = splat(0.0f);
    gloss = splat(0.0f);
    if (m.type == kDiffuse) {
        const float cos2 = clamp_min(dot(k2, fr.normal), 0.0f);
        diff = m.diffuse * div_scalar(cos2, kPi);
        return div_scalar(cos2, kPi);
    }
    if (m.type == kOmniPbr) return pbr_eval_local(m, to_local(fr, k1), to_local(fr, k2), diff, gloss);
    if (kFibre == kChiang && m.type == kHair) {
        WoState st;
        hair_wo_state(m, fr, k1, st);
        return hair_eval_core(st, fr, k2, gloss, diff);  // f_R is the glossy part, TT, TRT and the rest the diffuse
    }
    if (kFibre == kKajiyaKay && m.type == kHair) return kajiya_kay_eval(m, fr, k1, k2, diff, gloss);
    return 0.0f;  // OMNI_GLASS is pure specular; HAIR without the fibre lobes
}

__device__ __forceinline__ bool any_nan(F3 a) { return isnan(a.x) | isnan(a.y) | isnan(a.z); }

template <int kFibre>
__global__ void __launch_bounds__(kThreads) nee_shade_kernel(const NeeShadePtrs p, const float* __restrict__ table,
                                                             int rows, long long n) {
    using namespace k12;
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= n) return;
    F3 radiance = p.ld3(kRadianceX, i);
    F3 throughput = p.ld3(kThroughputX, i);
    bool shade = p.ld<bool>(kShade, i);
    if (p.ld<bool>(kNeeAble, i)) {
        const F3 to_light = p.ld3(kToLightX, i);
        Frame fr;
        fr.normal = p.ld3(kNormalX, i);
        fr.tangent_u = p.ld3(kTangentUX, i);
        fr.tangent_v = p.ld3(kTangentVX, i);
        const float cos_nl = dot(fr.normal, to_light);
        // on a nee_able lane the sweep's mask is geom_ok
        const bool lit = p.ld<bool>(kActive, i) & !p.ld<bool>(kOccluded, i);
        const float nee_w = (lit ? 1.0f : 0.0f) * clamp(cos_nl, 0.0f, 1.0f);
        const F3 nee_radiance = ld3g(light_row(table, rows, p.ld<int>(kLightId, i)), 12) * nee_w;
        const float light_pdf = p.ld<float>(kLightPdf, i);
        const bool nan1 = any_nan(nee_radiance) | isnan(light_pdf);  // NaN canary #1 (cu:552-558)
        const bool next_event_valid = ((cos_nl > 0.0f) != p.ld<bool>(kInside, i)) & (light_pdf != 0.0f);
        Material m;
        m.type = p.ld<int>(kType, i);
        m.diffuse = p.ld3(kDiffuseX, i);
        m.metallic = p.ld<float>(kMetallic, i);
        m.roughness = p.ld<float>(kRoughness, i);
        m.specular_level = p.ld<float>(kSpecularLevel, i);
        m.ior = p.ld<float>(kIor, i);
        F3 diff, gloss;
        const float pdf = bsdf_evaluate<kFibre>(m, fr, -p.ld3(kDirectionX, i), to_light, diff, gloss);
        const bool nan2 = any_nan(diff) | any_nan(gloss);
        if (next_event_valid & (pdf > 0.0f) & !nan1 & !nan2) {
            const float lpdf = clamp_min(light_pdf, SB_F(1e-20));
            const float mis_w = recip(1.0f + pdf / lpdf);  // mis_weight_balance
            radiance = radiance + throughput * nee_radiance * (recip(lpdf) * mis_w) * (diff + gloss);
        }
        if (nan1 | nan2) {  // the canary: radiance (1e4, 0, 0), the path killed
            radiance = {SB_F(1e4), 0.0f, 0.0f};
            throughput = splat(0.0f);
            shade = false;
        }
    }
    p.st3(kRadianceOutX, i, radiance);
    p.st3(kThroughputOutX, i, throughput);
    p.st(kShadeOut, i, shade);
}

}  // namespace

// in: k11::kInCount device pointers, out: k11::kOutCount (host arrays, the
// orders above); table: the [rows, 20] light table; method: kUniform or
// kSphQuad.
extern "C" int strelka_nee_light(const void* const* in, void* const* out, const void* table, int rows, long long n,
                                 int num_lights, int method, void* stream) {
    if (n < 1 || rows < 1 || num_lights < 1 || (method != kUniform && method != kSphQuad))
        return static_cast<int>(cudaErrorInvalidValue);
    const LightPtrs p = make_lanes<k11::kInCount, k11::kOutCount>(in, out);
    const float* t = static_cast<const float*>(table);
    const float inv_num = static_cast<float>(1.0 / num_lights);  // * (1.0 / num_lights): the f64 quotient, cast
    const unsigned int blocks = strelka_blocks(n, kThreads);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (method == kSphQuad)
        nee_light_kernel<kSphQuad><<<blocks, kThreads, 0, s>>>(p, t, rows, n, num_lights, inv_num);
    else
        nee_light_kernel<kUniform><<<blocks, kThreads, 0, s>>>(p, t, rows, n, num_lights, inv_num);
    STRELKA_RETURN_LAUNCH_STATUS();
}

// in: k12::kInCount device pointers, out: k12::kOutCount; table, rows: as
// above; variant: kNoFibre, kChiang or kKajiyaKay.
extern "C" int strelka_nee_shade(const void* const* in, void* const* out, const void* table, int rows, long long n,
                                 int variant, void* stream) {
    if (n < 1 || rows < 1 || variant < kNoFibre || variant > kKajiyaKay) return static_cast<int>(cudaErrorInvalidValue);
    const NeeShadePtrs p = make_lanes<k12::kInCount, k12::kOutCount>(in, out);
    const float* t = static_cast<const float*>(table);
    const unsigned int blocks = strelka_blocks(n, kThreads);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (variant == kChiang)
        nee_shade_kernel<kChiang><<<blocks, kThreads, 0, s>>>(p, t, rows, n);
    else if (variant == kKajiyaKay)
        nee_shade_kernel<kKajiyaKay><<<blocks, kThreads, 0, s>>>(p, t, rows, n);
    else
        nee_shade_kernel<kNoFibre><<<blocks, kThreads, 0, s>>>(p, t, rows, n);
    STRELKA_RETURN_LAUNCH_STATUS();
}
