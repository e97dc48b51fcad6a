// The port's BSDF library on the device: strelka_tpu_torch/ops/bsdf.py
// (bsdf_sample, the OmniPBR, glass and diffuse lobes, the Kajiya-Kay fibre)
// and ops/hair.py (the Chiang fibre), one lane at a time.
//
// Each function repeats the f32 operations of the plain PyTorch code on the
// card, in the same order, so that a kernel built on it is bit-equal to the
// plain ops. A source that includes it is built with -fmad=false: every
// product and sum rounds on its own, as each PyTorch elementwise kernel
// does. What PyTorch does on a CUDA tensor, and these functions therefore do:
//   * a Python float operand is cast to f32 first (SB_F): `x * 0.299` is
//     x * (float)0.299, and a constant the Python code folds in f64 first
//     (`2.0 * M_PI`) is cast once, after the fold;
//   * `tensor / python_float` is a product with the f32 reciprocal of the
//     cast scalar (div_scalar), not a division;
//   * `python_float / tensor` is Tensor.__rtruediv__: reciprocal(t) * the
//     scalar (recip, then the product, which for 1.0 leaves the value);
//   * `t ** 2` and `t ** 3` are products (pow's kernel special-cases them),
//     other integer powers are powf;
//   * torch.clamp returns a NaN as it is, else fminf / fmaxf (clamp, clamp_min,
//     clamp_max);
//   * torch.round is round-half-even (rintf); sin, cos, exp, log, sinh, asin
//     and atan2 are the CUDA math library's full-precision calls.
// Branches replace the plain code's masked selects: a lane computes only
// the lobes of its own material type, which gives the bits the select kept.
#pragma once

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace strelka_bsdf {

#define SB_F(x) static_cast<float>(x)

constexpr double kPi = 3.14159265358979323846;  // M_PI of ops/bsdf.py and ops/hair.py

// mi::neuraylib::Bsdf_event_type bits (ops/bsdf.py)
constexpr int kEventAbsorb = 0;
constexpr int kEventDiffuse = 1;
constexpr int kEventGlossy = 2;
constexpr int kEventSpecular = 4;
constexpr int kEventReflection = 8;
constexpr int kEventTransmission = 16;
constexpr int kEventDiffuseReflection = kEventDiffuse | kEventReflection;
constexpr int kEventGlossyReflection = kEventGlossy | kEventReflection;
constexpr int kEventSpecularReflection = kEventSpecular | kEventReflection;
constexpr int kEventSpecularTransmission = kEventSpecular | kEventTransmission;

// materials.py:BsdfType
constexpr int kDiffuse = 0;
constexpr int kOmniPbr = 1;
constexpr int kHair = 3;

// The fibre variants: none (a scene without hair materials), the Chiang
// model of ops/hair.py, the Kajiya-Kay lobes of ops/bsdf.py:_hair_eval.
constexpr int kNoFibre = 0;
constexpr int kChiang = 1;
constexpr int kKajiyaKay = 2;

// ops/hair.py's cuticle tilt: sin and cos of alpha = 2 degrees, 2 alpha and
// 4 alpha, as the module computes them in f64 (_S1, _C1, _S2, _C2, _S4, _C4)
constexpr double kS1 = 0.03489949670250097, kC1 = 0.9993908270190958;
constexpr double kS2 = 0.0697564737441253, kC2 = 0.9975640502598243;
constexpr double kS4 = 0.13917310096006547, kC4 = 0.9902680687415705;
constexpr double kNegLog2Pi = -1.8378770664093453;  // -math.log(2.0 * M_PI)
constexpr double kSqrtPiOver8 = 0.626657069;

struct F3 {
    float x, y, z;
};

__device__ __forceinline__ F3 operator+(F3 a, F3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ F3 operator-(F3 a, F3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ F3 operator*(F3 a, F3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ F3 operator*(F3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ F3 operator-(F3 a) { return {-a.x, -a.y, -a.z}; }
__device__ __forceinline__ F3 splat(float v) { return {v, v, v}; }

// The [n] field arrays of a shading kernel that takes one lane a thread
// (K10-K12): kIn inputs and kOut outputs, in the order of the wrapper's field
// lists (kernels/shade.py, kernels/nee.py). Inputs go through the read-only
// cache; a flag is one byte.
template <int kIn, int kOut>
struct Lanes {
    const void* in[kIn];
    void* out[kOut];

    template <typename T>
    __device__ __forceinline__ T ld(int field, long long i) const {
        if constexpr (std::is_same<T, bool>::value)
            return static_cast<const bool*>(in[field])[i];
        else
            return __ldg(static_cast<const T*>(in[field]) + i);
    }
    __device__ __forceinline__ F3 ld3(int field, long long i) const {
        return {ld<float>(field, i), ld<float>(field + 1, i), ld<float>(field + 2, i)};
    }
    template <typename T>
    __device__ __forceinline__ void st(int field, long long i, T v) const {
        static_cast<T*>(out[field])[i] = v;
    }
    __device__ __forceinline__ void st3(int field, long long i, F3 v) const {
        st(field, i, v.x);
        st(field + 1, i, v.y);
        st(field + 2, i, v.z);
    }
};

// Lanes from host arrays of the inputs' and the outputs' device pointers
template <int kIn, int kOut>
inline Lanes<kIn, kOut> make_lanes(const void* const* in, void* const* out) {
    Lanes<kIn, kOut> p;
    for (int k = 0; k < kIn; ++k) p.in[k] = in[k];
    for (int k = 0; k < kOut; ++k) p.out[k] = out[k];
    return p;
}

__device__ __forceinline__ float dot(F3 a, F3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ F3 cross(F3 a, F3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp_max(float v, float hi) { return isnan(v) ? v : fminf(v, hi); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) { return isnan(v) ? v : fminf(fmaxf(v, lo), hi); }

// Tensor.__rtruediv__ for 1.0: reciprocal(t), then * 1.0
__device__ __forceinline__ float recip(float v) { return 1.0f / v; }

// tensor / python_float on CUDA: the product with the cast scalar's f32 reciprocal
__device__ __forceinline__ float div_scalar(float v, double c) { return v * (1.0f / SB_F(c)); }

// ops/vec.py:normalize
__device__ __forceinline__ F3 normalize(F3 a) {
    const float inv = recip(clamp_min(sqrtf(dot(a, a)), SB_F(1e-20)));
    return a * inv;
}

// ops/vec.py:luminance
__device__ __forceinline__ float luminance(F3 a) {
    return a.x * SB_F(0.299) + a.y * SB_F(0.587) + a.z * SB_F(0.114);
}

struct Frame {
    F3 normal, tangent_u, tangent_v, geom_normal;
};

struct Material {
    int type;
    F3 diffuse;
    float metallic, roughness, specular_level, ior;
    F3 glass;
    bool thin_walled;
};

struct Sample {
    F3 k2;
    float pdf;
    F3 over_pdf;
    int event;
};

__device__ __forceinline__ F3 to_local(const Frame& f, F3 w) {
    return {dot(w, f.tangent_u), dot(w, f.tangent_v), dot(w, f.normal)};
}

__device__ __forceinline__ F3 to_world(const Frame& f, F3 w) {
    return f.tangent_u * w.x + f.tangent_v * w.y + f.normal * w.z;
}

__device__ __forceinline__ F3 cosine_sample_hemisphere(float u1, float u2) {
    const float r = sqrtf(u1);
    const float phi = u2 * SB_F(2.0 * kPi);
    return {r * cosf(phi), r * sinf(phi), sqrtf(clamp_min(1.0f - u1, 0.0f))};
}

__device__ __forceinline__ F3 schlick(F3 f0, float cos_theta) {
    const float m = clamp(1.0f - cos_theta, 0.0f, 1.0f);
    const float m5 = m * m * m * m * m;
    return f0 + (splat(1.0f) - f0) * m5;
}

// ops/bsdf.py:fresnel_dielectric -> f; cos_t and tir through the references
__device__ __forceinline__ float fresnel_dielectric(float cos_i, float eta_i, float eta_t, float& cos_t, bool& tir) {
    const float e = eta_i / eta_t;
    const float sin2_t = (e * e) * clamp_min(1.0f - cos_i * cos_i, 0.0f);
    tir = sin2_t >= 1.0f;
    cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
    const float r_par = (eta_t * cos_i - eta_i * cos_t) / clamp_min(eta_t * cos_i + eta_i * cos_t, SB_F(1e-20));
    const float r_perp = (eta_i * cos_i - eta_t * cos_t) / clamp_min(eta_i * cos_i + eta_t * cos_t, SB_F(1e-20));
    const float f = (r_par * r_par + r_perp * r_perp) * 0.5f;
    return tir ? 1.0f : f;
}

// --- GGX with Smith height-correlated masking

__device__ __forceinline__ float ggx_ndf(float alpha, float cos_h) {
    const float a2 = alpha * alpha;
    const float d = cos_h * cos_h * (a2 - 1.0f) + 1.0f;
    return a2 / clamp_min(d * SB_F(kPi) * d, SB_F(1e-12));
}

__device__ __forceinline__ float smith_lambda(float alpha, float cos_v) {
    const float a2 = alpha * alpha;
    const float c2 = clamp(cos_v * cos_v, SB_F(1e-9), 1.0f);
    return (sqrtf(1.0f + a2 * (1.0f - c2) / c2) - 1.0f) * 0.5f;
}

__device__ __forceinline__ float smith_g2(float alpha, float cos_i, float cos_o) {
    return recip(1.0f + smith_lambda(alpha, cos_i) + smith_lambda(alpha, cos_o));
}

__device__ __forceinline__ float smith_g1(float alpha, float cos_v) { return recip(1.0f + smith_lambda(alpha, cos_v)); }

// Heitz 2018 visible-normal sampling (isotropic), k1l.z > 0
__device__ __forceinline__ F3 sample_ggx_vndf(F3 k1l, float alpha, float u1, float u2) {
    const F3 v = normalize({alpha * k1l.x, alpha * k1l.y, k1l.z});
    const float lensq = v.x * v.x + v.y * v.y;
    const float inv = recip(sqrtf(clamp_min(lensq, SB_F(1e-20))));
    const bool has = lensq > SB_F(1e-12);
    const F3 t1 = {has ? -v.y * inv : 1.0f, has ? v.x * inv : 0.0f, 0.0f};
    const F3 t2 = cross(v, t1);
    const float r = sqrtf(u1);
    const float phi = u2 * SB_F(2.0 * kPi);
    const float p1 = r * cosf(phi);
    float p2 = r * sinf(phi);
    const float s = (1.0f + v.z) * 0.5f;
    p2 = (1.0f - s) * sqrtf(clamp_min(1.0f - p1 * p1, 0.0f)) + s * p2;
    const float p3 = sqrtf(clamp_min(1.0f - p1 * p1 - p2 * p2, 0.0f));
    const F3 nh = t1 * p1 + t2 * p2 + v * p3;
    return normalize({alpha * nh.x, alpha * nh.y, clamp_min(nh.z, 0.0f)});
}

__device__ __forceinline__ float ggx_vndf_pdf(float alpha, F3 k1l, F3 h) {
    const float cos1 = clamp_min(k1l.z, SB_F(1e-6));
    return smith_g1(alpha, cos1) * ggx_ndf(alpha, h.z) / (cos1 * 4.0f);
}

// ops/bsdf.py:_pbr_lobes: F0 and the specular lobe's probability (the
// diffuse albedo is diffuse * (1 - metallic) where a caller needs it)
__device__ __forceinline__ float pbr_lobes(const Material& m, float cos1, F3& f0) {
    const float spec = m.specular_level * SB_F(0.08) * (1.0f - m.metallic);
    f0 = m.diffuse * m.metallic + splat(spec);
    const F3 albedo_d = m.diffuse * (1.0f - m.metallic);
    const float w_spec = luminance(schlick(f0, cos1));
    const float w_diff = luminance(albedo_d);
    const float p_spec = w_spec / clamp_min(w_spec + w_diff, SB_F(1e-8));
    return w_spec + w_diff < SB_F(1e-8) ? 0.5f : clamp(p_spec, SB_F(0.05), SB_F(0.95));
}

// ops/bsdf.py:_pbr_eval_local: (f*cos diffuse, f*cos specular, pdf)
__device__ __forceinline__ float pbr_eval_local(const Material& m, F3 k1l, F3 k2l, F3& diff_out, F3& spec_out) {
    const float alpha = clamp_min(m.roughness * m.roughness, SB_F(1e-6));
    const float cos1 = clamp_min(k1l.z, SB_F(1e-6));
    const float cos2 = clamp_min(k2l.z, 0.0f);
    F3 f0;
    const float p_spec = pbr_lobes(m, cos1, f0);
    const F3 albedo_d = m.diffuse * (1.0f - m.metallic);
    const F3 h = normalize(k1l + k2l);
    const float cos_h = clamp(h.z, 0.0f, 1.0f);
    const float k1h = clamp_min(dot(k1l, h), SB_F(1e-6));
    const float d = ggx_ndf(alpha, cos_h);
    const float g = smith_g2(alpha, cos1, cos2);
    const F3 f = schlick(f0, k1h);
    const F3 spec = f * (d * g / clamp_min(cos1 * 4.0f, SB_F(1e-9)));
    const F3 diff = albedo_d * div_scalar(cos2, kPi);
    const float pdf_spec = ggx_vndf_pdf(alpha, k1l, h);
    const float pdf_diff = div_scalar(cos2, kPi);
    const float pdf = p_spec * pdf_spec + (1.0f - p_spec) * pdf_diff;
    const bool valid = (k2l.z > 0.0f) & (k1l.z > 0.0f);
    diff_out = valid ? diff : splat(0.0f);
    spec_out = valid ? spec : splat(0.0f);
    return valid ? pdf : 0.0f;
}

// ops/bsdf.py:_hair_eval, the Kajiya-Kay fibre: (f*cos diffuse, f*cos
// highlight, pdf)
__device__ __forceinline__ float kajiya_kay_eval(const Material& m, const Frame& fr, F3 k1, F3 k2, F3& diff_out,
                                                 F3& spec_out) {
    const F3 t_f = fr.tangent_u;
    const float cos_nl = clamp_min(dot(fr.normal, k2), 0.0f);
    const float tdl = dot(t_f, k2);
    const float sin_tl = sqrtf(clamp_min(1.0f - tdl * tdl, 0.0f));
    const F3 h = normalize(k1 + k2);
    const float tdh = dot(t_f, h);
    const float sin_th = sqrtf(clamp_min(1.0f - tdh * tdh, 0.0f));
    const float p = recip(clamp_min(m.roughness * m.roughness, SB_F(1e-3))) * 2.0f;
    const float spec_norm = sqrtf(p) * SB_F(1.0 / 7.6);
    const float spec = m.specular_level * spec_norm * powf(clamp_min(sin_th, 0.0f), p);
    const F3 diff = m.diffuse * div_scalar(sin_tl, kPi);
    const float pdf = div_scalar(cos_nl, kPi);
    const bool valid = cos_nl > 0.0f;
    diff_out = valid ? diff * cos_nl : splat(0.0f);
    spec_out = valid ? splat(1.0f) * (spec * cos_nl) : splat(0.0f);
    return valid ? pdf : 0.0f;
}

// --- the Chiang fibre (ops/hair.py)

__device__ __forceinline__ float hair_i0(float x) {
    const float x2 = x * x;
    float val = 1.0f, term = 1.0f;
#pragma unroll
    for (int i = 1; i < 10; ++i) {
        term = term * x2 * (1.0f / SB_F(4.0 * i * i));
        val = val + term;
    }
    return val;
}

__device__ __forceinline__ float hair_log_i0(float x) {
    if (x > 12.0f) {
        const float xs = clamp_min(x, SB_F(1e-6));
        return x + (SB_F(kNegLog2Pi) - logf(xs) + recip(xs * 8.0f)) * 0.5f;
    }
    return logf(hair_i0(clamp_max(x, 12.0f)));
}

// M_p, the longitudinal lobe: the branch torch.where keeps
__device__ __forceinline__ float hair_mp(float cos_ti, float cos_to, float sin_ti, float sin_to, float v) {
    if (v <= SB_F(0.1)) {
        const float v_log = clamp_max(clamp_min(v, SB_F(1e-7)), SB_F(0.1));
        const float a_l = cos_ti * cos_to / v_log;
        const float b_l = sin_ti * sin_to / v_log;
        return expf(hair_log_i0(a_l) - b_l - recip(v_log) + SB_F(0.6931) + logf(recip(v_log * 2.0f)));
    }
    const float v_dir = clamp_min(v, SB_F(0.1));
    const float a_d = cos_ti * cos_to / v_dir;
    const float b_d = sin_ti * sin_to / v_dir;
    return expf(-b_d) * hair_i0(a_d) / (sinhf(recip(v_dir)) * 2.0f * v_dir);
}

__device__ __forceinline__ float logistic(float x, float s) {
    x = fabsf(x);
    const float e = expf(-x / s);
    const float q = 1.0f + e;
    return e / (s * (q * q));
}

// _logistic_cdf at a Python float c: torch.full_like(s, c), so -c / s divides
__device__ __forceinline__ float logistic_cdf(float c, float s) { return recip(1.0f + expf(-c / s)); }

__device__ __forceinline__ float trimmed_logistic(float x, float s) {
    return logistic(x, s) / (logistic_cdf(SB_F(kPi), s) - logistic_cdf(SB_F(-kPi), s));
}

__device__ __forceinline__ float sample_trimmed_logistic(float u, float s) {
    const float lo = logistic_cdf(SB_F(-kPi), s);
    const float k = logistic_cdf(SB_F(kPi), s) - lo;
    const float p = clamp(u * k + lo, SB_F(1e-6), SB_F(1.0 - 1e-6));
    const float x = -s * logf(recip(p) - 1.0f);
    return clamp(x, SB_F(-kPi), SB_F(kPi));
}

__device__ __forceinline__ float wrap_pi(float x) {
    return x - rintf(div_scalar(x, 2.0 * kPi)) * SB_F(2.0 * kPi);
}

// (sin theta, cos theta, phi) of w in the fibre frame
__device__ __forceinline__ void dir_angles(const Frame& fr, F3 w, float& sin_t, float& cos_t, float& phi) {
    sin_t = clamp(dot(fr.tangent_u, w), -1.0f, 1.0f);
    cos_t = sqrtf(clamp_min(1.0f - sin_t * sin_t, SB_F(1e-12)));
    phi = atan2f(dot(fr.tangent_v, w), dot(fr.normal, w));
}

// ops/hair.py:_WoState: everything derived from k1 and the hit
struct WoState {
    float sin_to, cos_to, phi_o, gamma_o, gamma_t;
    F3 ap[4];
    float ap_pdf[4];
    float v[4];
    float s;
    float shift_sin[4], shift_cos[4];
};

// a[p] by selects, as hair_sample's `sel` takes it: an index the lane
// computes would put the arrays in local memory
__device__ __forceinline__ float sel4(const float (&a)[4], int p) {
    return p == 0 ? a[0] : p == 1 ? a[1] : p == 2 ? a[2] : a[3];
}

__device__ __forceinline__ float hair_sigma(float c, float denom) {
    const float q = logf(clamp(c, SB_F(1e-4), 1.0f)) / denom;
    return q * q;
}

__device__ __forceinline__ void hair_wo_state(const Material& m, const Frame& fr, F3 k1, WoState& st) {
    // _derive
    const float beta_m = clamp(m.roughness, SB_F(0.03), 1.0f);
    const float beta_n = clamp(m.roughness, SB_F(0.05), 1.0f);
    const float v0r = beta_m * SB_F(0.726) + beta_m * beta_m * SB_F(0.812) + powf(beta_m, 20.0f) * SB_F(3.7);
    const float v0 = v0r * v0r;
    st.v[0] = v0;
    st.v[1] = v0 * 0.25f;
    st.v[2] = v0 * 4.0f;
    st.v[3] = v0 * 4.0f;
    st.s = (beta_n * SB_F(0.265) + beta_n * beta_n * SB_F(1.194) + powf(beta_n, 22.0f) * SB_F(5.372)) *
           SB_F(kSqrtPiOver8);
    const float denom = SB_F(5.969) - beta_n * SB_F(0.215) + beta_n * beta_n * SB_F(2.532) -
                        beta_n * beta_n * beta_n * SB_F(10.73) + powf(beta_n, 4.0f) * SB_F(5.574) +
                        powf(beta_n, 5.0f) * SB_F(0.245);
    const F3 sigma_a = {hair_sigma(m.diffuse.x, denom), hair_sigma(m.diffuse.y, denom), hair_sigma(m.diffuse.z, denom)};

    dir_angles(fr, k1, st.sin_to, st.cos_to, st.phi_o);
    st.gamma_o = clamp(st.phi_o, SB_F(-0.5 * kPi), SB_F(0.5 * kPi));
    const float h = sinf(st.gamma_o);
    const float eta = clamp_min(m.ior, SB_F(1.0001));
    const float sin_tt = st.sin_to / eta;
    const float cos_tt = sqrtf(clamp_min(1.0f - sin_tt * sin_tt, SB_F(1e-6)));
    const float etap = sqrtf(clamp_min(eta * eta - st.sin_to * st.sin_to, SB_F(1e-9))) / st.cos_to;
    const float sin_gt = clamp(h / etap, -1.0f, 1.0f);
    const float cos_gt = sqrtf(clamp_min(1.0f - sin_gt * sin_gt, 0.0f));
    st.gamma_t = asinf(sin_gt);
    const float tr_exp = cos_gt * -2.0f / cos_tt;
    const F3 T = {expf(sigma_a.x * tr_exp), expf(sigma_a.y * tr_exp), expf(sigma_a.z * tr_exp)};
    float cos_t_unused;
    bool tir_unused;
    const float fr_c = fresnel_dielectric(clamp(st.cos_to * cosf(st.gamma_o), SB_F(1e-4), 1.0f), 1.0f, eta,
                                          cos_t_unused, tir_unused);
    const float one_minus_f2 = (1.0f - fr_c) * (1.0f - fr_c);
    st.ap[0] = splat(fr_c);
    st.ap[1] = T * one_minus_f2;
    st.ap[2] = st.ap[1] * T * fr_c;
    const F3 tf = T * fr_c;
    const F3 den = {clamp_min(1.0f - tf.x, SB_F(1e-5)), clamp_min(1.0f - tf.y, SB_F(1e-5)),
                    clamp_min(1.0f - tf.z, SB_F(1e-5))};
    st.ap[3] = {st.ap[2].x * tf.x / den.x, st.ap[2].y * tf.y / den.y, st.ap[2].z * tf.z / den.z};
    float lums[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) lums[p] = luminance(st.ap[p]);
    const float total = lums[0] + lums[1] + lums[2] + lums[3] + SB_F(1e-12);
#pragma unroll
    for (int p = 0; p < 4; ++p) st.ap_pdf[p] = lums[p] / total;
    st.shift_sin[0] = st.sin_to * SB_F(kC2) - st.cos_to * SB_F(kS2);
    st.shift_sin[1] = st.sin_to * SB_F(kC1) + st.cos_to * SB_F(kS1);
    st.shift_sin[2] = st.sin_to * SB_F(kC4) + st.cos_to * SB_F(kS4);
    st.shift_sin[3] = st.sin_to;
    st.shift_cos[0] = fabsf(st.cos_to * SB_F(kC2) + st.sin_to * SB_F(kS2));
    st.shift_cos[1] = fabsf(st.cos_to * SB_F(kC1) - st.sin_to * SB_F(kS1));
    st.shift_cos[2] = fabsf(st.cos_to * SB_F(kC4) - st.sin_to * SB_F(kS4));
    st.shift_cos[3] = st.cos_to;
}

// ops/hair.py:_hair_eval_core -> pdf; f_R and f_TT+TRT+residual through the references
__device__ __forceinline__ float hair_eval_core(const WoState& st, const Frame& fr, F3 k2, F3& f_r, F3& f_rest) {
    float sin_ti, cos_ti, phi_i;
    dir_angles(fr, k2, sin_ti, cos_ti, phi_i);
    const float phi = phi_i - st.phi_o;
    f_r = splat(0.0f);
    f_rest = splat(0.0f);
    float pdf = 0.0f;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
        const float mp = hair_mp(cos_ti, st.shift_cos[p], sin_ti, st.shift_sin[p], st.v[p]);
        // _phi_p: 2.0 * p * gamma_t - 2.0 * gamma_o + p * M_PI
        const float phi_p = st.gamma_t * SB_F(2.0 * p) - st.gamma_o * 2.0f + SB_F(p * kPi);
        const float npp = trimmed_logistic(wrap_pi(phi - phi_p), st.s);
        const float w = mp * npp;
        const F3 contrib = st.ap[p] * w;
        if (p == 0)
            f_r = f_r + contrib;
        else
            f_rest = f_rest + contrib;
        pdf = pdf + w * st.ap_pdf[p];
    }
    const float mp3 = hair_mp(cos_ti, st.shift_cos[3], sin_ti, st.shift_sin[3], st.v[3]);
    f_rest = f_rest + st.ap[3] * div_scalar(mp3, 2.0 * kPi);
    pdf = pdf + div_scalar(mp3 * st.ap_pdf[3], 2.0 * kPi);
    return pdf;
}

// ops/hair.py:hair_sample -> valid; the world direction, pdf and f/pdf
// through the references
__device__ __forceinline__ bool chiang_sample(const Material& m, const Frame& fr, F3 k1, float u0, float u1,
                                              float u2, float u3, F3& k2, float& pdf, F3& over) {
    WoState st;
    hair_wo_state(m, fr, k1, st);
    const float c0 = st.ap_pdf[0];
    const float c1 = c0 + st.ap_pdf[1];
    const float c2 = c1 + st.ap_pdf[2];
    const int p = static_cast<int>(u0 >= c0) + static_cast<int>(u0 >= c1) + static_cast<int>(u0 >= c2);
    const float pf = static_cast<float>(p);
    const float vp = sel4(st.v, p);
    const float sin_top = sel4(st.shift_sin, p);
    const float cos_top = sel4(st.shift_cos, p);
    const float u1c = clamp(u1, SB_F(1e-6), 1.0f);
    float cos_theta = 1.0f + vp * logf(u1c + (1.0f - u1c) * expf(recip(clamp_min(vp, SB_F(1e-7))) * -2.0f));
    cos_theta = clamp(cos_theta, -1.0f, 1.0f);
    const float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta, 0.0f));
    const float cos_phi = cosf(u2 * SB_F(2.0 * kPi));
    float sin_ti = -cos_theta * sin_top + sin_theta * cos_phi * cos_top;
    sin_ti = clamp(sin_ti, -1.0f, 1.0f);
    const float cos_ti = sqrtf(clamp_min(1.0f - sin_ti * sin_ti, SB_F(1e-12)));
    const float phi_base = pf * 2.0f * st.gamma_t - st.gamma_o * 2.0f + pf * SB_F(kPi);
    const float dphi = p < 3 ? phi_base + sample_trimmed_logistic(u3, st.s) : u3 * SB_F(2.0 * kPi);
    const float phi_i = st.phi_o + dphi;
    k2 = normalize(fr.tangent_u * sin_ti + fr.normal * (cos_ti * cosf(phi_i)) + fr.tangent_v * (cos_ti * sinf(phi_i)));
    F3 f_r, f_rest;
    pdf = hair_eval_core(st, fr, k2, f_r, f_rest);
    over = (f_r + f_rest) * recip(clamp_min(pdf, SB_F(1e-12)));
    return pdf > SB_F(1e-12);
}

// ops/bsdf.py:bsdf_sample for one lane, its material type's lobes only.
// k1: towards the previous vertex; xi: the four BSDF uniforms.
template <int kFibre>
__device__ __forceinline__ Sample bsdf_sample(const Material& m, const Frame& fr, F3 k1, const float xi[4], float ior1,
                                              float ior2) {
    const F3 k1l = to_local(fr, k1);
    const float cos1 = k1l.z;
    const float u1 = xi[0], u2 = xi[1], u3 = xi[2];
    Sample out;
    F3 k2l;
    bool valid;
    if (m.type == kDiffuse || (kFibre == kKajiyaKay && m.type == kHair)) {
        const F3 k2l_diff = cosine_sample_hemisphere(u1, u2);
        k2l = k2l_diff;
        if (m.type == kDiffuse) {
            out.pdf = div_scalar(clamp_min(k2l_diff.z, 0.0f), kPi);
            out.over_pdf = m.diffuse;
            out.event = kEventDiffuseReflection;
            valid = (cos1 > 0.0f) & (k2l_diff.z > 0.0f);
        } else {
            F3 hd, hs;
            const float hp = kajiya_kay_eval(m, fr, k1, normalize(to_world(fr, k2l_diff)), hd, hs);
            out.pdf = hp;
            out.over_pdf = (hd + hs) * recip(clamp_min(hp, SB_F(1e-12)));
            out.event = kEventGlossyReflection;
            valid = (hp > 0.0f) & (cos1 > -1.0f);
        }
    } else if (m.type == kOmniPbr) {
        F3 f0;
        const float p_spec = pbr_lobes(m, clamp_min(cos1, SB_F(1e-6)), f0);
        if (m.roughness < SB_F(1e-3)) {  // a perfect mirror (MDL's SPECULAR convention)
            k2l = {-k1l.x, -k1l.y, k1l.z};
            out.over_pdf = schlick(f0, clamp_min(cos1, SB_F(1e-6)));
            out.pdf = 0.0f;
            out.event = kEventSpecularReflection;
            valid = cos1 > 0.0f;
        } else {
            const bool take_spec = u3 < p_spec;
            if (take_spec) {
                const float alpha = clamp_min(m.roughness * m.roughness, SB_F(1e-6));
                const F3 k1l_up = {k1l.x, k1l.y, clamp_min(cos1, SB_F(1e-4))};
                const F3 h = sample_ggx_vndf(k1l_up, alpha, u1, u2);
                k2l = normalize(h * (dot(k1l_up, h) * 2.0f) - k1l_up);
            } else {
                k2l = cosine_sample_hemisphere(u1, u2);
            }
            F3 pd, ps;
            const float pdf = pbr_eval_local(m, k1l, k2l, pd, ps);
            out.over_pdf = (pd + ps) * recip(clamp_min(pdf, SB_F(1e-12)));
            out.pdf = pdf;
            out.event = take_spec ? kEventGlossyReflection : kEventDiffuseReflection;
            valid = (pdf > 0.0f) & (cos1 > 0.0f);
        }
    } else if (kFibre == kChiang && m.type == kHair) {
        F3 k2w;
        valid = chiang_sample(m, fr, k1, xi[0], xi[1], xi[2], xi[3], k2w, out.pdf, out.over_pdf);
        out.event = valid ? kEventGlossyReflection : kEventAbsorb;
        if (!valid) out.over_pdf = splat(0.0f);
        out.k2 = normalize(k2w);
        return out;
    } else {  // OMNI_GLASS and every other type: a smooth dielectric
        float cos_t;
        bool tir;
        const float f = fresnel_dielectric(clamp_min(cos1, SB_F(1e-6)), ior1, ior2, cos_t, tir);
        const bool reflect = (u3 < f) | tir;
        if (reflect) {
            k2l = {-k1l.x, -k1l.y, k1l.z};
        } else if (m.thin_walled) {  // transmission passes straight through
            k2l = {-k1l.x, -k1l.y, -k1l.z};
        } else {
            const float eta_rel = ior1 / ior2;
            k2l = normalize({-eta_rel * k1l.x, -eta_rel * k1l.y, -cos_t});
        }
        out.over_pdf = reflect ? splat(1.0f) : m.glass;
        out.pdf = 0.0f;
        out.event = reflect ? kEventSpecularReflection : kEventSpecularTransmission;
        valid = cos1 > 0.0f;
    }
    if (!valid) {
        out.event = kEventAbsorb;
        out.over_pdf = splat(0.0f);
    }
    out.k2 = normalize(to_world(fr, k2l));
    return out;
}

}  // namespace strelka_bsdf
