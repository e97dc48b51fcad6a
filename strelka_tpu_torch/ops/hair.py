"""Chiang-style hair fiber BSDF (R/TT/TRT + residual) — the PyTorch port of
strelka_tpu/ops/hair.py.

The reference's hair path compiles MDL ``df::chiang_hair_bsdf`` (selected at
mdlPtxCodeGen.cpp:143-158 when the material's hair expression is present;
shading state filled at OptixRender_radiance_closest_hit.cu:423-454). This is
an implementation of the same published model — Chiang et al. 2016, "A
Practical and Controllable Hair and Fur Model for Production Path Tracing"
(also documented in the pbrt book) — over component-major [N] lanes, fully
branchless across the wavefront:

  * longitudinal lobes M_p: the paper's spherical distribution with
    per-lobe variance v_p, evaluated in log space with a stable Bessel-I0
    approximation when the variance is small (smooth hair)
  * azimuthal lobes N_p: trimmed logistic around the exact dielectric
    deflection angle Phi(p, gamma_o, gamma_t)
  * attenuation A_p: cuticle Fresnel + color absorption through the cortex
    (sigma_a from the artist color via the paper's inverse fit); lobes
    p >= 3 are lumped so the A_p sum telescopes to exactly 1 at zero
    absorption (white-furnace closure, tested in test_torch_oracles.py)
  * cuticle tilt alpha shifts R/TT/TRT off-specular: the characteristic
    primary (white, shifted toward the tip) and secondary (colored, shifted
    toward the root) highlights

The fiber offset h is recovered per-hit from the shading frame: the curve
frame (ops/curves.py:curve_shading_frame_vec) gives the spine-offset radial
normal n, so the azimuth of the projected view direction measured from n IS
gamma_o and h = sin(gamma_o) — no extra intersection outputs needed.

Parameter mapping from the MDL detection (loaders/mdl.py / materials.py):
roughness -> beta_m = beta_n (longitudinal/azimuthal roughness), diffuse
color -> sigma_a via the inverse fit, ior -> cuticle eta.

All lanes pay this cost only when the scene contains hair materials
(enable_hair gate in ops/bsdf.py).
"""

from __future__ import annotations

import math

import torch

from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.vec import Vec3

M_PI = 3.14159265358979323846
_SQRT_PI_OVER_8 = 0.626657069

# cuticle scale tilt (degrees -> radians); Chiang et al. use ~2-3 deg
_ALPHA = math.radians(2.0)
_S1, _C1 = math.sin(_ALPHA), math.cos(_ALPHA)  # alpha   (lobe TT)
_S2, _C2 = 2.0 * _S1 * _C1, _C1 * _C1 - _S1 * _S1  # 2 alpha (lobe R)
_S4, _C4 = 2.0 * _S2 * _C2, _C2 * _C2 - _S2 * _S2  # 4 alpha (lobe TRT)


# ---------------------------------------------------------------------------
# numerics


def _i0(x):
    """Modified Bessel I0 via its power series (valid for x <= ~12)."""
    x2 = x * x
    val = torch.ones_like(x)
    term = torch.ones_like(x)
    for i in range(1, 10):
        term = term * x2 / (4.0 * i * i)
        val = val + term
    return val


def _log_i0(x):
    """log(I0(x)), switching to the asymptotic expansion for large x."""
    xs = torch.clamp(x, min=1e-6)
    big = x + 0.5 * (-math.log(2.0 * M_PI) - torch.log(xs) + 1.0 / (8.0 * xs))
    small = torch.log(_i0(torch.clamp(x, max=12.0)))
    return torch.where(x > 12.0, big, small)


def _mp(cos_ti, cos_to, sin_ti, sin_to, v):
    """Longitudinal scattering lobe M_p (normalized over the sphere).

    Both branches are evaluated with CLAMPED variance so the untaken lane
    never produces inf/nan.
    """
    v_dir = torch.clamp(v, min=0.1)
    a_d = cos_ti * cos_to / v_dir
    b_d = sin_ti * sin_to / v_dir
    direct = torch.exp(-b_d) * _i0(a_d) / (torch.sinh(1.0 / v_dir) * 2.0 * v_dir)
    v_log = torch.clamp(torch.clamp(v, min=1e-7), max=0.1)
    a_l = cos_ti * cos_to / v_log
    b_l = sin_ti * sin_to / v_log
    # exponent = log I0(a) - b - 1/v + log 2 ... <= log(1/(2v)) (since
    # a - b - 1/v = (cos(ti+to) - 1)/v <= 0): safe in f32
    stable = torch.exp(_log_i0(a_l) - b_l - 1.0 / v_log + 0.6931 + torch.log(1.0 / (2.0 * v_log)))
    return torch.where(v <= 0.1, stable, direct)


def _logistic(x, s):
    x = torch.abs(x)
    e = torch.exp(-x / s)
    return e / (s * (1.0 + e) ** 2)


def _logistic_cdf(x, s):
    if not isinstance(x, torch.Tensor):
        x = torch.full_like(s, x)  # a true division below, not a product with 1 / s
    return 1.0 / (1.0 + torch.exp(-x / s))


def _trimmed_logistic(x, s, lo, hi):
    return _logistic(x, s) / (_logistic_cdf(hi, s) - _logistic_cdf(lo, s))


def _sample_trimmed_logistic(u, s, lo, hi):
    k = _logistic_cdf(hi, s) - _logistic_cdf(lo, s)
    p = torch.clamp(u * k + _logistic_cdf(lo, s), 1e-6, 1.0 - 1e-6)
    x = -s * torch.log(1.0 / p - 1.0)
    return torch.clamp(x, lo, hi)


def _wrap_pi(x):
    """Wrap an angle difference into [-pi, pi]."""
    return x - 2.0 * M_PI * torch.round(x / (2.0 * M_PI))


# ---------------------------------------------------------------------------
# model


def _dir_angles(frame, w: Vec3):
    """(sin theta, cos theta, phi) of w in the fiber frame.

    theta measured from the azimuthal plane toward the fiber tangent;
    phi measured around the fiber from the spine-offset normal.
    """
    sin_t = torch.clamp(V.dot(frame.tangent_u, w), -1.0, 1.0)
    cos_t = torch.sqrt(torch.clamp(1.0 - sin_t * sin_t, min=1e-12))
    phi = torch.atan2(V.dot(frame.tangent_v, w), V.dot(frame.normal, w))
    return sin_t, cos_t, phi


def _derive(params):
    """Per-lane derived constants: lobe variances, logistic scale, sigma_a."""
    beta_m = torch.clamp(params.roughness, 0.03, 1.0)
    beta_n = torch.clamp(params.roughness, 0.05, 1.0)
    v0 = (0.726 * beta_m + 0.812 * beta_m**2 + 3.7 * beta_m**20) ** 2
    v = (v0, 0.25 * v0, 4.0 * v0, 4.0 * v0)
    s = _SQRT_PI_OVER_8 * (0.265 * beta_n + 1.194 * beta_n**2 + 5.372 * beta_n**22)
    denom = (
        5.969
        - 0.215 * beta_n
        + 2.532 * beta_n**2
        - 10.73 * beta_n**3
        + 5.574 * beta_n**4
        + 0.245 * beta_n**5
    )

    def sig(c):
        return (torch.log(torch.clamp(c, 1e-4, 1.0)) / denom) ** 2

    c = params.diffuse_color
    sigma_a = Vec3(sig(c.x), sig(c.y), sig(c.z))
    return v, s, sigma_a


class _WoState:
    """Everything derived from wo + the hit frame, shared by eval/sample."""

    __slots__ = (
        "sin_to", "cos_to", "phi_o", "gamma_o", "h", "eta",
        "cos_tt", "sin_gt", "cos_gt", "gamma_t", "ap", "ap_pdf",
        "v", "s", "shift_sin", "shift_cos",
    )


def _wo_state(params, frame, k1: Vec3) -> _WoState:
    from strelka_tpu_torch.ops.bsdf import fresnel_dielectric

    st = _WoState()
    v, s, sigma_a = _derive(params)
    st.v, st.s = v, s
    st.sin_to, st.cos_to, st.phi_o = _dir_angles(frame, k1)
    # h from the spine-offset normal: azimuth of the projected view dir IS
    # gamma_o for a circular cross-section
    st.gamma_o = torch.clamp(st.phi_o, -0.5 * M_PI, 0.5 * M_PI)
    st.h = torch.sin(st.gamma_o)
    eta = torch.clamp(params.ior, min=1.0001)
    st.eta = eta
    sin_tt = st.sin_to / eta
    st.cos_tt = torch.sqrt(torch.clamp(1.0 - sin_tt * sin_tt, min=1e-6))
    # modified azimuthal index (projection of the 3D refraction into the
    # normal plane)
    etap = torch.sqrt(torch.clamp(eta * eta - st.sin_to * st.sin_to, min=1e-9)) / st.cos_to
    st.sin_gt = torch.clamp(st.h / etap, -1.0, 1.0)
    st.cos_gt = torch.sqrt(torch.clamp(1.0 - st.sin_gt * st.sin_gt, min=0.0))
    st.gamma_t = torch.asin(st.sin_gt)
    # single-pass transmittance through the cortex
    tr_exp = -2.0 * st.cos_gt / st.cos_tt
    T = Vec3(
        torch.exp(sigma_a.x * tr_exp),
        torch.exp(sigma_a.y * tr_exp),
        torch.exp(sigma_a.z * tr_exp),
    )
    fr, _, _ = fresnel_dielectric(
        torch.clamp(st.cos_to * torch.cos(st.gamma_o), 1e-4, 1.0), torch.ones_like(eta), eta
    )
    one_minus_f2 = (1.0 - fr) ** 2
    a0 = Vec3(fr, fr, fr)
    a1 = T * one_minus_f2
    a2 = a1 * T * fr
    tf = T * fr
    denom = Vec3(
        torch.clamp(1.0 - tf.x, min=1e-5),
        torch.clamp(1.0 - tf.y, min=1e-5),
        torch.clamp(1.0 - tf.z, min=1e-5),
    )
    a3 = Vec3(a2.x * tf.x / denom.x, a2.y * tf.y / denom.y, a2.z * tf.z / denom.z)
    st.ap = (a0, a1, a2, a3)
    lums = [V.luminance(a) for a in st.ap]
    total = lums[0] + lums[1] + lums[2] + lums[3] + 1e-12
    st.ap_pdf = tuple(l / total for l in lums)
    # cuticle-tilt shifted wo angles per lobe: R by -2a, TT by +a, TRT by +4a
    sh_sin = (
        st.sin_to * _C2 - st.cos_to * _S2,
        st.sin_to * _C1 + st.cos_to * _S1,
        st.sin_to * _C4 + st.cos_to * _S4,
        st.sin_to,
    )
    sh_cos = (
        torch.abs(st.cos_to * _C2 + st.sin_to * _S2),
        torch.abs(st.cos_to * _C1 - st.sin_to * _S1),
        torch.abs(st.cos_to * _C4 - st.sin_to * _S4),
        st.cos_to,
    )
    st.shift_sin, st.shift_cos = sh_sin, sh_cos
    return st


def _phi_p(p: int, gamma_o, gamma_t):
    """Exact azimuthal deflection of lobe p for a smooth dielectric fiber."""
    return 2.0 * p * gamma_t - 2.0 * gamma_o + p * M_PI


def hair_eval(params, frame, k1: Vec3, k2: Vec3):
    """(f_R, f_TT+TRT+residual, pdf); f has NO extra cosine factor: the
    model's M_p is normalized directly over solid angle, matching this
    library's f*cos convention (ops/bsdf.py docstring)."""
    st = _wo_state(params, frame, k1)
    return _hair_eval_core(st, frame, k2)


def _hair_eval_core(st: _WoState, frame, k2: Vec3):
    sin_ti, cos_ti, phi_i = _dir_angles(frame, k2)
    phi = phi_i - st.phi_o
    zero = torch.zeros_like(sin_ti)
    f_r = Vec3(zero, zero, zero)
    f_rest = Vec3(zero, zero, zero)
    pdf = zero
    for p in range(3):
        mp = _mp(cos_ti, st.shift_cos[p], sin_ti, st.shift_sin[p], st.v[p])
        npp = _trimmed_logistic(
            _wrap_pi(phi - _phi_p(p, st.gamma_o, st.gamma_t)), st.s, -M_PI, M_PI
        )
        w = mp * npp
        contrib = st.ap[p] * w
        if p == 0:
            f_r = f_r + contrib
        else:
            f_rest = f_rest + contrib
        pdf = pdf + w * st.ap_pdf[p]
    mp3 = _mp(cos_ti, st.shift_cos[3], sin_ti, st.shift_sin[3], st.v[3])
    f_rest = f_rest + st.ap[3] * (mp3 / (2.0 * M_PI))
    pdf = pdf + mp3 * st.ap_pdf[3] / (2.0 * M_PI)
    return f_r, f_rest, pdf


def hair_sample(params, frame, k1: Vec3, xi):
    """Importance-sample the full model: lobe by A_p energy, then M_p
    (analytically invertible) and N_p (trimmed-logistic inverse CDF).

    Returns (k2, pdf, f_over_pdf: Vec3, valid)."""
    st = _wo_state(params, frame, k1)
    u0, u1, u2, u3 = xi[0], xi[1], xi[2], xi[3]
    c0 = st.ap_pdf[0]
    c1 = c0 + st.ap_pdf[1]
    c2 = c1 + st.ap_pdf[2]
    p = (u0 >= c0).to(torch.int32) + (u0 >= c1).to(torch.int32) + (u0 >= c2).to(torch.int32)
    pf = p.to(torch.float32)

    def sel(vals):
        out = vals[3]
        for k in (2, 1, 0):
            out = torch.where(p == k, vals[k], out)
        return out

    vp = sel(st.v)
    sin_top = sel(st.shift_sin)
    cos_top = sel(st.shift_cos)
    # longitudinal: invert the M_p CDF
    u1c = torch.clamp(u1, 1e-6, 1.0)
    cos_theta = 1.0 + vp * torch.log(u1c + (1.0 - u1c) * torch.exp(-2.0 / torch.clamp(vp, min=1e-7)))
    cos_theta = torch.clamp(cos_theta, -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    cos_phi = torch.cos(2.0 * M_PI * u2)
    sin_ti = -cos_theta * sin_top + sin_theta * cos_phi * cos_top
    sin_ti = torch.clamp(sin_ti, -1.0, 1.0)
    cos_ti = torch.sqrt(torch.clamp(1.0 - sin_ti * sin_ti, min=1e-12))
    # azimuthal: Phi is linear in p, so evaluate it with the per-lane float p
    phi_base = 2.0 * pf * st.gamma_t - 2.0 * st.gamma_o + pf * M_PI
    dphi_smooth = phi_base + _sample_trimmed_logistic(u3, st.s, -M_PI, M_PI)
    dphi = torch.where(p < 3, dphi_smooth, 2.0 * M_PI * u3)
    phi_i = st.phi_o + dphi
    k2 = (
        frame.tangent_u * sin_ti
        + frame.normal * (cos_ti * torch.cos(phi_i))
        + frame.tangent_v * (cos_ti * torch.sin(phi_i))
    )
    k2 = V.normalize(k2)
    f_r, f_rest, pdf = _hair_eval_core(st, frame, k2)
    f_total = f_r + f_rest
    inv = 1.0 / torch.clamp(pdf, min=1e-12)
    over = f_total * inv
    valid = pdf > 1e-12
    return k2, pdf, over, valid
