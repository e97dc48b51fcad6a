"""Analytic BSDF library — the PyTorch port of strelka_tpu/ops/bsdf.py.

The reference JIT-compiles each MDL material to PTX exposing mdlcode_sample
/ mdlcode_evaluate (OptixRender_radiance_closest_hit.cu:31-33, called at
:502-571). Here, as in the JAX package, the same contract is a fixed set of
analytic BSDFs switched by a per-material type id, evaluated branchlessly
across the wavefront with masked selects.

Contract parity with mi::neuraylib (target_code_types.h):
  * sample() consumes 4 uniforms (xi), returns k2, pdf, bsdf_over_pdf and an
    event bitmask; bsdf_over_pdf INCLUDES cos(k2)/pdf.
  * evaluate() returns bsdf_diffuse / bsdf_glossy which INCLUDE cos(k2), plus
    the sample pdf; zero for specular events.
  * pure-specular sampling returns pdf == 0 (MDL convention).

Models: DIFFUSE (default.mdl), OMNI_PBR (GGX VNDF metal/rough + diffuse
base), OMNI_GLASS (smooth dielectric with transmission tint), HAIR (the
Chiang fibre model of ops/hair.py, evaluated only with enable_hair=True:
scenes without hair materials skip the fibre lobes). The reference's
Kajiya-Kay alternative behind STRELKA_HAIR_KK is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from strelka_tpu_torch.materials import BsdfType
from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.vec import Vec3

M_PI = 3.14159265358979323846

# mi::neuraylib::Bsdf_event_type bit values
BSDF_EVENT_ABSORB = 0
BSDF_EVENT_DIFFUSE = 1
BSDF_EVENT_GLOSSY = 2
BSDF_EVENT_SPECULAR = 4
BSDF_EVENT_REFLECTION = 8
BSDF_EVENT_TRANSMISSION = 16
BSDF_EVENT_DIFFUSE_REFLECTION = BSDF_EVENT_DIFFUSE | BSDF_EVENT_REFLECTION
BSDF_EVENT_GLOSSY_REFLECTION = BSDF_EVENT_GLOSSY | BSDF_EVENT_REFLECTION
BSDF_EVENT_SPECULAR_REFLECTION = BSDF_EVENT_SPECULAR | BSDF_EVENT_REFLECTION
BSDF_EVENT_SPECULAR_TRANSMISSION = BSDF_EVENT_SPECULAR | BSDF_EVENT_TRANSMISSION

_SPECULAR_ROUGHNESS_EPS = 1e-3


class ShadingFrame(NamedTuple):
    """Subset of Shading_state_material (cu:477-494): world-space frame."""

    normal: Vec3
    tangent_u: Vec3
    tangent_v: Vec3
    geom_normal: Vec3


class SurfaceParams(NamedTuple):
    """Per-hit material parameters (gathered rows of the material table)."""

    bsdf_type: torch.Tensor  # [N] int32
    diffuse_color: Vec3
    metallic: torch.Tensor  # [N]
    roughness: torch.Tensor  # [N]
    specular_level: torch.Tensor  # [N]
    ior: torch.Tensor  # [N]
    glass_color: Vec3
    opacity: torch.Tensor  # [N]
    emission_color: Vec3  # radiance scale; 0 = non-emissive
    thin_walled: torch.Tensor  # [N] bool


class BsdfSample(NamedTuple):
    k2: Vec3
    pdf: torch.Tensor  # [N] (0 for specular)
    bsdf_over_pdf: Vec3  # includes cos/pdf
    event_type: torch.Tensor  # [N] int32


class BsdfEval(NamedTuple):
    bsdf_diffuse: Vec3  # includes cos
    bsdf_glossy: Vec3  # includes cos
    pdf: torch.Tensor  # [N]


def _zeros(like: torch.Tensor) -> Vec3:
    z = torch.zeros_like(like, dtype=torch.float32)
    return Vec3(z, z, z)


def _to_local(frame: ShadingFrame, w: Vec3) -> Vec3:
    """World -> tangent space (z = shading normal)."""
    return Vec3(V.dot(w, frame.tangent_u), V.dot(w, frame.tangent_v), V.dot(w, frame.normal))


def _to_world(frame: ShadingFrame, w: Vec3) -> Vec3:
    return frame.tangent_u * w.x + frame.tangent_v * w.y + frame.normal * w.z


def cosine_sample_hemisphere(u1, u2) -> Vec3:
    """Cosine-weighted hemisphere sample in local space (z up)."""
    r = torch.sqrt(u1)
    phi = 2.0 * M_PI * u2
    return Vec3(r * torch.cos(phi), r * torch.sin(phi), torch.sqrt(torch.clamp(1.0 - u1, min=0.0)))


def _schlick(f0: Vec3, cos_theta) -> Vec3:
    m = torch.clamp(1.0 - cos_theta, 0.0, 1.0)
    m5 = m * m * m * m * m
    return f0 + (1.0 - f0) * m5


def fresnel_dielectric(cos_i, eta_i, eta_t):
    """Exact unpolarized dielectric Fresnel. cos_i > 0."""
    sin2_t = (eta_i / eta_t) ** 2 * torch.clamp(1.0 - cos_i**2, min=0.0)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    r_par = (eta_t * cos_i - eta_i * cos_t) / torch.clamp(eta_t * cos_i + eta_i * cos_t, min=1e-20)
    r_perp = (eta_i * cos_i - eta_t * cos_t) / torch.clamp(eta_i * cos_i + eta_t * cos_t, min=1e-20)
    f = 0.5 * (r_par**2 + r_perp**2)
    return torch.where(tir, 1.0, f), cos_t, tir


# --- GGX (Trowbridge-Reitz) with Smith height-correlated masking ---


def _ggx_ndf(alpha, cos_h):
    a2 = alpha * alpha
    d = cos_h * cos_h * (a2 - 1.0) + 1.0
    return a2 / torch.clamp(M_PI * d * d, min=1e-12)


def _smith_lambda(alpha, cos_v):
    a2 = alpha * alpha
    c2 = torch.clamp(cos_v * cos_v, 1e-9, 1.0)
    return 0.5 * (torch.sqrt(1.0 + a2 * (1.0 - c2) / c2) - 1.0)


def _smith_g2(alpha, cos_i, cos_o):
    return 1.0 / (1.0 + _smith_lambda(alpha, cos_i) + _smith_lambda(alpha, cos_o))


def _smith_g1(alpha, cos_v):
    return 1.0 / (1.0 + _smith_lambda(alpha, cos_v))


def sample_ggx_vndf(k1l: Vec3, alpha, u1, u2) -> Vec3:
    """Heitz 2018 visible-NDF half-vector sampling (isotropic). k1 z>0."""
    v = V.normalize(Vec3(alpha * k1l.x, alpha * k1l.y, k1l.z))
    lensq = v.x * v.x + v.y * v.y
    inv = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    has = lensq > 1e-12
    t1 = Vec3(
        torch.where(has, -v.y * inv, 1.0),
        torch.where(has, v.x * inv, 0.0),
        torch.zeros_like(v.z),
    )
    t2 = V.cross(v, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * M_PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + v.z)
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    nh = t1 * p1 + t2 * p2 + v * p3
    return V.normalize(Vec3(alpha * nh.x, alpha * nh.y, torch.clamp(nh.z, min=0.0)))


def _ggx_vndf_pdf(alpha, k1l: Vec3, h: Vec3):
    cos1 = torch.clamp(k1l.z, min=1e-6)
    return _smith_g1(alpha, cos1) * _ggx_ndf(alpha, h.z) / (4.0 * cos1)


def _pbr_lobes(params: SurfaceParams, cos1):
    """Shared OmniPBR lobe quantities: F0, diffuse albedo, lobe weights."""
    f0 = params.diffuse_color * params.metallic + (
        0.08 * params.specular_level * (1.0 - params.metallic)
    )
    albedo_d = params.diffuse_color * (1.0 - params.metallic)
    f_k1 = _schlick(f0, cos1)
    w_spec = V.luminance(f_k1)
    w_diff = V.luminance(albedo_d)
    p_spec = w_spec / torch.clamp(w_spec + w_diff, min=1e-8)
    p_spec = torch.where(w_spec + w_diff < 1e-8, 0.5, torch.clamp(p_spec, 0.05, 0.95))
    return f0, albedo_d, p_spec


def _pbr_eval_local(params: SurfaceParams, k1l: Vec3, k2l: Vec3):
    """f*cos and pdf for OmniPBR in local space; both directions above surface."""
    alpha = torch.clamp(params.roughness**2, min=1e-6)
    cos1 = torch.clamp(k1l.z, min=1e-6)
    cos2 = torch.clamp(k2l.z, min=0.0)
    f0, albedo_d, p_spec = _pbr_lobes(params, cos1)
    h = V.normalize(k1l + k2l)
    cos_h = torch.clamp(h.z, 0.0, 1.0)
    k1h = torch.clamp(V.dot(k1l, h), min=1e-6)
    d = _ggx_ndf(alpha, cos_h)
    g = _smith_g2(alpha, cos1, cos2)
    f = _schlick(f0, k1h)
    spec = f * (d * g / torch.clamp(4.0 * cos1, min=1e-9))  # D*G*F/(4 c1 c2) * c2 folded
    diff = albedo_d * (cos2 / M_PI)
    pdf_spec = _ggx_vndf_pdf(alpha, k1l, h)
    pdf_diff = cos2 / M_PI
    pdf = p_spec * pdf_spec + (1.0 - p_spec) * pdf_diff
    valid = (k2l.z > 0.0) & (k1l.z > 0.0)
    zero = _zeros(cos2)
    return V.where(valid, diff, zero), V.where(valid, spec, zero), torch.where(valid, pdf, 0.0)


def bsdf_evaluate(params: SurfaceParams, frame: ShadingFrame, k1: Vec3, k2: Vec3,
                  enable_hair: bool = False) -> BsdfEval:
    """mdlcode_evaluate equivalent: f*cos split diffuse/glossy + pdf.

    enable_hair: scenes without hair materials skip the fibre lobes."""
    k1l = _to_local(frame, k1)
    k2l = _to_local(frame, k2)
    cos2 = torch.clamp(k2l.z, min=0.0)
    d_diff = params.diffuse_color * (cos2 / M_PI)
    d_pdf = cos2 / M_PI
    p_diff, p_spec_v, p_pdf = _pbr_eval_local(params, k1l, k2l)
    # OMNI_GLASS: pure specular -> zero
    t = params.bsdf_type
    is_d = t == BsdfType.DIFFUSE
    is_p = t == BsdfType.OMNI_PBR
    zero = _zeros(cos2)
    bsdf_diffuse = V.where(is_d, d_diff, V.where(is_p, p_diff, zero))
    bsdf_glossy = V.where(is_p, p_spec_v, zero)
    pdf = torch.where(is_d, d_pdf, torch.where(is_p, p_pdf, 0.0))
    if enable_hair:
        from strelka_tpu_torch.ops import hair as HAIR

        is_h = t == BsdfType.HAIR
        h_spec, h_diff, h_pdf = HAIR.hair_eval(params, frame, k1, k2)
        bsdf_diffuse = V.where(is_h, h_diff, bsdf_diffuse)
        bsdf_glossy = V.where(is_h, h_spec, bsdf_glossy)
        pdf = torch.where(is_h, h_pdf, pdf)
    return BsdfEval(bsdf_diffuse, bsdf_glossy, pdf)


def bsdf_sample(params: SurfaceParams, frame: ShadingFrame, k1: Vec3, xi, ior1, ior2,
                enable_hair: bool = False) -> BsdfSample:
    """mdlcode_sample equivalent.

    k1: outgoing (towards camera/previous vertex). xi: 4 [N] uniforms.
    ior1/ior2: [N] incident/transmitted IOR.
    """
    k1l = _to_local(frame, k1)
    cos1 = k1l.z
    u1, u2, u3 = xi[0], xi[1], xi[2]

    # ---------------- diffuse lobe (shared by DIFFUSE and PBR-diffuse branch)
    k2l_diff = cosine_sample_hemisphere(u1, u2)
    pdf_diff = torch.clamp(k2l_diff.z, min=0.0) / M_PI

    # ---------------- PBR specular lobe
    alpha = torch.clamp(params.roughness**2, min=1e-6)
    k1l_up = Vec3(k1l.x, k1l.y, torch.clamp(cos1, min=1e-4))
    h = sample_ggx_vndf(k1l_up, alpha, u1, u2)
    k2l_spec = V.normalize(h * (2.0 * V.dot(k1l_up, h)) - k1l_up)

    f0, _albedo, p_spec = _pbr_lobes(params, torch.clamp(cos1, min=1e-6))
    take_spec = u3 < p_spec
    k2l_pbr = V.where(take_spec, k2l_spec, k2l_diff)
    pbr_diff, pbr_spec, pbr_pdf = _pbr_eval_local(params, k1l, k2l_pbr)
    f_total = pbr_diff + pbr_spec  # includes cos2
    pbr_over_pdf = f_total * (1.0 / torch.clamp(pbr_pdf, min=1e-12))
    pbr_event = torch.where(
        take_spec, BSDF_EVENT_GLOSSY_REFLECTION, BSDF_EVENT_DIFFUSE_REFLECTION
    ).to(torch.int32)
    pbr_valid = (pbr_pdf > 0.0) & (cos1 > 0.0)

    # near-zero roughness: perfect mirror (MDL SPECULAR convention)
    mirror_k2l = Vec3(-k1l.x, -k1l.y, k1l.z)
    is_mirror = params.roughness < _SPECULAR_ROUGHNESS_EPS
    k2l_pbr = V.where(is_mirror, mirror_k2l, k2l_pbr)
    pbr_over_pdf = V.where(is_mirror, _schlick(f0, torch.clamp(cos1, min=1e-6)), pbr_over_pdf)
    pbr_pdf = torch.where(is_mirror, 0.0, pbr_pdf)
    pbr_event = torch.where(is_mirror, BSDF_EVENT_SPECULAR_REFLECTION, pbr_event).to(torch.int32)
    pbr_valid = pbr_valid | (is_mirror & (cos1 > 0.0))

    # ---------------- glass (smooth dielectric)
    cos_i = torch.clamp(cos1, min=1e-6)
    fr, cos_t, tir = fresnel_dielectric(cos_i, ior1, ior2)
    reflect = (u3 < fr) | tir
    k2l_refl = Vec3(-k1l.x, -k1l.y, k1l.z)
    eta_rel = ior1 / ior2
    k2l_refr = V.normalize(Vec3(-eta_rel * k1l.x, -eta_rel * k1l.y, -cos_t))
    # thin_walled: transmission passes STRAIGHT through (MDL thin_walled)
    thin = params.thin_walled
    k2l_thin = Vec3(-k1l.x, -k1l.y, -k1l.z)
    k2l_refr = V.where(thin, k2l_thin, k2l_refr)
    k2l_glass = V.where(reflect, k2l_refl, k2l_refr)
    ones = Vec3(*(torch.ones_like(cos1) for _ in range(3)))
    glass_tint = V.where(reflect, ones, params.glass_color)
    glass_event = torch.where(
        reflect, BSDF_EVENT_SPECULAR_REFLECTION, BSDF_EVENT_SPECULAR_TRANSMISSION
    ).to(torch.int32)
    glass_valid = cos1 > 0.0

    # ---------------- DIFFUSE-only material
    diff_over_pdf = params.diffuse_color  # f*cos/pdf = albedo
    diff_event = torch.full_like(params.bsdf_type, BSDF_EVENT_DIFFUSE_REFLECTION, dtype=torch.int32)
    diff_valid = (cos1 > 0.0) & (k2l_diff.z > 0.0)

    # ---------------- combine by material type
    t = params.bsdf_type
    is_d = t == BsdfType.DIFFUSE
    is_p = t == BsdfType.OMNI_PBR

    k2l = V.where(is_d, k2l_diff, V.where(is_p, k2l_pbr, k2l_glass))
    pdf = torch.where(is_d, pdf_diff, torch.where(is_p, pbr_pdf, 0.0))
    over_pdf = V.where(is_d, diff_over_pdf, V.where(is_p, pbr_over_pdf, glass_tint))
    event = torch.where(is_d, diff_event, torch.where(is_p, pbr_event, glass_event))
    valid = torch.where(is_d, diff_valid, torch.where(is_p, pbr_valid, glass_valid))

    hair_k2_world = None
    if enable_hair:
        from strelka_tpu_torch.ops import hair as HAIR

        is_h = t == BsdfType.HAIR
        # hair directions live on the full sphere: the world-space result
        # bypasses the local -> world remap below
        hair_k2_world, hp, hair_over_pdf, hair_valid = HAIR.hair_sample(params, frame, k1, xi)
        hair_event = torch.full_like(params.bsdf_type, BSDF_EVENT_GLOSSY_REFLECTION, dtype=torch.int32)
        pdf = torch.where(is_h, hp, pdf)
        over_pdf = V.where(is_h, hair_over_pdf, over_pdf)
        event = torch.where(is_h, hair_event, event)
        valid = torch.where(is_h, hair_valid, valid)

    event = torch.where(valid, event, BSDF_EVENT_ABSORB).to(torch.int32)
    over_pdf = V.where(valid, over_pdf, _zeros(cos1))
    k2 = _to_world(frame, k2l)
    if hair_k2_world is not None:
        k2 = V.where(t == BsdfType.HAIR, hair_k2_world, k2)
    return BsdfSample(k2=V.normalize(k2), pdf=pdf, bsdf_over_pdf=over_pdf, event_type=event)
