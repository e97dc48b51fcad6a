"""Light sampling library — the PyTorch port of strelka_tpu/ops/light_sampling.py
(itself a vectorized port of include/render/Lights.h).

Light types: 0 rect, 1 disc, 2 sphere, 3 distant. All vectors are
component-major Vec3 (ops/vec.py). Every lane computes every light-type
formula and picks by type with masked selects, as the JAX package does,
so the arithmetic matches it term by term.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.vec import Vec3

M_PI = 3.14159265358979323846


class LightParams(NamedTuple):
    """Per-ray gathered UniformLight fields (Lights.h:5-14)."""

    p0: Vec3
    p1: Vec3
    p2: Vec3
    p3: Vec3
    color: Vec3
    normal: Vec3
    type: torch.Tensor  # [N] int32
    half_angle: torch.Tensor  # [N]
    radius: torch.Tensor  # [N] == points[0].x for disc/sphere


class LightSampleData(NamedTuple):
    """Lights.h:16-26."""

    point_on_light: Vec3
    pdf: torch.Tensor
    normal: Vec3
    area: torch.Tensor
    L: Vec3
    dist_to_light: torch.Tensor


def light_from_rows(rows) -> LightParams:
    """LightParams from 20 light rows (a light_table gather, a broadcast row
    or the light columns joined into the attr table)."""
    c3 = lambda a: Vec3(rows[a], rows[a + 1], rows[a + 2])  # noqa: E731
    return LightParams(
        p0=c3(0), p1=c3(3), p2=c3(6), p3=c3(9), color=c3(12), normal=c3(15),
        type=rows[18].to(torch.int32), half_angle=rows[19], radius=rows[0],
    )


def light_rows(light_table: torch.Tensor, light_id: torch.Tensor) -> torch.Tensor:
    """The [20, N] rows of each lane's light in the [L, 20] light table: a
    broadcast of the one row of a single light, else a row gather (kernel
    K4 on the card) at the ids clamped to the table."""
    n = light_id.shape[0]
    if light_table.shape[0] == 1:
        return light_table[0][:, None].expand(20, n)
    return V.gather_rows_t(light_table, torch.clamp(light_id, 0, light_table.shape[0] - 1))


def gather_light(light_table: torch.Tensor, light_id: torch.Tensor) -> LightParams:
    return light_from_rows(light_rows(light_table, light_id))


def mis_weight_balance(a, b):
    """Lights.h:28-31 (note: NOT guarded against a==0; callers guard)."""
    return 1.0 / (1.0 + b / a)


def _zero(t):
    return torch.zeros_like(t, dtype=torch.float32)


def calc_light_area(lp: LightParams):
    """Lights.h:33-52."""
    e1 = lp.p1 - lp.p0
    e2 = lp.p3 - lp.p0
    rect_area = V.length(V.cross(e1, e2))
    disc_area = M_PI * lp.radius * lp.radius
    sphere_area = 4.0 * M_PI * lp.radius * lp.radius
    return torch.where(
        lp.type == 0,
        rect_area,
        torch.where(lp.type == 1, disc_area, torch.where(lp.type == 2, sphere_area, 0.0)),
    )


def calc_light_normal(lp: LightParams, hit_point: Vec3) -> Vec3:
    """Lights.h:54-74."""
    e1 = lp.p1 - lp.p0
    e2 = lp.p3 - lp.p0
    rect_n = -V.normalize(V.cross(e1, e2))
    sphere_n = V.normalize(hit_point - lp.p1)
    z = _zero(lp.half_angle)
    zero = Vec3(z, z, z)
    return V.where(
        lp.type == 0,
        rect_n,
        V.where(lp.type == 1, lp.normal, V.where(lp.type == 2, sphere_n, zero)),
    )


class SphQuad(NamedTuple):
    """Urena spherical rectangle precomputation (Lights.h:86-161)."""

    o: Vec3
    x: Vec3
    y: Vec3
    z: Vec3
    z0: torch.Tensor
    z0sq: torch.Tensor
    x0: torch.Tensor
    y0: torch.Tensor
    y0sq: torch.Tensor
    x1: torch.Tensor
    y1: torch.Tensor
    y1sq: torch.Tensor
    b0: torch.Tensor
    b1: torch.Tensor
    b0sq: torch.Tensor
    k: torch.Tensor
    S: torch.Tensor


def sph_quad_init(lp: LightParams, o: Vec3) -> SphQuad:
    """Lights.h:97-161."""
    ex = lp.p1 - lp.p0
    ey = lp.p3 - lp.p0
    s = lp.p0
    exl = V.length(ex)
    eyl = V.length(ey)
    x = ex * (1.0 / torch.clamp(exl, min=1e-20))
    y = ey * (1.0 / torch.clamp(eyl, min=1e-20))
    z = V.cross(x, y)
    d = s - o
    z0 = V.dot(d, z)
    flip = z0 > 0
    z = V.where(flip, -z, z)
    z0 = torch.where(flip, -z0, z0)
    x0 = V.dot(d, x)
    y0 = V.dot(d, y)
    x1 = x0 + exl
    y1 = y0 + eyl
    v00 = Vec3(x0, y0, z0)
    v01 = Vec3(x0, y1, z0)
    v10 = Vec3(x1, y0, z0)
    v11 = Vec3(x1, y1, z0)
    n0 = V.normalize(V.cross(v00, v10))
    n1 = V.normalize(V.cross(v10, v11))
    n2 = V.normalize(V.cross(v11, v01))
    n3 = V.normalize(V.cross(v01, v00))
    g0 = torch.arccos(torch.clamp(-V.dot(n0, n1), -1.0, 1.0))
    g1 = torch.arccos(torch.clamp(-V.dot(n1, n2), -1.0, 1.0))
    g2 = torch.arccos(torch.clamp(-V.dot(n2, n3), -1.0, 1.0))
    g3 = torch.arccos(torch.clamp(-V.dot(n3, n0), -1.0, 1.0))
    b0 = n0.z
    b1 = n2.z
    k = 2.0 * M_PI - g2 - g3
    s_solid = g0 + g1 - k
    return SphQuad(o, x, y, z, z0, z0 * z0, x0, y0, y0 * y0, x1, y1, y1 * y1, b0, b1, b0 * b0, k, s_solid)


def sph_quad_sample(q: SphQuad, u, v) -> Vec3:
    """Lights.h:163-189."""
    au = u * q.S + q.k
    sin_au = torch.sin(au)
    fu = (torch.cos(au) * q.b0 - q.b1) / torch.where(torch.abs(sin_au) > 1e-20, sin_au, 1e-20)
    cu = 1.0 / torch.sqrt(fu * fu + q.b0sq) * torch.where(fu > 0.0, 1.0, -1.0)
    cu = torch.clamp(cu, -1.0, 1.0)
    xu = -(cu * q.z0) / torch.sqrt(torch.clamp(1.0 - cu * cu, min=1e-20))
    xu = torch.minimum(torch.maximum(xu, q.x0), q.x1)
    d = torch.sqrt(xu * xu + q.z0sq)
    h0 = q.y0 / torch.sqrt(d * d + q.y0sq)
    h1 = q.y1 / torch.sqrt(d * d + q.y1sq)
    hv = h0 + v * (h1 - h0)
    hv2 = hv * hv
    yv = torch.where(hv < 1.0 - 1e-5, (hv * d) / torch.sqrt(torch.clamp(1.0 - hv2, min=1e-20)), q.y1)
    return q.o + q.x * xu + q.y * yv + q.z * q.z0


def _fill_light_data(lp: LightParams, hit_point: Vec3, point_on_light: Vec3):
    """Lights.h:76-84."""
    area = calc_light_area(lp)
    n = calc_light_normal(lp, hit_point)
    to_light = point_on_light - hit_point
    dist = V.length(to_light)
    L = to_light * (1.0 / torch.clamp(dist, min=1e-20))
    return area, n, L, dist


def sample_rect_light_uniform(lp: LightParams, u, v, hit_point: Vec3) -> LightSampleData:
    """Lights.h:277-289: uniform area sample + area->solid-angle pdf."""
    e1 = lp.p1 - lp.p0
    e2 = lp.p3 - lp.p0
    pol = lp.p0 + e1 * u + e2 * v
    area, n, L, dist = _fill_light_data(lp, hit_point, pol)
    pdf = dist * dist / (-V.dot(L, n) * area)
    return LightSampleData(pol, pdf, n, area, L, dist)


def sample_rect_light_sphquad(lp: LightParams, u, v, hit_point: Vec3) -> LightSampleData:
    """Lights.h:245-275: Urena solid-angle sampling with small-S fallbacks."""
    q = sph_quad_init(lp, hit_point)
    uni = sample_rect_light_uniform(lp, u, v, hit_point)
    pol = sph_quad_sample(q, u, v)
    area, n, L, dist = _fill_light_data(lp, hit_point, pol)
    use_sph = q.S >= 1e-3
    out = LightSampleData(
        point_on_light=V.where(use_sph, pol, uni.point_on_light),
        pdf=torch.where(use_sph, 1.0 / torch.clamp(q.S, min=1e-20), uni.pdf),
        normal=V.where(use_sph, n, uni.normal),
        area=torch.where(use_sph, area, uni.area),
        L=V.where(use_sph, L, uni.L),
        dist_to_light=torch.where(use_sph, dist, uni.dist_to_light),
    )
    return out._replace(pdf=torch.where(q.S <= 0.0, 0.0, out.pdf))


def create_coordinate_system(n: Vec3):
    """Lights.h:291-300."""
    use_x = torch.abs(n.x) > torch.abs(n.y)
    inv_len_x = 1.0 / torch.sqrt(n.x * n.x + n.z * n.z + 1e-20)
    inv_len_y = 1.0 / torch.sqrt(n.y * n.y + n.z * n.z + 1e-20)
    nt = Vec3(
        torch.where(use_x, -n.z * inv_len_x, 0.0),
        torch.where(use_x, 0.0, n.z * inv_len_y),
        torch.where(use_x, n.x * inv_len_x, -n.y * inv_len_y),
    )
    nb = V.cross(n, nt)
    return nt, nb


def sample_sphere_light(lp: LightParams, u, v, hit_point: Vec3) -> LightSampleData:
    """Visible-cap solid-angle sampling of a sphere light (the JAX package's
    deliberate deviation from Lights.h:335-362; see its docstring)."""
    c = lp.p1 - hit_point
    d = V.length(c)
    d_safe = torch.clamp(d, min=1e-20)
    axis = c * (1.0 / d_safe)
    sin_a = torch.clamp(lp.radius / d_safe, 0.0, 1.0)
    cos_a = torch.sqrt(torch.clamp(1.0 - sin_a * sin_a, min=0.0))
    # 1-cos_a computed stably as sin^2/(1+cos)
    one_minus_cos = sin_a * sin_a / (1.0 + cos_a)
    phi = 2.0 * M_PI * u
    cos_t = 1.0 - v * one_minus_cos
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    tu, tv = create_coordinate_system(axis)
    L = V.normalize(tu * (torch.cos(phi) * sin_t) + tv * (torch.sin(phi) * sin_t) + axis * cos_t)
    disc = torch.clamp(lp.radius * lp.radius - d * d * sin_t * sin_t, min=0.0)
    dist = torch.clamp(d * cos_t - torch.sqrt(disc), min=0.0)
    light_point = hit_point + L * dist
    normal = V.normalize(light_point - lp.p1)
    outside = d > lp.radius
    pdf = torch.where(outside, 1.0 / (2.0 * M_PI * torch.clamp(one_minus_cos, min=1e-12)), 0.0)
    return LightSampleData(light_point, pdf, normal, torch.zeros_like(pdf), L, dist)


def sample_cone(u, v, angle, direction: Vec3):
    """Lights.h:302-317."""
    phi = 2.0 * M_PI * u
    cos_theta = 1.0 - v * (1.0 - torch.cos(angle))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    tu, tv = create_coordinate_system(direction)
    d = V.normalize(tu * (torch.cos(phi) * sin_theta) + tv * (torch.sin(phi) * sin_theta)
                    + direction * cos_theta)
    pdf = 1.0 / (2.0 * M_PI * (1.0 - torch.cos(angle)))
    return d, pdf


def sample_distant_light(lp: LightParams, u, v) -> LightSampleData:
    """Lights.h:319-333."""
    cone, pdf = sample_cone(u, v, lp.half_angle, -lp.normal)
    return LightSampleData(
        point_on_light=cone,
        pdf=pdf,
        normal=lp.normal,
        area=torch.zeros_like(pdf),
        L=cone,
        dist_to_light=torch.full_like(u, 1e9),
    )


def sample_light(lp: LightParams, u, v, hit_point: Vec3, rect_sampling_method: int) -> LightSampleData:
    """Type dispatch (closest-hit sampleLight, cu:260-310) as masked selects.

    Disc lights (type 1) are not sampled by the reference either -> pdf 0.
    """
    if rect_sampling_method == 0:
        rect = sample_rect_light_uniform(lp, u, v, hit_point)
    else:
        rect = sample_rect_light_sphquad(lp, u, v, hit_point)
    sphere = sample_sphere_light(lp, u, v, hit_point)
    distant = sample_distant_light(lp, u, v)
    t = lp.type
    z = _zero(u)
    zero = Vec3(z, z, z)

    def sel_v(r, s, d):
        return V.where(t == 0, r, V.where(t == 2, s, V.where(t == 3, d, zero)))

    def sel_s(r, s, d):
        return torch.where(t == 0, r, torch.where(t == 2, s, torch.where(t == 3, d, 0.0)))

    out = LightSampleData(
        point_on_light=sel_v(rect.point_on_light, sphere.point_on_light, distant.point_on_light),
        pdf=sel_s(rect.pdf, sphere.pdf, distant.pdf),
        normal=sel_v(rect.normal, sphere.normal, distant.normal),
        area=sel_s(rect.area, sphere.area, distant.area),
        L=sel_v(rect.L, sphere.L, distant.L),
        dist_to_light=sel_s(rect.dist_to_light, sphere.dist_to_light, distant.dist_to_light),
    )
    return out._replace(pdf=torch.where(t == 1, 0.0, out.pdf))


def get_light_pdf(lp: LightParams, light_hit_point: Vec3, surface_hit_point: Vec3):
    """Lights.h:221-243 — pdf used for MIS on BSDF-sampled emitter hits.

    Reference quirk kept: rect lights use the UNIFORM area pdf here even
    when NEE sampled with the spherical-quad method (Lights.h:201-209).
    """
    area, n, L, dist = _fill_light_data(lp, surface_hit_point, light_hit_point)
    rect_pdf = dist * dist / (V.dot(-L, n) * area)
    dc = V.length(lp.p1 - surface_hit_point)
    sin_a = torch.clamp(lp.radius / torch.clamp(dc, min=1e-20), 0.0, 1.0)
    cos_a = torch.sqrt(torch.clamp(1.0 - sin_a * sin_a, min=0.0))
    one_minus_cos = sin_a * sin_a / (1.0 + cos_a)
    sphere_pdf = torch.where(
        dc > lp.radius, 1.0 / (2.0 * M_PI * torch.clamp(one_minus_cos, min=1e-12)), 0.0
    )
    distant_pdf = 1.0 / (2.0 * M_PI * (1.0 - torch.cos(lp.half_angle)))
    return torch.where(
        lp.type == 0,
        rect_pdf,
        torch.where(lp.type == 2, sphere_pdf, torch.where(lp.type == 3, distant_pdf, 0.0)),
    )
