"""Wavefront path-tracing integrator — the PyTorch port of
strelka_tpu/ops/integrator.py (the replacement for the OptiX megakernel
__raygen__rg, OptixRender.cu:80-248, + __closesthit__radiance,
OptixRender_radiance_closest_hit.cu:456-606).

All W*H*spp rays of a launch advance together through the bounce loop;
branch divergence becomes masked selects. Each bounce runs one Sobol draw
(kernel K1), one closest-hit sweep (radiance rays, mask PRIMARY: K5 over
the scene's BVH, K2 over a flat scene), one attribute-row gather (K4) and
one any-hit sweep (NEE shadow rays, mask SHADOW: K6 or K3); the shading in
between is plain PyTorch on component-major Vec3. A scene with curves adds,
per bounce, the closest round-cone sweep (K7), the Newton refinement of its
winner to the exact swept envelope (ops/curve_refine.py), the curve's
shading frame and material row (a second K4 gather, of mat_table) and the
cone shadow sweep (K8), and turns on the fibre lobes of ops/hair.py.

The port follows the JAX package's CPU path for scenes without textures:
row-major sample order, barycentrics from the intersector, prim ids in the
scene's triangle order (BVH leaf order), the curve parameter u from the
winning cone's axial root, no wavefront sort. Reference quirks kept for
image parity:
  * NEE radiance includes cos(N,L) AND the MDL-style evaluate() also folds
    cos in — the cosine is squared in next-event contributions (cu:306+586).
  * BSDF-hit emitter MIS uses the uniform-area rect pdf regardless of the
    NEE rect sampling method (Lights.h:221-243).
  * lastBsdfPdf = 1.0 for specular events (cu:602-603).
  * Russian roulette starts after depth 3 with 1/(p+1e-5) boost
    (OptixRender.cu:134-142); throughput cutoff |T|^2 < 1e-5 (:144-147).
  * NaN canary paints radiance (1e4,0,0) (cu:552-558, 573-579).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from strelka_tpu_torch.ops import bsdf as B
from strelka_tpu_torch.ops import light_sampling as LS
from strelka_tpu_torch.ops import sampler as S
from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.curve_refine import refine_scene_curve_hit
from strelka_tpu_torch.ops.curves import CurveHit, curve_shading_frame_vec
from strelka_tpu_torch.ops.intersect import (
    Hit,
    intersect_any,
    intersect_closest,
    intersect_curves_any,
    intersect_curves_closest,
    offset_ray_vec,
)
from strelka_tpu_torch.ops.vec import Vec3
from strelka_tpu_torch.render.device_scene import (
    ATTR_JOINED,
    ATTR_LIGHT,
    ATTR_LIGHT_ROW,
    ATTR_MAT_ROW,
    ATTR_N,
    ATTR_T,
    RAY_MASK_PRIMARY,
    RAY_MASK_SHADOW,
    DeviceScene,
)

Dim = S.SampleDimension


class EventType:
    """OptixRenderParams.h:68-76."""

    eUndef = 0
    eAbsorb = 1
    eDiffuse = 2
    eSpecular = 3


class LaunchParams(NamedTuple):
    """Per-launch values (subset of Params, OptixRenderParams.h:38-68).

    Host values: an int and small arrays (numpy or CPU tensors); the launch
    reads the matrices as scalars and uploads exposure/background itself."""

    subframe_index: int  # accumulated spp so far
    clip_to_view: np.ndarray  # [4,4] f32
    view_to_world: np.ndarray  # [4,4] f32
    exposure: np.ndarray  # [3] f32
    bg_color: np.ndarray  # [3] f32


class FrameState(NamedTuple):
    """Accumulation history, PLANAR layout [3, H, W]."""

    accum: torch.Tensor  # [3,H,W] f32
    diffuse: torch.Tensor  # [3,H,W] f32
    diffuse_counter: torch.Tensor  # [H,W] i32 (uint16 in reference)
    specular: torch.Tensor  # [3,H,W] f32
    specular_counter: torch.Tensor  # [H,W] i32


def make_frame_state(height: int, width: int, device) -> FrameState:
    z3 = lambda: torch.zeros((3, height, width), dtype=torch.float32, device=device)  # noqa: E731
    zc = lambda: torch.zeros((height, width), dtype=torch.int32, device=device)  # noqa: E731
    return FrameState(z3(), z3(), zc(), z3(), zc())


def _f32_values(a) -> list:
    """Host f32 values of a small array as Python floats (exact)."""
    return np.asarray(torch.as_tensor(a).cpu(), np.float32).tolist()


def generate_camera_rays(params: LaunchParams, px, py, jx, jy, width: int, height: int):
    """generateCameraRay (OptixRender.cu:38-58)."""
    ndc_x = (px.to(torch.float32) + jx) / width * 2.0 - 1.0
    ndc_y = (py.to(torch.float32) + jy) / height * 2.0 - 1.0
    c2v = _f32_values(params.clip_to_view)
    view = Vec3(*(c2v[i][0] * ndc_x + c2v[i][1] * ndc_y + c2v[i][2] + c2v[i][3] for i in range(3)))
    v2w = _f32_values(params.view_to_world)
    direction = V.normalize(V.matvec(v2w, view))
    ones = torch.ones_like(ndc_x)
    origin = Vec3(v2w[0][3] * ones, v2w[1][3] * ones, v2w[2][3] * ones)
    return origin, direction


def _oct_decode24(code: torch.Tensor) -> Vec3:
    """[N] f32 of 24-bit (12:12) octahedral codes -> unit Vec3."""
    qu = torch.floor(code * (1.0 / 4096.0))
    qv = code - qu * 4096.0
    u = qu * (2.0 / 4094.0) - 1.0
    v = qv * (2.0 / 4094.0) - 1.0
    z = 1.0 - torch.abs(u) - torch.abs(v)
    t = torch.clamp(-z, min=0.0)
    x = u + torch.where(u >= 0.0, -t, t)
    y = v + torch.where(v >= 0.0, -t, t)
    return V.normalize(Vec3(x, y, z))


def _gather_surface(scene: DeviceScene, hit: Hit, inside):
    """fillTriangleGeomData (cu:365-421): interpolate attributes at the hit.

    ONE fat row gather (kernel K4) of the joined attr table per hit; the
    material and hit-light rows ride along. Returns (position, frame,
    light_id, rows [68, N])."""
    prim = torch.clamp(hit.prim, min=0)
    rows = V.gather_rows_t(scene.attr_table, prim)
    wu, wv = hit.u, hit.v
    w0 = 1.0 - wu - wv
    col = lambda a: Vec3(rows[a], rows[a + 1], rows[a + 2])  # noqa: E731
    v0, e1, e2 = col(0), col(3), col(6)
    position = v0 + e1 * wu + e2 * wv
    n0d, n1d, n2d = (_oct_decode24(rows[ATTR_N + i]) for i in range(3))
    t0d, t1d, t2d = (_oct_decode24(rows[ATTR_T + i]) for i in range(3))
    normal = V.normalize(n0d * w0 + n1d * wu + n2d * wv)
    tangent = V.normalize(t0d * w0 + t1d * wu + t2d * wv)
    geom_normal = V.normalize(V.cross(e1, e2))
    flip = torch.where(inside, -1.0, 1.0)
    normal = normal * flip
    geom_normal = geom_normal * flip
    binormal = V.cross(normal, tangent)
    frame = B.ShadingFrame(normal=normal, tangent_u=tangent, tangent_v=binormal, geom_normal=geom_normal)
    light_id = rows[ATTR_LIGHT].to(torch.int32)
    return position, frame, light_id, rows


def _material_from_rows(rows) -> B.SurfaceParams:
    """SurfaceParams from 24 material rows (the material columns joined
    into the attr table)."""
    return B.SurfaceParams(
        bsdf_type=rows[0].to(torch.int32),
        diffuse_color=Vec3(rows[1], rows[2], rows[3]),
        metallic=rows[4],
        roughness=rows[5],
        specular_level=rows[6],
        ior=rows[7],
        glass_color=Vec3(rows[8], rows[9], rows[10]),
        opacity=rows[11],
        emission_color=Vec3(rows[20], rows[21], rows[22]),
        thin_walled=rows[23] > 0.5,
    )


def _gather_material_by_id(scene: DeviceScene, mid) -> B.SurfaceParams:
    """SurfaceParams of material ids: one fat row gather (K4) of mat_table."""
    return _material_from_rows(V.gather_rows_t(scene.mat_table, mid))


def _select_material(mask, a: B.SurfaceParams, b: B.SurfaceParams) -> B.SurfaceParams:
    return B.SurfaceParams(*(
        V.where(mask, x, y) if isinstance(x, Vec3) else torch.where(mask, x, y) for x, y in zip(a, b)
    ))


def closest_curve_hit(scene: DeviceScene, origin: Vec3, direction: Vec3, tmin, tmax, active) -> CurveHit:
    """The closest curve hit of each ray: the round-cone sweep (K7), then,
    if the scene was built for it, the exact swept-B-spline refinement of
    the sweep's winner; ghosts admitted by the inflated radii become misses."""
    chit = intersect_curves_closest(scene, origin, direction, tmin, tmax, active=active)
    if scene.curve_refine:
        rt, ru, keep = refine_scene_curve_hit(scene.curves, origin, direction, chit.t, chit.seg, chit.u)
        chit = CurveHit(t=torch.where(keep, rt, 1e30), seg=torch.where(keep, chit.seg, -1),
                        u=torch.where(keep, ru, 0.0))
    return chit


def curve_surface(scene: DeviceScene, chit: CurveHit, is_curve, origin: Vec3, direction: Vec3, inside,
                  position: Vec3, frame: B.ShadingFrame, mat: B.SurfaceParams):
    """fillCurveGeomData (cu:423-454): on the lanes that hit a curve, the hit
    point, the curve's frame (spine-offset normal, spline tangent) and its
    material row (a K4 gather of mat_table) take the triangle's place."""
    pos_curve = origin + direction * chit.t
    cn, ct, _ = curve_shading_frame_vec(scene.curves, chit.seg, chit.u, pos_curve)
    cn = cn * torch.where(inside, -1.0, 1.0)
    frame = B.ShadingFrame(
        normal=V.where(is_curve, cn, frame.normal),
        tangent_u=V.where(is_curve, ct, frame.tangent_u),
        tangent_v=V.where(is_curve, V.cross(cn, ct), frame.tangent_v),
        geom_normal=V.where(is_curve, cn, frame.geom_normal),
    )
    seg_mat = torch.clamp(scene.curves.material_id[torch.clamp(chit.seg, min=0).to(torch.int64)], min=0)
    mat = _select_material(is_curve, _gather_material_by_id(scene, seg_mat), mat)
    return V.where(is_curve, pos_curve, position), frame, mat


def _light_from_rows(rows) -> LS.LightParams:
    """LightParams from 20 light rows (a light_table gather, a broadcast row
    or the light columns joined into the attr table)."""
    c3 = lambda a: Vec3(rows[a], rows[a + 1], rows[a + 2])  # noqa: E731
    return LS.LightParams(
        p0=c3(0), p1=c3(3), p2=c3(6), p3=c3(9), color=c3(12), normal=c3(15),
        type=rows[18].to(torch.int32), half_angle=rows[19], radius=rows[0],
    )


def _gather_light(scene: DeviceScene, light_id) -> LS.LightParams:
    n = light_id.shape[0]
    if scene.light_table.shape[0] == 1:
        # single light: broadcast its row, no gather at all
        rows = scene.light_table[0][:, None].expand(20, n)
    else:
        lid = torch.clamp(light_id, 0, scene.light_table.shape[0] - 1)
        rows = V.gather_rows_t(scene.light_table, lid)
    return _light_from_rows(rows)


def trace_paths(
    scene: DeviceScene,
    params: LaunchParams,
    sample_idx: torch.Tensor,  # [N] int64 sobol sample indices (u32 values)
    origin: Vec3,
    direction: Vec3,
    *,
    max_depth: int,
    rect_light_sampling_method: int,
    shadow_ray_tmin: float,
    material_ray_tmin: float,
    debug: int,
    collect_stats: bool = False,
):
    """One path per entry -> (radiance Vec3, first_event [N], stats).

    stats (collect_stats) counts the lanes alive at each closest sweep and
    the shadow rays actually cast, summed over bounces (0-d tensors); a
    scene with curves sweeps its cones with the same live lanes, counted
    apart as cone_closest_rays and cone_shadow_rays."""
    if scene.attr_table.shape[1] < ATTR_JOINED:
        raise ValueError("the integrator reads the joined attr table")
    n = sample_idx.shape[0]
    dev = sample_idx.device
    radiance = V.full(n, 0.0, dev)
    throughput = V.full(n, 1.0, dev)
    inside = torch.zeros(n, dtype=torch.bool, device=dev)
    specular_bounce = torch.zeros(n, dtype=torch.bool, device=dev)
    last_bsdf_pdf = torch.zeros(n, dtype=torch.float32, device=dev)
    first_event = torch.zeros(n, dtype=torch.int32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    # primitive the ray originates from: rejected BY ID in the intersector
    prev_prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    num_lights = scene.num_lights
    bg = _f32_values(params.bg_color)
    tmin_mat = torch.full((n,), material_ray_tmin, dtype=torch.float32, device=dev)
    tmax_big = torch.full((n,), 1e16, dtype=torch.float32, device=dev)
    stat_closest = torch.zeros((), dtype=torch.float32, device=dev)
    stat_shadow = torch.zeros((), dtype=torch.float32, device=dev)
    has_curves = scene.has_curves
    enable_hair = has_curves or scene.has_hair

    for depth in range(max_depth):
        # the 5 folded Sobol dimensions of this bounce in one draw (K1);
        # dimension = Dim % 5, so eBSDF2 and eLightId share dim 2, as in
        # the reference (RandomSampler.h:224)
        dim_rows = S.random_dims(sample_idx, depth, (0, 1, 2, 3, 4))
        rnd = lambda dim: dim_rows[int(dim) % 5]  # noqa: E731

        if collect_stats:
            stat_closest = stat_closest + alive.to(torch.float32).sum()
        hit = intersect_closest(
            scene, origin, direction, tmin_mat, tmax_big, RAY_MASK_PRIMARY,
            active=alive, exclude=prev_prim,
        )
        # curve (hair) primitives: the round-cone sweep, the closest of
        # triangle and curve wins
        is_curve = torch.zeros(n, dtype=torch.bool, device=dev)
        if has_curves:
            chit = closest_curve_hit(scene, origin, direction, tmin_mat, tmax_big, alive)
            is_curve = alive & (chit.seg >= 0) & (chit.t < hit.t)
        missed = alive & (hit.prim < 0) & ~is_curve

        # __miss__ms (cu:250-257)
        radiance = V.where(missed, radiance + throughput * Vec3(bg[0], bg[1], bg[2]), radiance)
        throughput = V.where(missed, V.full(n, 0.0, dev), throughput)

        position, frame, raw_light_id, attr_rows = _gather_surface(scene, hit, inside)
        prim_light_id = torch.where(hit.prim >= 0, raw_light_id, -1)
        hit_light = alive & ~missed & (prim_light_id >= 0) & ~is_curve
        hit_surface = alive & ~missed & ~hit_light

        # ---- __closesthit__light (cu:315-341)
        if num_lights > 0:
            lp = _light_from_rows(attr_rows[ATTR_LIGHT_ROW:ATTR_JOINED])
            hit_point_l = origin + direction * hit.t
            light_n = LS.calc_light_normal(lp, hit_point_l)
            cos_l = -V.dot(direction, light_n)
            direct_vis = specular_bounce if depth > 0 else torch.ones_like(specular_bounce)
            light_pdf_hit = LS.get_light_pdf(lp, hit_point_l, origin) / num_lights
            mis_w = LS.mis_weight_balance(torch.clamp(last_bsdf_pdf, min=1e-20), light_pdf_hit)
            w = cos_l * torch.where(direct_vis, 1.0, mis_w)
            add = hit_light & (cos_l > 0.0)
            radiance = V.where(add, radiance + throughput * lp.color * w, radiance)
        throughput = V.where(hit_light, V.full(n, 0.0, dev), throughput)

        # ---- __closesthit__radiance (surface shading)
        mat = _material_from_rows(attr_rows[ATTR_MAT_ROW:ATTR_LIGHT_ROW])
        if has_curves:
            position, frame, mat = curve_surface(scene, chit, is_curve, origin, direction, inside, position, frame,
                                                 mat)

        if debug == 1:
            normals_col = (frame.normal + 1.0) * 0.5
            radiance = V.where(hit_surface, normals_col, radiance)
            first_event = torch.where(hit_surface, EventType.eUndef, first_event).to(torch.int32)
            break

        # ---- emissive materials (EDF): added on every BSDF/camera hit, no
        # MIS; the cutout decision comes first (a pass-through collects none)
        u_cut = S.uniform_hash(sample_idx, depth)
        cut = hit_surface & (mat.opacity < 1.0) & (u_cut >= mat.opacity)
        emissive = hit_surface & ~cut & V.any_nonzero(mat.emission_color)
        front = V.dot(frame.geom_normal, direction) < 0.0
        radiance = V.where(emissive & front, radiance + throughput * mat.emission_color, radiance)

        ior1 = torch.where(inside, mat.ior, 1.0)
        ior2 = torch.where(inside, 1.0, mat.ior)
        xi = (rnd(Dim.eBSDF0), rnd(Dim.eBSDF1), rnd(Dim.eBSDF2), rnd(Dim.eBSDF3))
        k1 = -direction
        smp = B.bsdf_sample(mat, frame, k1, xi, ior1, ior2, enable_hair=enable_hair)

        # ---- stochastic alpha cutout (opacity < 1): pass straight through
        # as a specular-transmission event without flipping the medium
        ones3 = V.full(n, 1.0, dev)
        smp = B.BsdfSample(
            k2=V.where(cut, direction, smp.k2),
            pdf=torch.where(cut, 0.0, smp.pdf),
            bsdf_over_pdf=V.where(cut, ones3, smp.bsdf_over_pdf),
            event_type=torch.where(cut, B.BSDF_EVENT_SPECULAR_TRANSMISSION, smp.event_type).to(torch.int32),
        )

        absorbed = hit_surface & (smp.event_type == B.BSDF_EVENT_ABSORB)
        if depth == 0:
            first_event = torch.where(absorbed, EventType.eAbsorb, first_event)
            first_event = torch.where(
                hit_surface & ((smp.event_type & B.BSDF_EVENT_DIFFUSE) != 0), EventType.eDiffuse, first_event
            )
            first_event = torch.where(
                hit_surface & ((smp.event_type & B.BSDF_EVENT_GLOSSY) != 0), EventType.eSpecular, first_event
            ).to(torch.int32)
        throughput = V.where(absorbed, V.full(n, 0.0, dev), throughput)
        shade = hit_surface & ~absorbed
        specular_bounce = torch.where(shade, (smp.event_type & B.BSDF_EVENT_SPECULAR) != 0, specular_bounce)

        # ---- NEE (estimateDirectLighting, cu:312-324 + sampleLight :260-310)
        if num_lights > 0:
            nee_able = shade & ((smp.event_type & (B.BSDF_EVENT_DIFFUSE | B.BSDF_EVENT_GLOSSY)) != 0)
            u_l = rnd(Dim.eLightId)
            light_id = torch.clamp((num_lights * u_l).to(torch.int32), 0, num_lights - 1)
            lp = _gather_light(scene, light_id)
            ls = LS.sample_light(
                lp, rnd(Dim.eLightPointX), rnd(Dim.eLightPointY), position, rect_light_sampling_method
            )
            to_light = ls.L
            li_all_nonzero = V.all_nonzero(lp.color)
            cos_nl = V.dot(frame.normal, to_light)
            geom_ok = (cos_nl > 0.0) & (-V.dot(to_light, ls.normal) > 0.0) & li_all_nonzero
            shadow_org = offset_ray_vec(position, frame.geom_normal)
            shadow_excl = torch.where(is_curve, -1, hit.prim)  # a curve hit excludes no triangle
            if collect_stats:
                stat_shadow = stat_shadow + (nee_able & geom_ok).to(torch.float32).sum()
            shadow_tmin = torch.full((n,), shadow_ray_tmin, dtype=torch.float32, device=dev)
            occluded = intersect_any(
                scene, shadow_org, to_light, shadow_tmin,
                ls.dist_to_light, RAY_MASK_SHADOW, active=nee_able & geom_ok, exclude=shadow_excl,
            )
            if has_curves:
                occluded = occluded | intersect_curves_any(
                    scene, shadow_org, to_light, shadow_tmin, ls.dist_to_light, active=nee_able & geom_ok)
            visibility = torch.where(geom_ok & ~occluded, 1.0, 0.0)
            nee_w = visibility * torch.clamp(cos_nl, 0.0, 1.0)
            nee_radiance = lp.color * nee_w

            # NaN canary #1 (cu:552-558)
            light_pdf = torch.where(geom_ok, ls.pdf, 0.0) * (1.0 / num_lights)
            nan1 = nee_able & (V.any_nan(nee_radiance) | torch.isnan(light_pdf))

            next_event_valid = ((cos_nl > 0.0) != inside) & (light_pdf != 0.0) & nee_able
            ev = B.bsdf_evaluate(mat, frame, k1, to_light, enable_hair=enable_hair)
            nan2 = nee_able & (V.any_nan(ev.bsdf_diffuse) | V.any_nan(ev.bsdf_glossy))
            contribute = next_event_valid & (ev.pdf > 0.0) & ~nan1 & ~nan2
            inv_lpdf = 1.0 / torch.clamp(light_pdf, min=1e-20)
            mis_w = LS.mis_weight_balance(torch.clamp(light_pdf, min=1e-20), ev.pdf)
            nee_contrib = throughput * nee_radiance * (inv_lpdf * mis_w) * (ev.bsdf_diffuse + ev.bsdf_glossy)
            radiance = V.where(contribute, radiance + nee_contrib, radiance)
            # canary: radiance = (1e4, 0, 0), kill
            canary = nan1 | nan2
            radiance = V.where(canary, V.splat((1e4, 0.0, 0.0), n, dev), radiance)
            throughput = V.where(canary, V.full(n, 0.0, dev), throughput)
            shade = shade & ~canary

        # ---- next segment setup (cu:591-605)
        transmission = (smp.event_type & B.BSDF_EVENT_TRANSMISSION) != 0
        offset_n = V.where(transmission, -frame.geom_normal, frame.geom_normal)
        new_origin = offset_ray_vec(position, offset_n)
        origin = V.where(shade, new_origin, origin)
        direction = V.where(shade, smp.k2, direction)
        prev_prim = torch.where(shade, torch.where(is_curve, -1, hit.prim), prev_prim)
        # cutout pass-through and thin-walled transmission stay in the same
        # medium; only real refraction through a closed interface flips it
        flips = shade & transmission & ~cut & ~mat.thin_walled
        inside = torch.where(flips, ~inside, inside)
        last_bsdf_pdf = torch.where(
            shade, torch.where((smp.event_type & B.BSDF_EVENT_SPECULAR) != 0, 1.0, smp.pdf), last_bsdf_pdf
        )
        throughput = V.where(shade, throughput * smp.bsdf_over_pdf, throughput)

        # ---- Russian roulette (OptixRender.cu:134-147)
        if depth > 3:
            p = V.vmax(throughput)
            kill_rr = rnd(Dim.eRussianRoulette) > p
            throughput = V.where(kill_rr, throughput, throughput * (1.0 / (p + 1e-5)))
            alive = alive & ~kill_rr
        alive = alive & (V.dot(throughput, throughput) >= 1e-5)

    stats = None
    if collect_stats:
        zero = torch.zeros_like(stat_closest)
        stats = {"closest_rays": stat_closest, "shadow_rays": stat_shadow,
                 "cone_closest_rays": stat_closest if has_curves else zero,
                 "cone_shadow_rays": stat_shadow if has_curves else zero}
    return radiance, first_event, stats


def render_launch(
    scene: DeviceScene,
    params: LaunchParams,
    state: FrameState,
    *,
    width: int,
    height: int,
    samples_per_launch: int,
    max_sample_count: int,
    max_depth: int,
    enable_accumulation: bool,
    rect_light_sampling_method: int = 0,
    shadow_ray_tmin: float = 0.0,
    material_ray_tmin: float = 0.0,
    debug: int = 0,
    collect_stats: bool = False,
):
    """__raygen__rg equivalent: run samples_per_launch paths per pixel, update
    the accumulators, return (new_state, hdr_image [3,H,W]) (+ stats).

    Runs on the scene's device. Tonemapping is the Render layer's job."""
    dev = scene.device
    n = width * height
    spl = 1 if debug == 1 else samples_per_launch

    # all samples of the launch ride ONE wavefront of spl*W*H rays, pixels
    # in row-major order (the CPU reference's order)
    idx = torch.arange(n, dtype=torch.int64, device=dev)
    px = (idx % width).repeat(spl)
    py = (idx // width).repeat(spl)
    s_of_ray = torch.arange(spl, dtype=torch.int64, device=dev).repeat_interleave(n)
    sample_index = (int(params.subframe_index) + s_of_ray) & S.M32
    sample_idx = S.make_sample_index(px, py, sample_index, max_sample_count)
    jxy = S.random_dims(sample_idx, 0, (Dim.ePixelX, Dim.ePixelY))
    origin, direction = generate_camera_rays(params, px, py, jxy[0], jxy[1], width, height)
    radiance, first_event, stats = trace_paths(
        scene, params, sample_idx, origin, direction,
        max_depth=max_depth,
        rect_light_sampling_method=rect_light_sampling_method,
        shadow_ray_tmin=shadow_ray_tmin,
        material_ray_tmin=material_ray_tmin,
        debug=debug,
        collect_stats=collect_stats,
    )
    # [spl*n] components -> [spl, n] -> reduce over samples
    rad = Vec3(*[c.reshape(spl, n) for c in radiance])
    fe = first_event.reshape(spl, n)
    result = Vec3(rad.x.sum(0), rad.y.sum(0), rad.z.sum(0))
    is_d = fe == EventType.eDiffuse
    is_s = fe == EventType.eSpecular
    dsum = Vec3(*[torch.where(is_d, c, 0.0).sum(0) for c in rad])
    ssum = Vec3(*[torch.where(is_s, c, 0.0).sum(0) for c in rad])
    dcount = is_d.to(torch.int32).sum(0, dtype=torch.int32)
    scount = is_s.to(torch.int32).sum(0, dtype=torch.int32)

    img = lambda v: torch.stack([v.x, v.y, v.z]).reshape(3, height, width)  # noqa: E731
    result_img = img(result * (1.0 / spl))
    dcount2 = dcount.reshape(height, width)
    scount2 = scount.reshape(height, width)
    d_mean = img(dsum) / torch.clamp(dcount2, min=1)
    s_mean = img(ssum) / torch.clamp(scount2, min=1)

    exposure = torch.as_tensor(np.asarray(params.exposure, np.float32), device=dev).reshape(3, 1, 1)
    sub = int(params.subframe_index)

    # --- diffuse/specular AOV accumulation (OptixRender.cu:157-210)
    zc = torch.zeros_like(dcount2)
    prev_d = state.diffuse_counter if sub > 0 else zc
    prev_s = state.specular_counter if sub > 0 else zc
    new_diffuse = torch.where(
        (dcount2 > 0)[None],
        _accumulate_planar(state.diffuse, d_mean, exposure, prev_d),
        torch.zeros_like(state.diffuse) if sub == 0 else state.diffuse,
    )
    new_dcount = torch.where(dcount2 > 0, prev_d + dcount2, zc if sub == 0 else state.diffuse_counter)
    new_specular = torch.where(
        (scount2 > 0)[None],
        _accumulate_planar(state.specular, s_mean, exposure, prev_s),
        torch.zeros_like(state.specular) if sub == 0 else state.specular,
    )
    new_scount = torch.where(scount2 > 0, prev_s + scount2, zc if sub == 0 else state.specular_counter)

    # --- main accumulation (OptixRender.cu:223-247)
    if enable_accumulation and debug == 0:
        new_accum = _accumulate_planar(state.accum, result_img, exposure, sub)
        image = new_accum
    else:
        new_accum = state.accum
        image = result_img

    if debug == 2:
        image = new_diffuse
    elif debug == 3:
        image = torch.where((new_scount > 0)[None], new_specular, 0.0)

    new_state = FrameState(
        accum=new_accum,
        diffuse=new_diffuse,
        diffuse_counter=new_dcount.to(torch.int32),
        specular=new_specular,
        specular_counter=new_scount.to(torch.int32),
    )
    if collect_stats:
        return new_state, image, stats
    return new_state, image


def _accumulate_planar(history, value, exposure, subframe_index):
    """accumulate() on planar [3,H,W] images (OptixRender.cu:60-78 formula).

    subframe_index: an int, or an [H,W] int tensor of per-pixel counts."""
    if isinstance(subframe_index, torch.Tensor):
        idx = subframe_index
    else:
        idx = torch.full(history.shape[1:], int(subframe_index), dtype=torch.int32, device=history.device)
    a = (1.0 / (idx.to(torch.float32) + 1.0))[None]

    def tm(c):
        c = c * exposure
        return c / (c + 1.0)

    def itm(c):
        return c / (exposure - c * exposure)

    lerped = itm(tm(history) + (tm(value) - tm(history)) * a)
    return torch.where((idx > 0)[None], lerped, value)
