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

A scene with textures (DeviceScene.textures) adds, per bounce, the ray
cone's footprint at the hit and the texture lookups of shade_textures:
one-texel stochastic trilinear by default, its uniforms hashed from the
sample index, the ray's slot, the bounce and the lookup slot, so that the
port draws the texels the JAX package draws. A scene without textures takes
none of this.

The port follows the JAX package's CPU path: barycentrics from the
intersector, prim ids in the scene's triangle order, the curve parameter
u from the winning cone's axial root. The wavefront is never sorted here:
each lane carries the slot the program gave its pixel (trace_paths'
ray_slot), which is all that the order changes in an image. Reference
quirks kept for image parity:
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

import os
from typing import NamedTuple

import numpy as np
import torch

from refport.ops import bsdf as B
from refport.ops import light_sampling as LS
from refport.ops import sampler as S
from refport.ops import vec as V
from refport.ops.curve_refine import refine_scene_curve_hit
from refport.ops.curves import CurveHit, curve_shading_frame_vec
from refport.ops.intersect import (
    Hit,
    intersect_any,
    intersect_closest,
    intersect_curves_any,
    intersect_curves_closest,
    offset_ray_vec,
)
from refport.ops.vec import Vec3
from refport.render.device_scene import (
    ATTR_JOINED,
    ATTR_LIGHT,
    ATTR_LIGHT_ROW,
    ATTR_MAT_ROW,
    ATTR_N,
    ATTR_T,
    ATTR_UV,
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

    Each field is a host value (an int, a numpy array) or a tensor, on the
    scene's device or not: it is taken through torch.as_tensor onto the
    device, which leaves a tensor already there as it is.

    cone_spread: the ray cone's spread (ray_cone_spread's f32 value, computed
    on the host); None computes it from clip_to_view, which reads that
    matrix on the host."""

    subframe_index: int  # accumulated spp so far
    clip_to_view: np.ndarray  # [4,4] f32
    view_to_world: np.ndarray  # [4,4] f32
    exposure: np.ndarray  # [3] f32
    bg_color: np.ndarray  # [3] f32
    cone_spread: object = None  # f32 value, or None


def f32_on(value, device) -> torch.Tensor:
    """A launch value as an f32 tensor on `device` (a tensor already there
    passes as it is)."""
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def generate_camera_rays(params: LaunchParams, px, py, jx, jy, width: int, height: int):
    """generateCameraRay (OptixRender.cu:38-58). The matrices' entries are
    0-d tensors: a 0-d f32 tensor times a tensor rounds as the f32 value
    times it does, so the rays are those of the entries read on the host.

    Rounded as the JAX package's CPU render rounds it: XLA's CPU backend
    contracts c0 * ndc_x + c1 * ndc_y into fma(c0, ndc_x, c1 * ndc_y), the
    view-to-world product and the length into three-term fma chains
    (V.dot_fma), and drops the matrix-vector product's + 0.0."""
    ndc_x = (px.to(torch.float32) + jx) / width * 2.0 - 1.0
    ndc_y = (py.to(torch.float32) + jy) / height * 2.0 - 1.0
    c2v = f32_on(params.clip_to_view, px.device)
    view = [V.fma(c2v[i, 0], ndc_x, c2v[i, 1] * ndc_y) + c2v[i, 2] + c2v[i, 3] for i in range(3)]
    v2w = f32_on(params.view_to_world, px.device)
    u = [V.dot_fma(v2w[i, :3], view) for i in range(3)]
    inv = 1.0 / torch.clamp(torch.sqrt(V.dot_fma(u, u)), min=1e-20)
    direction = Vec3(*(c * inv for c in u))
    ones = torch.ones_like(ndc_x)
    origin = Vec3(v2w[0, 3] * ones, v2w[1, 3] * ones, v2w[2, 3] * ones)
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
    light_id, rows [68, N], uv), uv being None for a scene without textures
    and else ((u, v), uv_density_log2): the interpolated texture
    coordinates and the prim's log2 sqrt(uv area / world area), which the
    mip selection adds to the ray cone's footprint."""
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
    gcross = V.cross(e1, e2)
    uv = None
    if scene.textures is not None:
        r = lambda i: rows[ATTR_UV + i]  # noqa: E731
        uv_u = r(0) * w0 + r(2) * wu + r(4) * wv
        uv_v = r(1) * w0 + r(3) * wu + r(5) * wv
        # both areas share the 1/2 factor, so the parallelogram ratio is exact
        uv_area2 = torch.abs((r(2) - r(0)) * (r(5) - r(1)) - (r(4) - r(0)) * (r(3) - r(1)))
        world_area2 = V.length(gcross)
        uv_density_log2 = 0.5 * (torch.log2(torch.clamp(uv_area2, min=1e-20))
                                 - torch.log2(torch.clamp(world_area2, min=1e-20)))
        uv = ((uv_u, uv_v), uv_density_log2)
    geom_normal = V.normalize(gcross)
    flip = torch.where(inside, -1.0, 1.0)
    normal = normal * flip
    geom_normal = geom_normal * flip
    binormal = V.cross(normal, tangent)
    frame = B.ShadingFrame(normal=normal, tangent_u=tangent, tangent_v=binormal, geom_normal=geom_normal)
    light_id = rows[ATTR_LIGHT].to(torch.int32)
    return position, frame, light_id, rows, uv


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


def tex_stochastic() -> bool:
    """One-texel stochastic filtering, resolved as the JAX package resolves
    its `tex_stochastic` flag: STRELKA_TEX_STOCHASTIC if set, else on."""
    return True  # the reference keeps the default: no switch is read


def tex_uniforms(sample_idx: torch.Tensor, ray_slot: torch.Tensor, depth: int):
    """The per-lane uniforms of the stochastic texture lookups at one
    bounce: slot -> 3 x [N] f32 (level pick, x pick, y pick). Murmur hashes
    keyed by (sample index, the ray's wavefront slot, bounce, lookup slot):
    decorrelated from the Sobol dimensions and bit-equal to the JAX
    package's draws. ray_slot: [N] int, each lane's slot in the launch's
    wavefront before any sort (trace_paths' ray_id; the lane index when
    nothing is sorted). Under Z-order that slot is the pixel's Z-rank, so
    the card draws other texels than the CPU path, as the reference's
    accelerator path does. The u32 product wraps at 2^32 (mul32)."""
    rid = ray_slot.to(torch.int64)
    seed = S.hash_combine(S.hash_u32(sample_idx), (S.mul32(rid, 2654435761) + depth) & S.M32)

    def to_f(u):
        return (u >> 8).to(torch.float32) * (1.0 / (1 << 24))

    def rnd(slot: int):
        h = S.hash_u32(S.hash_combine(seed, slot + 1))
        # three components from one hash are too short: re-hash each
        h2 = S.hash_u32(h ^ 0x68BC21EB)
        h3 = S.hash_u32(h ^ 0x02E5BE93)
        return (to_f(h), to_f(h2), to_f(h3))

    return rnd


def shade_textures(scene: DeviceScene, mat: B.SurfaceParams, frame: B.ShadingFrame, mat_rows, uv, t_hit,
                   cone_spread: float, sample_idx: torch.Tensor, ray_slot: torch.Tensor, depth: int):
    """Texture lookups modulating material params + normal mapping, at one
    bounce (the tex_lookup path of the MDL runtime,
    texture_support_cuda.h:287-528): the diffuse texture replaces the
    constant color, roughness/metallic textures override their scalars (R
    channel), a normal map perturbs the frame.

    mat_rows: [24, N] material rows (12-15 texture ids, 16-19 the uv
    transform); uv: _gather_surface's ((u, v), uv_density_log2). Lookups
    are trilinear across the mip chain, the footprint the ray cone's at the
    hit (cone_spread * t_hit, t_hit the path length so far) with the prim's
    uv density and the uv transform's scale; one-texel stochastic by
    default (tex_stochastic), its uniforms from tex_uniforms (keyed by
    ray_slot, the lanes' wavefront slots). Lookup slots
    are 0 diffuse, 1 roughness, 2 metallic, 3 normal, as in the JAX
    package; a column that no material row uses (scene.tex_columns) is not
    looked up, which changes no lane: its ids are all -1."""
    from refport.textures import sample_trilinear, sample_trilinear_stochastic

    atlas = scene.textures
    (uv_u, uv_v), uv_density_log2 = uv
    uv_t = torch.stack([uv_u * mat_rows[16] + mat_rows[18], uv_v * mat_rows[17] + mat_rows[19]], -1)
    lod_uv = torch.log2(torch.clamp(t_hit * cone_spread, min=1e-20)) + uv_density_log2
    uv_scale = torch.clamp(torch.maximum(torch.abs(mat_rows[16]), torch.abs(mat_rows[17])), min=1e-8)
    lod_t = lod_uv + torch.log2(uv_scale)
    if tex_stochastic():
        rnd = tex_uniforms(sample_idx, ray_slot, depth)
        tex = lambda tid, slot: sample_trilinear_stochastic(atlas, tid, uv_t, lod_t, rnd(slot))  # noqa: E731
    else:
        tex = lambda tid, slot: sample_trilinear(atlas, tid, uv_t, lod_t)  # noqa: E731
    cols = scene.tex_columns
    if 12 in cols:
        d_id = mat_rows[12].to(torch.int32)
        diff = tex(d_id, 0)
        mat = mat._replace(diffuse_color=V.where(d_id >= 0, Vec3(diff[:, 0], diff[:, 1], diff[:, 2]),
                                                 mat.diffuse_color))
    if 14 in cols:
        r_id = mat_rows[14].to(torch.int32)
        mat = mat._replace(roughness=torch.where(r_id >= 0, tex(r_id, 1)[:, 0], mat.roughness))
    if 15 in cols:
        mt_id = mat_rows[15].to(torch.int32)
        mat = mat._replace(metallic=torch.where(mt_id >= 0, tex(mt_id, 2)[:, 0], mat.metallic))
    if 13 in cols:
        n_id = mat_rows[13].to(torch.int32)
        nt = tex(n_id, 3)
        n_ts = Vec3(nt[:, 0], nt[:, 1], nt[:, 2]) * 2.0 - 1.0
        n_map = V.normalize(frame.tangent_u * n_ts.x + frame.tangent_v * n_ts.y + frame.normal * n_ts.z)
        new_n = V.where(n_id >= 0, n_map, frame.normal)
        frame = frame._replace(normal=new_n, tangent_v=V.cross(new_n, frame.tangent_u))
    return mat, frame


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


# ---- the program's wavefront slots on the card: pixels in Z-order. The
# order changes no untextured image; a textured one draws its stochastic
# texels by wavefront slot (tex_uniforms), which the reference is handed.

# (width, height, device) -> (zorder int64, inverse int32) on the device. Built
# at a size's first (eager) launch and kept, so that a captured launch finds
# them and its graph's addresses stay valid.
_ZORDER_ON_DEVICE: dict = {}


def _part1by1(v: torch.Tensor) -> torch.Tensor:
    """The low 16 bits of v (int64) spread to every other bit."""
    v = v & 0xFFFF
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    return (v | (v << 1)) & 0x55555555


def pixel_zorder(width: int, height: int, device) -> tuple:
    """The reference's _pixel_zorder on `device`: (zorder [n] int64, inv [n]
    int32), zorder[k] the linear index of the k-th pixel in Z-order (Morton
    order of (x, y), any size), inv[p] the rank of pixel p. Built by device
    ops (the Morton codes are distinct, so their sort is the reference's
    stable argsort): no tensor crosses from the host, which a row band's
    launch may not do. Cached per size and device."""
    device = torch.device(device)
    key = (width, height, str(device))
    tables = _ZORDER_ON_DEVICE.get(key)
    if tables is None:
        yy, xx = torch.meshgrid(torch.arange(height, device=device), torch.arange(width, device=device),
                                indexing="ij")
        code = (_part1by1(xx) | (_part1by1(yy) << 1)).reshape(-1)
        zorder = torch.sort(code, stable=True).indices
        n = width * height
        inv = torch.empty(n, dtype=torch.int32, device=device).scatter_(
            0, zorder, torch.arange(n, dtype=torch.int32, device=device))
        tables = (zorder, inv)
        _ZORDER_ON_DEVICE[key] = tables
    return tables


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
    depth0_dims: torch.Tensor,
    cone_spread,
    ray_slot=None,
    lowp: bool = False,
):
    """One path per entry -> (radiance Vec3, first_event [N]).

    ray_slot: [N] int, each entry's wavefront slot in the program's launch
    (the pixel's Z-rank on the card, its row-major index on the CPU), which
    keys a textured scene's texels; None takes the entry's index. lowp: the
    lower-precision control, each bounce's path state (origin, direction,
    radiance, throughput) rounded to bfloat16 before the bounce.

    cone_spread: the ray cone's spread angle a unit of path length (an f32
    value or a 0-d f32 tensor, ray_cone_spread), which sizes a textured
    scene's mip footprint.

    depth0_dims: the depth-0 draw of dimensions (0, 1, 2, 3, 4) at
    sample_idx ([5, N], as S.random_dims gives it), which the caller has
    drawn already (the camera jitter comes from its rows 0 and 1)."""
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
    bg = f32_on(params.bg_color, dev)
    tmin_mat = torch.full((n,), material_ray_tmin, dtype=torch.float32, device=dev)
    tmax_big = torch.full((n,), 1e16, dtype=torch.float32, device=dev)
    has_curves = scene.has_curves
    enable_hair = has_curves or scene.has_hair
    # ray-cone mip selection: the accumulated path length (footprint =
    # cone_spread * t_total at the hit)
    t_total = torch.zeros(n, dtype=torch.float32, device=dev)
    # each lane's wavefront slot, which keys its texels
    ray_id = torch.arange(n, dtype=torch.int32, device=dev) if ray_slot is None else ray_slot.to(torch.int32)

    for depth in range(max_depth):
        if lowp:
            origin, direction, radiance, throughput = (
                Vec3(*(c.to(torch.bfloat16).to(torch.float32) for c in v))
                for v in (origin, direction, radiance, throughput))
        # the 5 folded Sobol dimensions of this bounce in one draw (K1);
        # dimension = Dim % 5, so eBSDF2 and eLightId share dim 2, as in
        # the reference (RandomSampler.h:224)
        dim_rows = depth0_dims if depth == 0 else S.random_dims(sample_idx, depth, (0, 1, 2, 3, 4))
        rnd = lambda dim: dim_rows[int(dim) % 5]  # noqa: E731

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

        position, frame, raw_light_id, attr_rows, uv = _gather_surface(scene, hit, inside)
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
        mat_rows = attr_rows[ATTR_MAT_ROW:ATTR_LIGHT_ROW]
        mat = _material_from_rows(mat_rows)
        if scene.textures is not None:
            # advance the ray cone to this hit (a curve hit by its cone t)
            t_eff = torch.where(is_curve, chit.t, hit.t) if has_curves else hit.t
            t_hit = t_total + torch.where(alive & ~missed, t_eff, 0.0)
            mat, frame = shade_textures(scene, mat, frame, mat_rows, uv, t_hit, cone_spread, sample_idx, ray_id,
                                        depth)
            t_total = t_hit
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

    return radiance, first_event


def ray_cone_spread(params: LaunchParams, height: int) -> float:
    """The ray cone's spread a unit of path length: the per-pixel angle of
    the projection, 2 |clip_to_view[1, 1]| / height (clip_to_view[1, 1] is
    tan(fov_y / 2)), in f32 as the JAX package computes it. On the host: on
    CUDA, dividing a tensor by a Python number multiplies by its f32
    reciprocal, which can be an ulp off this division."""
    c2v = np.asarray(torch.as_tensor(params.clip_to_view).cpu(), np.float32)
    return float(np.float32(2.0) * np.abs(c2v[1, 1]) / np.float32(height))


def _accumulate_planar(history, value, exposure, subframe_index):
    """accumulate() on planar [3,H,W] images (OptixRender.cu:60-78 formula).

    subframe_index: the launch's (an int or a 0-d int tensor), or an [H,W]
    int tensor of per-pixel counts."""
    idx = torch.as_tensor(subframe_index, device=history.device)
    a = (1.0 / (idx.to(torch.float32) + 1.0))[None]

    def tm(c):
        c = c * exposure
        return c / (c + 1.0)

    def itm(c):
        return c / (exposure - c * exposure)

    lerped = itm(tm(history) + (tm(value) - tm(history)) * a)
    return torch.where((idx > 0)[None], lerped, value)
