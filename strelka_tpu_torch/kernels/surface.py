"""Kernel K13: one bounce's surface phase of the integrator, less its texture
lookups, in one pass.

The phase is bounce.surface in ops/integrator.py:trace_paths, from the
closest sweeps' outputs to the inputs of the texture lookups and of K10: on
a scene with curves the refinement of the cone sweep's winner to the exact
swept envelope (ops/curve_refine.py) and the curve test, the miss and its
background, the hit triangle's attributes from its row of the joined attr
table (fillTriangleGeomData: position, the octahedral normal and tangent,
the geometric normal, the `inside` flip, the binormal, the light id and, on
a textured scene, the interpolated uv and the prim's uv density), the light
hit (__closesthit__light: the light's normal and pdf, the balance
heuristic), the material of the row, on a scene with curves the curve's
point, frame and material (fillCurveGeomData), and on a textured scene the
ray cone's path length at the hit. The JAX package leaves this phase to XLA,
so K13 has no Pallas counterpart. The CUDA source is csrc/surface.cu.

The texture lookups stay plain PyTorch after it (ops/integrator.py:
shade_textures). The phase once ran them before the curve step; here the
curve step comes first and the lookups get the texture rows with the ids set
to -1 on the lanes that hit a curve, so they change no such lane (their
normal map's cross(normal, tangent_u) gives the curve's own tangent_v). The
plain version, shade_surface_plain, is the phase's former code in that order.

K13 is bit-equal to shade_surface_plain on the card on every lane and every
output. One kernel instance per (curves, refine, uv): the curve step by
whether the launch hands it the cone sweep's hits (a scene with curves), the
refinement by the scene's curve_refine, the uv outputs by whether the scene
has textures (tables_of).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import lanes as L
from strelka_tpu_torch.ops import bsdf as B
from strelka_tpu_torch.ops import light_sampling as LS
from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.curve_refine import refine_scene_curve_hit
from strelka_tpu_torch.ops.curves import CurveHit, curve_shading_frame_vec
from strelka_tpu_torch.ops.intersect import Hit
from strelka_tpu_torch.ops.vec import Vec3
from strelka_tpu_torch.render.device_scene import (
    ATTR_JOINED,
    ATTR_LIGHT,
    ATTR_LIGHT_ROW,
    ATTR_MAT_ROW,
    ATTR_N,
    ATTR_T,
    ATTR_UV,
)

MAT_COLS = 24  # a row of the material table

# the kernel's inputs and outputs in the order of csrc/surface.cu's enums;
# each an [N] array, f32 unless named in DTYPES. The curve inputs are there
# on a scene with curves, the uv fields on a textured scene.
IN_FIELDS = (
    "hit_t", "prim", "hit_u", "hit_v", "curve_t", "seg", "curve_u", "origin_x", "origin_y", "origin_z",
    "direction_x", "direction_y", "direction_z", "inside", "alive", "specular_bounce", "last_bsdf_pdf",
    "radiance_x", "radiance_y", "radiance_z", "throughput_x", "throughput_y", "throughput_z", "t_total",
)
OUT_FIELDS = (
    "radiance_out_x", "radiance_out_y", "radiance_out_z", "throughput_out_x", "throughput_out_y",
    "throughput_out_z", "position_x", "position_y", "position_z", "normal_x", "normal_y", "normal_z",
    "tangent_u_x", "tangent_u_y", "tangent_u_z", "tangent_v_x", "tangent_v_y", "tangent_v_z",
    "geom_normal_x", "geom_normal_y", "geom_normal_z", "type", "diffuse_x", "diffuse_y", "diffuse_z", "metallic",
    "roughness", "specular_level", "ior", "glass_x", "glass_y", "glass_z", "opacity", "emission_x", "emission_y",
    "emission_z", "thin_walled", "hit_surface", "is_curve", "tex_diffuse", "tex_normal", "tex_roughness",
    "tex_metallic", "uv_scale_u", "uv_scale_v", "uv_offset_u", "uv_offset_v", "uv_u", "uv_v", "uv_density_log2",
    "t_hit",
)
CURVE_IN = ("curve_t", "seg", "curve_u")
UV_IN = ("t_total",)
UV_OUT = OUT_FIELDS[OUT_FIELDS.index("tex_diffuse"):]
# the tables' order in csrc/surface.cu's third enum
TABLE_FIELDS = ("attr_table", "mat_table", "bg", "p0", "p1", "p2", "p3", "w0", "w1", "w2", "w3", "material_id")
DTYPES = {"prim": torch.int32, "seg": torch.int32, "inside": torch.bool, "alive": torch.bool,
          "specular_bounce": torch.bool, "type": torch.int32, "thin_walled": torch.bool, "hit_surface": torch.bool,
          "is_curve": torch.bool}


class SurfaceTables(NamedTuple):
    """What the phase reads of a scene: the joined attr table, the material
    table (the curves' materials), the curve segments, the light count and
    the instance flags."""

    attr_table: torch.Tensor  # [T, 68] f32
    mat_table: torch.Tensor  # [M, 24] f32
    curves: object  # render/device_scene.py:DeviceCurves, or None
    num_lights: int
    refine: bool  # refine the cone sweep's hits to the exact envelope
    uv: bool  # a textured scene: the uv outputs for the lookups


class Surface(NamedTuple):
    """The phase's results. tex_rows, uv and t_hit are None on a scene
    without textures; tex_rows holds the triangle material's texture ids
    (-1 on the lanes that hit a curve) and uv transform, its columns 12-19."""

    radiance: Vec3
    throughput: Vec3
    position: Vec3
    frame: B.ShadingFrame
    mat: B.SurfaceParams
    hit_surface: torch.Tensor  # [N] bool
    is_curve: torch.Tensor  # [N] bool
    tex_rows: Optional[tuple]  # 8 x [N] f32
    uv: Optional[tuple]  # ((u, v), uv_density_log2)
    t_hit: Optional[torch.Tensor]  # [N] f32: the path length at the hit


def tables_of(scene) -> SurfaceTables:
    """The phase's tables and flags of a DeviceScene."""
    return SurfaceTables(scene.attr_table, scene.mat_table, scene.curves, scene.num_lights,
                         bool(scene.curve_refine), scene.textures is not None)


# ---- the phase's plain functions


def oct_decode24(code: torch.Tensor) -> Vec3:
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


def gather_surface(attr_table: torch.Tensor, hit: Hit, inside, uv: bool):
    """fillTriangleGeomData (cu:365-421): interpolate attributes at the hit.

    ONE fat row gather (kernel K4) of the joined attr table per hit; the
    material and hit-light rows ride along. Returns (position, frame,
    light_id, rows [68, N], uv), uv being None unless `uv` and else
    ((u, v), uv_density_log2): the interpolated texture coordinates and the
    prim's log2 sqrt(uv area / world area), which the mip selection adds to
    the ray cone's footprint."""
    prim = torch.clamp(hit.prim, min=0)
    rows = V.gather_rows_t(attr_table, prim)
    wu, wv = hit.u, hit.v
    w0 = 1.0 - wu - wv
    col = lambda a: Vec3(rows[a], rows[a + 1], rows[a + 2])  # noqa: E731
    v0, e1, e2 = col(0), col(3), col(6)
    position = v0 + e1 * wu + e2 * wv
    n0d, n1d, n2d = (oct_decode24(rows[ATTR_N + i]) for i in range(3))
    t0d, t1d, t2d = (oct_decode24(rows[ATTR_T + i]) for i in range(3))
    normal = V.normalize(n0d * w0 + n1d * wu + n2d * wv)
    tangent = V.normalize(t0d * w0 + t1d * wu + t2d * wv)
    gcross = V.cross(e1, e2)
    uvs = None
    if uv:
        r = lambda i: rows[ATTR_UV + i]  # noqa: E731
        uv_u = r(0) * w0 + r(2) * wu + r(4) * wv
        uv_v = r(1) * w0 + r(3) * wu + r(5) * wv
        # both areas share the 1/2 factor, so the parallelogram ratio is exact
        uv_area2 = torch.abs((r(2) - r(0)) * (r(5) - r(1)) - (r(4) - r(0)) * (r(3) - r(1)))
        world_area2 = V.length(gcross)
        uv_density_log2 = 0.5 * (torch.log2(torch.clamp(uv_area2, min=1e-20))
                                 - torch.log2(torch.clamp(world_area2, min=1e-20)))
        uvs = ((uv_u, uv_v), uv_density_log2)
    geom_normal = V.normalize(gcross)
    flip = torch.where(inside, -1.0, 1.0)
    normal = normal * flip
    geom_normal = geom_normal * flip
    binormal = V.cross(normal, tangent)
    frame = B.ShadingFrame(normal=normal, tangent_u=tangent, tangent_v=binormal, geom_normal=geom_normal)
    light_id = rows[ATTR_LIGHT].to(torch.int32)
    return position, frame, light_id, rows, uvs


def material_from_rows(rows) -> B.SurfaceParams:
    """SurfaceParams from 24 material rows (the material columns joined
    into the attr table, or a gather of the material table)."""
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


def _select_material(mask, a: B.SurfaceParams, b: B.SurfaceParams) -> B.SurfaceParams:
    return B.SurfaceParams(*(
        V.where(mask, x, y) if isinstance(x, Vec3) else torch.where(mask, x, y) for x, y in zip(a, b)
    ))


def refine_curve_hit(curves, origin: Vec3, direction: Vec3, chit: CurveHit) -> CurveHit:
    """The exact swept-B-spline refinement of the cone sweep's winner; ghosts
    admitted by the inflated radii become misses."""
    rt, ru, keep = refine_scene_curve_hit(curves, origin, direction, chit.t, chit.seg, chit.u)
    return CurveHit(t=torch.where(keep, rt, 1e30), seg=torch.where(keep, chit.seg, -1),
                    u=torch.where(keep, ru, 0.0))


def curve_surface(curves, mat_table, chit: CurveHit, is_curve, origin: Vec3, direction: Vec3, inside,
                  position: Vec3, frame: B.ShadingFrame, mat: B.SurfaceParams):
    """fillCurveGeomData (cu:423-454): on the lanes that hit a curve, the hit
    point, the curve's frame (spine-offset normal, spline tangent) and its
    material row (a K4 gather of mat_table) take the triangle's place."""
    pos_curve = origin + direction * chit.t
    cn, ct, _ = curve_shading_frame_vec(curves, chit.seg, chit.u, pos_curve)
    cn = cn * torch.where(inside, -1.0, 1.0)
    frame = B.ShadingFrame(
        normal=V.where(is_curve, cn, frame.normal),
        tangent_u=V.where(is_curve, ct, frame.tangent_u),
        tangent_v=V.where(is_curve, V.cross(cn, ct), frame.tangent_v),
        geom_normal=V.where(is_curve, cn, frame.geom_normal),
    )
    seg_mat = torch.clamp(curves.material_id[torch.clamp(chit.seg, min=0).to(torch.int64)], min=0)
    mat = _select_material(is_curve, material_from_rows(V.gather_rows_t(mat_table, seg_mat)), mat)
    return V.where(is_curve, pos_curve, position), frame, mat


def shade_surface_plain(tables: SurfaceTables, hit: Hit, chit: Optional[CurveHit], origin: Vec3, direction: Vec3,
                        inside, alive, specular_bounce, last_bsdf_pdf, radiance: Vec3, throughput: Vec3, t_total, bg,
                        *, depth: int) -> Surface:
    """The phase in plain PyTorch: what CPU tensors run, and what K13 is held
    to. chit: the cone sweep's hits on a scene with curves, else None; bg:
    the [3] background colour on the lanes' device."""
    K.note_plain("shade_surface", alive.device)
    n, dev = alive.shape[0], alive.device
    is_curve = torch.zeros(n, dtype=torch.bool, device=dev)
    if chit is not None:
        if tables.refine:
            chit = refine_curve_hit(tables.curves, origin, direction, chit)
        is_curve = alive & (chit.seg >= 0) & (chit.t < hit.t)
    missed = alive & (hit.prim < 0) & ~is_curve

    # __miss__ms (cu:250-257)
    radiance = V.where(missed, radiance + throughput * Vec3(bg[0], bg[1], bg[2]), radiance)
    throughput = V.where(missed, V.full(n, 0.0, dev), throughput)

    position, frame, raw_light_id, attr_rows, uv = gather_surface(tables.attr_table, hit, inside, tables.uv)
    prim_light_id = torch.where(hit.prim >= 0, raw_light_id, -1)
    hit_light = alive & ~missed & (prim_light_id >= 0) & ~is_curve
    hit_surface = alive & ~missed & ~hit_light

    # ---- __closesthit__light (cu:315-341)
    num_lights = tables.num_lights
    if num_lights > 0:
        lp = LS.light_from_rows(attr_rows[ATTR_LIGHT_ROW:ATTR_JOINED])
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
    mat = material_from_rows(mat_rows)
    if chit is not None:
        position, frame, mat = curve_surface(tables.curves, tables.mat_table, chit, is_curve, origin, direction,
                                             inside, position, frame, mat)
    tex_rows = t_hit = None
    if tables.uv:
        # the lookups leave the curve lanes as they are
        tex_rows = tuple(torch.where(is_curve, -1.0, r) for r in mat_rows[12:16]) + tuple(mat_rows[16:20])
        # advance the ray cone to this hit (a curve hit by its cone t)
        t_eff = torch.where(is_curve, chit.t, hit.t) if chit is not None else hit.t
        t_hit = t_total + torch.where(alive & ~missed, t_eff, 0.0)
    return Surface(radiance, throughput, position, frame, mat, hit_surface, is_curve, tex_rows, uv, t_hit)


# ---- the kernel's wrapper


def _tables(tables: SurfaceTables, bg, curves: bool, dev) -> list:
    """The kernel's table pointers' tensors in TABLE_FIELDS' order (None for
    the curve tables of a scene without curves), each checked."""
    L.table("shade_surface", "attr_table", tables.attr_table, (None, ATTR_JOINED), torch.float32, dev)
    if tables.attr_table.data_ptr() % 16:
        raise ValueError("shade_surface: attr_table must start on a 16-byte boundary (its rows are read as float4)")
    L.table("shade_surface", "mat_table", tables.mat_table, (None, MAT_COLS), torch.float32, dev)
    L.table("shade_surface", "bg", bg, (3,), torch.float32, dev)
    if not curves:
        return [tables.attr_table, tables.mat_table, bg] + [None] * 9
    if tables.curves is None:
        raise ValueError("shade_surface: the cone sweep's hits need the scene's curve segments")
    c = tables.curves
    s = c.p0.shape[0] if isinstance(c.p0, torch.Tensor) else 0
    for name in ("p0", "p1", "p2", "p3"):
        L.table("shade_surface", name, getattr(c, name), (s, 3), torch.float32, dev)
    for name in ("w0", "w1", "w2", "w3"):
        L.table("shade_surface", name, getattr(c, name), (s,), torch.float32, dev)
    L.table("shade_surface", "material_id", c.material_id, (s,), torch.int32, dev)
    return [tables.attr_table, tables.mat_table, bg, c.p0, c.p1, c.p2, c.p3, c.w0, c.w1, c.w2, c.w3, c.material_id]


def shade_surface(tables: SurfaceTables, hit: Hit, chit: Optional[CurveHit], origin: Vec3, direction: Vec3, inside,
                  alive, specular_bounce, last_bsdf_pdf, radiance: Vec3, throughput: Vec3, t_total, bg, *,
                  depth: int) -> Surface:
    """One bounce's surface phase less its texture lookups: K13 on CUDA
    tensors, the plain version on CPU tensors. The kernel instance is
    (chit is not None, tables.refine, tables.uv); t_total is read on a
    textured scene only (None is taken elsewhere)."""
    curves = chit is not None
    given = dict(zip(IN_FIELDS, [hit.t, hit.prim, hit.u, hit.v, *(chit if curves else (None,) * 3), *origin,
                                 *direction, inside, alive, specular_bounce, last_bsdf_pdf, *radiance, *throughput,
                                 t_total]))
    present = tuple(f for f in IN_FIELDS if (curves or f not in CURVE_IN) and (tables.uv or f not in UV_IN))
    L.checked("shade_surface", present, [given[f] for f in present], DTYPES, "alive")
    dev = alive.device
    tabs = _tables(tables, bg, curves, dev)
    if dev.type == "cpu":
        return shade_surface_plain(tables, hit, chit, origin, direction, inside, alive, specular_bounce, last_bsdf_pdf,
                                   radiance, throughput, t_total, bg, depth=depth)
    n = alive.shape[0]
    refine = curves and tables.refine
    o = L.launch("shade_surface", [given[f] if f in present else None for f in IN_FIELDS], OUT_FIELDS, DTYPES,
                 L.pointers(tabs), tables.attr_table.shape[0], tables.mat_table.shape[0],
                 tabs[3].shape[0] if curves else 0, n, int(tables.num_lights), int(depth), int(curves), int(refine),
                 int(tables.uv), shape=(n, int(curves), int(refine), int(tables.uv)),
                 absent=() if tables.uv else UV_OUT)
    v3 = lambda name: Vec3(o[name + "_x"], o[name + "_y"], o[name + "_z"])  # noqa: E731
    mat = B.SurfaceParams(o["type"], v3("diffuse"), o["metallic"], o["roughness"], o["specular_level"], o["ior"],
                          v3("glass"), o["opacity"], v3("emission"), o["thin_walled"])
    frame = B.ShadingFrame(v3("normal"), v3("tangent_u"), v3("tangent_v"), v3("geom_normal"))
    tex_rows = uv = t_hit = None
    if tables.uv:
        tex_rows = tuple(o[f] for f in UV_OUT[:8])
        uv = ((o["uv_u"], o["uv_v"]), o["uv_density_log2"])
        t_hit = o["t_hit"]
    return Surface(v3("radiance_out"), v3("throughput_out"), v3("position"), frame, mat, o["hit_surface"],
                   o["is_curve"], tex_rows, uv, t_hit)

