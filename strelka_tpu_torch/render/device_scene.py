"""Device scene tables: host Scene -> the tensors the integrator reads.

The PyTorch counterpart of strelka_tpu/render/device_scene.py. Instances
are flattened into a world-space triangle soup (the same numpy code as the
JAX package), reordered leaf-contiguous where a BVH is built, padded to a
multiple of 128, and packed into the tables the kernels and the shade
epilogue read:

  v0, e1, e2     [T, 3] f32   Möller–Trumbore inputs (kernels K2/K3, K5/K6)
  geom_mask      [T]    i32   triangle / light-proxy geometry masks
  attr_table     [T, 68] f32  per-prim attributes joined with its material
                              row (24:48) and hit-light row (48:68) (K4)
  mat_table      [M, 24] f32
  light_table    [L, 20] f32
  bvh            DeviceBvh    threaded BVH (ops/bvh.py), or None (flat scene)
  tri_bounds     [8, G] f32   a flat scene's boxes of 32-triangle groups in
                              table order (kernels/intersect.py:
                              tri_group_bounds), which K2/K3 cull by; None
                              with a BVH
  curves         DeviceCurves world-space cubic B-spline segments, or None
  cone_geom      [M_pad, 8] f32  the segments as round cones (a.xyz, ra,
                              b.xyz, rb), Morton-sorted, padded with ra = -1:
                              the one cone table, read by kernels K7/K8 and
                              by their plain version
  cone_attr      [3, M_pad] f32  u0, u1 and the segment of each cone
  cone_tree      [8, total] f32  the boxes of the tree over the cones in
                              their order (ops/curves.py:cone_tree), which
                              K7/K8 walk
  cone_reach     float           the reach their box tests take
                              (ops/curves.py:cone_reach: 0 or CONE_REACH)
  cone_bounds    [8, nb], cone_sbounds [8, nsb]  the JAX package's TPU
                              sub-block / superblock boxes (kernel K9's
                              input; no sweep walks them)

Triangle order is the JAX CPU build's: BVH leaf order above 1024 triangles
(`use_bvh=None`), the scene's own order below or with `use_bvh=False` (no
Morton sort, which is a TPU layout). Curves are the exception: the JAX CPU
build keeps the cones unsorted and sweeps them all, but the port's cone
kernels cull by box, so it stores the cones Morton-sorted with the packed
rows and sub-block boxes of the JAX package's TPU build (`pack_cones`; the
device holds the rows cone-major, each value once) and a tree of boxes over
them in that order (`cone_tree`).

  textures       TextureAtlas the u8 sheet, rect rows and meta of the
                              scene's textures (textures.py), or None: a
                              scene without textures takes no texture path

`device_scene_from_arrays` / `frame_state_from_arrays` carry the JAX
package's state across: they take its DeviceScene or FrameState as a dict
of numpy arrays and build the port's equivalent on a given device.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from strelka_tpu_torch import log
from strelka_tpu_torch.materials import BsdfType, MaterialManager
from strelka_tpu_torch.kernels.cones import PackedCones
from strelka_tpu_torch.kernels.intersect import tri_group_bounds
from strelka_tpu_torch.ops import curves as C
from strelka_tpu_torch.ops.bvh import DeviceBvh, ThreadedBvh, build_threaded, device_bvh
from strelka_tpu_torch.scene.scene import InstanceType, Scene
from strelka_tpu_torch.textures import TextureAtlas, TextureManager, atlas_to_device
from strelka_tpu_torch.utils import profiling as P
from strelka_tpu_torch.utils.device import resolve_device

GEOMETRY_MASK_TRIANGLE = 1
GEOMETRY_MASK_CURVE = 2
GEOMETRY_MASK_LIGHT = 4
RAY_MASK_PRIMARY = GEOMETRY_MASK_TRIANGLE | GEOMETRY_MASK_CURVE | GEOMETRY_MASK_LIGHT
RAY_MASK_SHADOW = GEOMETRY_MASK_TRIANGLE | GEOMETRY_MASK_CURVE

# Packed attr_table column layout (strelka_tpu/render/device_scene.py:63-72):
# normals/tangents are 12:12 octahedral 24-bit codes stored as exact f32 values.
ATTR_N = 9  # 9:12  oct normal code per corner
ATTR_T = 12  # 12:15 oct tangent code per corner
ATTR_UV = 15  # 15:21 uv f32
ATTR_MAT = 21
ATTR_LIGHT = 22
ATTR_MASK = 23
ATTR_COLS = 24
ATTR_MAT_ROW = 24  # 24:48 joined per-prim material row
ATTR_LIGHT_ROW = 48  # 48:68 joined emissive-hit light row
ATTR_JOINED = 68
_OCT_Q = 4094.0
FLAT_MAX_TRIS = 1024  # above this the CPU reference builds a BVH (use_bvh=None)
PAD_MULTIPLE = 128  # triangle count padding of the JAX build

TABLES = ("v0", "e1", "e2", "geom_mask", "attr_table", "mat_table", "light_table")


class DeviceCurves(NamedTuple):
    """Cubic B-spline segments, world space, SoA, padded to a multiple of
    128 with zero segments that no cone refers to."""

    p0: torch.Tensor  # [S, 3] control points
    p1: torch.Tensor
    p2: torch.Tensor
    p3: torch.Tensor
    w0: torch.Tensor  # [S] radii at control points
    w1: torch.Tensor
    w2: torch.Tensor
    w3: torch.Tensor
    material_id: torch.Tensor  # [S] i32


@dataclasses.dataclass(frozen=True)
class DeviceScene:
    """Flattened world-space scene on one device."""

    v0: torch.Tensor  # [T, 3] f32
    e1: torch.Tensor  # [T, 3] f32 v1 - v0
    e2: torch.Tensor  # [T, 3] f32 v2 - v0
    geom_mask: torch.Tensor  # [T] i32
    attr_table: torch.Tensor  # [T, ATTR_JOINED] f32
    mat_table: torch.Tensor  # [M, 24] f32
    light_table: torch.Tensor  # [L, 20] f32
    num_lights: int
    num_triangles: int
    bvh: Optional[DeviceBvh] = None  # triangles are in its leaf order
    tri_bounds: Optional[torch.Tensor] = None  # [8, G] f32 boxes of 32-triangle groups (flat scenes)
    curves: Optional[DeviceCurves] = None
    num_cones: int = 0  # round cones before padding
    cone_geom: Optional[torch.Tensor] = None  # [M_pad, 8] f32 (a.xyz, ra, b.xyz, rb), Morton-sorted
    cone_attr: Optional[torch.Tensor] = None  # [3, M_pad] f32 (u0, u1, segment)
    cone_bounds: Optional[torch.Tensor] = None  # [8, nb] f32 sub-block boxes
    cone_sbounds: Optional[torch.Tensor] = None  # [8, nb / CONE_SUPER] f32 superblock boxes
    cone_tree: Optional[torch.Tensor] = None  # [8, total] f32 the cone tree's boxes (ops/curves.py:cone_tree)
    cone_reach: float = 0.0  # the reach of the tree's box tests (ops/curves.py:cone_reach)
    curve_refine: bool = True  # cone radii are inflated; hits are refined to the exact envelope
    has_hair: bool = False  # any material row is a hair material
    textures: Optional[TextureAtlas] = None  # tensors on the scene's device
    # which of the material rows' texture columns (12 diffuse, 13 normal,
    # 14 roughness, 15 metallic) name a texture in any row
    tex_columns: tuple = ()
    # the triangle points' bounds (Python floats), which quantise the
    # wavefront sort key's position Morton code; (0,0,0)-(1,1,1) without
    # triangles. Curve points outside them clip, as in the reference.
    world_lo: tuple = (0.0, 0.0, 0.0)
    world_hi: tuple = (1.0, 1.0, 1.0)

    @property
    def device(self) -> torch.device:
        return self.v0.device

    @property
    def packed_cones(self) -> PackedCones:
        return PackedCones(self.cone_geom, self.cone_tree, self.cone_reach)

    @property
    def has_curves(self) -> bool:
        return self.cone_geom is not None

    @property
    def num_curve_segments(self) -> int:
        return 0 if self.curves is None else int(self.curves.p0.shape[0])


def _oct_encode24(v: np.ndarray) -> np.ndarray:
    """[M,3] vectors -> [M] f32 of 24-bit (12:12) octahedral codes."""
    norm = np.linalg.norm(v, axis=1, keepdims=True)
    n = v / np.maximum(norm, 1e-20)
    ax = np.abs(n).sum(axis=1)
    ax = np.maximum(ax, 1e-20)
    px = n[:, 0] / ax
    py = n[:, 1] / ax
    south = n[:, 2] < 0.0
    sx = np.where(px >= 0.0, 1.0, -1.0)
    sy = np.where(py >= 0.0, 1.0, -1.0)
    fx = np.where(south, (1.0 - np.abs(py)) * sx, px)
    fy = np.where(south, (1.0 - np.abs(px)) * sy, py)
    qu = np.rint((fx + 1.0) * 0.5 * _OCT_Q)
    qv = np.rint((fy + 1.0) * 0.5 * _OCT_Q)
    return (qu * 4096.0 + qv).astype(np.float32)


def _pad_to(arr: np.ndarray, n: int, fill=0.0) -> np.ndarray:
    pad = n - arr.shape[0]
    if pad <= 0:
        return arr
    return np.concatenate([arr, np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)], axis=0)


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m if n > 0 else m


def flatten_scene_geometry(scene: Scene):
    """Bake instance transforms into a world-space triangle soup (numpy)."""
    positions, normals, tangents, uvs, indices = scene.vertex_pools()
    removed = set(getattr(scene, "_del_instances", ()))
    tri_chunks = []
    for inst_id, inst in enumerate(scene.instances):
        if inst.type == InstanceType.eCurve or inst_id in removed:
            continue
        mesh = scene.meshes[inst.geom_id]
        tri = indices[mesh.index : mesh.index + mesh.count].reshape(-1, 3).astype(np.int64)
        tri = tri + mesh.vb_offset
        m = inst.transform
        rot = m[:3, :3]
        inv_t = np.linalg.inv(rot).T if abs(np.linalg.det(rot)) > 1e-12 else rot
        p = positions[tri.reshape(-1)].astype(np.float64) @ rot.T + m[:3, 3]
        n = normals[tri.reshape(-1)].astype(np.float64) @ inv_t.T
        t = tangents[tri.reshape(-1)].astype(np.float64) @ rot.T
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
        t /= np.maximum(np.linalg.norm(t, axis=1, keepdims=True), 1e-20)
        uv = uvs[tri.reshape(-1)]
        ntri = tri.shape[0]
        is_light = inst.type == InstanceType.eLight
        tri_chunks.append({
            "p": p.reshape(ntri, 3, 3).astype(np.float32),
            "n": n.reshape(ntri, 3, 3).astype(np.float32),
            "t": t.reshape(ntri, 3, 3).astype(np.float32),
            "uv": uv.reshape(ntri, 3, 2).astype(np.float32),
            "material_id": np.full(ntri, max(inst.material_id, 0), np.int32),
            "light_id": np.full(ntri, inst.light_id if is_light else -1, np.int32),
            "geom_mask": np.full(
                ntri, GEOMETRY_MASK_LIGHT if is_light else GEOMETRY_MASK_TRIANGLE, np.int32
            ),
        })
    if tri_chunks:
        return {k: np.concatenate([c[k] for c in tri_chunks]) for k in tri_chunks[0]}
    return {
        "p": np.zeros((0, 3, 3), np.float32),
        "n": np.zeros((0, 3, 3), np.float32),
        "t": np.zeros((0, 3, 3), np.float32),
        "uv": np.zeros((0, 3, 2), np.float32),
        "material_id": np.zeros(0, np.int32),
        "light_id": np.zeros(0, np.int32),
        "geom_mask": np.zeros(0, np.int32),
    }


def _light_table(scene: Scene) -> np.ndarray:
    """[L, 20]: 4 corner points, color, normal, type, half angle
    (a one-row zero table when the scene has no light)."""
    lights = scene.lights
    if not lights:
        return np.zeros((1, 20), np.float32)
    rows = [
        np.concatenate([
            np.asarray(l.points[:, :3], np.float32).reshape(12),
            np.asarray(l.color[:3], np.float32),
            np.asarray(l.normal[:3], np.float32),
            np.array([l.type, l.half_angle], np.float32),
        ])
        for l in lights
    ]
    return np.stack(rows).astype(np.float32)


def _mat_table(tbl) -> np.ndarray:
    """[M, 24] material rows (column order of the JAX build)."""
    return np.concatenate(
        [
            tbl.bsdf_type.astype(np.float32)[:, None],
            tbl.diffuse_color,
            tbl.metallic[:, None],
            tbl.roughness[:, None],
            tbl.specular_level[:, None],
            tbl.ior[:, None],
            tbl.glass_color,
            tbl.opacity[:, None],
            tbl.diffuse_tex.astype(np.float32)[:, None],
            tbl.normal_tex.astype(np.float32)[:, None],
            tbl.roughness_tex.astype(np.float32)[:, None],
            tbl.metallic_tex.astype(np.float32)[:, None],
            tbl.uv_scale,
            tbl.uv_offset,
            tbl.emission_color,
            tbl.thin_walled.astype(np.float32)[:, None],
        ],
        axis=1,
    ).astype(np.float32)


CURVE_FIELDS = ("p0", "p1", "p2", "p3", "w0", "w1", "w2", "w3", "material_id")


def flatten_scene_curves(scene: Scene) -> Optional[dict]:
    """World-space cubic B-spline segments from curve instances: a sliding
    window of 4 control points per segment."""
    segs = {k: [] for k in CURVE_FIELDS}
    for inst in scene.instances:
        if inst.type != InstanceType.eCurve:
            continue
        curve = scene.curves[inst.geom_id]
        pts_all = np.concatenate(scene.curve_points) if scene.curve_points else np.zeros((0, 3), np.float32)
        wid_all = np.concatenate(scene.curve_widths) if scene.curve_widths else np.zeros(0, np.float32)
        cnt_all = (
            np.concatenate(scene.curve_vertex_counts) if scene.curve_vertex_counts else np.zeros(0, np.uint32)
        )
        counts = cnt_all[curve.vertex_counts_start : curve.vertex_counts_start + curve.vertex_counts_count]
        m = inst.transform
        base = curve.points_start
        wbase = curve.widths_start
        # uniform scale factor for widths
        s = float(np.cbrt(abs(np.linalg.det(m[:3, :3])))) or 1.0
        for c in counts:
            c = int(c)
            pts = (pts_all[base : base + c].astype(np.float64) @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
            if wbase >= 0 and curve.widths_count > 0:
                ws = wid_all[wbase : wbase + c] * s
                wbase += c
            else:
                ws = np.full(c, 0.1 * s, np.float32)
            ws = np.asarray(ws, np.float32)
            base += c
            if c < 4:
                continue
            window = np.arange(c - 3)[:, None] + np.arange(4)[None, :]  # [segments, 4]
            for j in range(4):
                segs[f"p{j}"].append(pts[window[:, j]])
                segs[f"w{j}"].append(ws[window[:, j]])
            segs["material_id"].append(np.full(c - 3, max(inst.material_id, 0), np.int32))
    if not segs["p0"]:
        return None
    return {k: np.concatenate(v) for k, v in segs.items()}


def build_device_scene(
    scene: Scene,
    material_manager: Optional[MaterialManager] = None,
    device=None,
    use_bvh: Optional[bool] = None,
    curve_subdiv: int = C.CURVE_SUBDIV,
    curve_refine: bool = True,
) -> DeviceScene:
    """Host scene -> DeviceScene on `device` (default: the CUDA card).

    use_bvh None = auto: a BVH above FLAT_MAX_TRIS triangles, as the
    reference's CPU build. False keeps a scene of any size flat (kernels
    K2/K3 sweep every triangle), True builds the BVH for any size.
    curve_subdiv: round cones per cubic segment. curve_refine: refine curve
    hits to the exact swept envelope (the cone radii are then inflated to
    cover it). Both are the reference's defaults and both change the image.

    The recorder's set-up span device_scene.build (utils/profiling.py) times
    it, with the children bvh.build, cones.build (the cones from the
    segments) and tables.upload (device_scene_from_arrays: the tables packed,
    the cones sorted and packed, their tree's boxes built, all copied to the
    device). It sets the one-shot counters scene.triangles,
    scene.curve_segments, scene.cones and cones.tree_levels (0 without
    curves)."""
    with P.setup_span("device_scene.build"):
        return _build_device_scene(scene, material_manager, resolve_device(device), use_bvh, curve_subdiv,
                                   curve_refine)


def _build_device_scene(scene, material_manager, device, use_bvh, curve_subdiv, curve_refine) -> DeviceScene:
    cat = flatten_scene_geometry(scene)
    num_tri = int(cat["p"].shape[0])
    if use_bvh is None:
        use_bvh = num_tri > FLAT_MAX_TRIS
    bvh_arrays = {}
    if use_bvh and num_tri > 0:
        p = cat["p"]
        threaded, perm, builder = build_threaded(p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        # every per-triangle array goes into leaf order: prim ids are leaf-order ids
        for k in cat:
            cat[k] = cat[k][perm]
        bvh_arrays = {"bvh": threaded, "bvh_builder": builder}
        log.info("BVH built: {} nodes over {} triangles ({} builder)", len(threaded.count), num_tri, builder)
    padded = _round_up(num_tri, PAD_MULTIPLE)
    # padding triangles are degenerate (zero-area at origin) with mask 0
    p = _pad_to(cat["p"], padded)
    n = _pad_to(cat["n"], padded)
    t = _pad_to(cat["t"], padded)
    uv = _pad_to(cat["uv"], padded)
    light_id = _pad_to(cat["light_id"], padded, fill=-1)
    geom_mask = _pad_to(cat["geom_mask"], padded, fill=0)

    mm = material_manager or MaterialManager()
    if mm.texture_manager is None:
        mm.texture_manager = TextureManager(search_path=scene.get_scene_dir())
    compiled = mm.compile_scene_materials(scene.materials)
    table, mat_remap = mm.generate_target_code_deduped(compiled)
    atlas = mm.texture_manager.build_atlas()
    cat["material_id"] = mat_remap[np.clip(cat["material_id"], 0, len(mat_remap) - 1)]
    material_id = _pad_to(cat["material_id"], padded)

    attr = np.zeros((padded, ATTR_COLS), np.float32)
    attr[:, 0:3] = p[:, 0]
    attr[:, 3:6] = p[:, 1] - p[:, 0]
    attr[:, 6:9] = p[:, 2] - p[:, 0]
    attr[:, ATTR_N : ATTR_N + 3] = _oct_encode24(n.reshape(padded * 3, 3)).reshape(padded, 3)
    attr[:, ATTR_T : ATTR_T + 3] = _oct_encode24(t.reshape(padded * 3, 3)).reshape(padded, 3)
    attr[:, ATTR_UV : ATTR_UV + 6] = uv.reshape(padded, 6)
    attr[:, ATTR_MAT] = material_id
    attr[:, ATTR_LIGHT] = light_id
    attr[:, ATTR_MASK] = geom_mask

    if num_tri > 0:
        pts = cat["p"].reshape(-1, 3)
        world_lo = tuple(float(x) for x in pts.min(axis=0))
        world_hi = tuple(float(x) for x in pts.max(axis=0))
    else:
        world_lo, world_hi = (0.0, 0.0, 0.0), (1.0, 1.0, 1.0)

    mat_np = _mat_table(table)
    light_np = _light_table(scene)
    mj = np.clip(material_id.astype(np.int64), 0, mat_np.shape[0] - 1)
    lj = np.clip(light_id.astype(np.int64), 0, light_np.shape[0] - 1)
    attr = np.concatenate([attr, mat_np[mj], light_np[lj]], axis=1)

    curve_arrays = {}
    curves_np = flatten_scene_curves(scene)
    ns = 0  # curve segments before padding
    if curves_np is not None:
        curves_np["material_id"] = mat_remap[np.clip(curves_np["material_id"], 0, len(mat_remap) - 1)]
        ns = int(curves_np["p0"].shape[0])
        nsp = _round_up(ns, PAD_MULTIPLE)
        # the cones come from the segments as they are; the segment table is
        # padded, its padding marked by the sign of the (zero) radii
        with P.setup_span("cones.build"):
            cones_np = C.flatten_curves_np(curves_np, subdiv=curve_subdiv, refine=curve_refine)
        curves_np = {k: _pad_to(v, nsp) for k, v in curves_np.items()}
        neg = np.where(np.arange(nsp) < ns, 1.0, -1.0).astype(np.float32)
        for j in range(4):
            curves_np[f"w{j}"] = curves_np[f"w{j}"] * neg
        curve_arrays = {"curves": curves_np, "cones": cones_np, "curve_refine": curve_refine}
        log.info("Device scene: {} curve segments ({} padded), {} round cones", ns, nsp, cones_np.a.shape[0])

    log.info(
        "Device scene: {} triangles ({} padded), {} lights, {} materials on {}",
        num_tri, padded, len(scene.lights), len(compiled), device,
    )
    arrays = {
        "v0": p[:, 0],
        "e1": p[:, 1] - p[:, 0],
        "e2": p[:, 2] - p[:, 0],
        "geom_mask": geom_mask,
        "attr_table": attr,
        "mat_table": mat_np,
        "light_table": light_np,
        "num_lights": len(scene.lights),
        "num_triangles": num_tri,
        "textures": atlas,
        "world_lo": world_lo,
        "world_hi": world_hi,
        **bvh_arrays,
        **curve_arrays,
    }
    with P.setup_span("tables.upload"):
        ds = device_scene_from_arrays(arrays, device)
    P.set_count("scene.triangles", "", num_tri)
    P.set_count("scene.curve_segments", "", ns)
    P.set_count("scene.cones", "", ds.num_cones)
    P.set_count("cones.tree_levels", "", len(ds.packed_cones.levels) if ds.has_curves else 0)
    return ds


def _is_none(v) -> bool:
    return v is None or (isinstance(v, np.ndarray) and v.dtype == object and v.shape == () and v.item() is None)


def device_scene_from_arrays(arrays: dict, device) -> DeviceScene:
    """DeviceScene from numpy arrays by field name.

    Takes the tables of this module's build, or a JAX DeviceScene converted
    field by field (`{name: np.asarray(getattr(scene, name))}`). `bvh`, if
    present, is the scene's ThreadedBvh as five numpy arrays in field order
    (a tuple, or a dict by field name); the triangle tables are then in its
    leaf order already (`bvh_builder` says how this module's build made it). `curves` (DeviceCurves) and `cones` (FlatCones)
    are dicts by field name or tuples in field order. With `cones_packed`
    and `cone_bounds` (the JAX package's TPU build) the cones are taken as
    sorted and packed already; without them (its CPU build, and this
    module's) they are Morton-sorted and packed here. Either way the device
    gets the packed rows cone-major (`cone_geom`, `cone_attr`) and the boxes
    of the tree over them (`cone_tree`). `curve_refine`
    (default True, the reference's) says that the cones' radii are inflated
    and the hits are to be refined. `textures`, if present, is the texture
    atlas: a TextureAtlas, or a dict with its `data`, `rects`, `size` and
    `meta` (the JAX atlas converted field by field). `world_lo` and
    `world_hi` (three floats each) are the triangle points' bounds; without
    them the scene takes the unit box, as a JAX DeviceScene built without
    triangles does."""
    device = torch.device(device)
    at = np.asarray(arrays["attr_table"], np.float32)
    if at.shape[1] != ATTR_JOINED:
        raise ValueError(f"attr_table has {at.shape[1]} columns, expected the joined {ATTR_JOINED}")

    def f32(name):
        return torch.tensor(np.ascontiguousarray(arrays[name], np.float32), device=device)

    bvh = arrays.get("bvh")
    if _is_none(bvh):
        bvh = None
    else:
        if isinstance(bvh, dict):
            bvh = tuple(bvh[name] for name in ThreadedBvh._fields)
        bvh = device_bvh(tuple(np.asarray(a) for a in bvh), device, builder=arrays.get("bvh_builder", "carried"))
    mat_table = np.asarray(arrays["mat_table"], np.float32)
    tri_bounds = None
    if bvh is None:
        tri_bounds = torch.tensor(tri_group_bounds(*(np.asarray(arrays[k]) for k in ("v0", "e1", "e2", "geom_mask"))),
                                  device=device)
    textures = arrays.get("textures")
    if _is_none(textures):
        textures = None
    else:
        if isinstance(textures, dict):
            textures = TextureAtlas(*(textures.get(k) for k in ("data", "rects", "size", "meta")))
        if not isinstance(textures, TextureAtlas):
            raise TypeError(f"textures: the texture atlas as a TextureAtlas or a dict of its fields, not "
                            f"{type(textures).__name__}")
        textures = atlas_to_device(textures, device)
    return DeviceScene(
        bvh=bvh,
        textures=textures,
        tex_columns=tuple(c for c in range(12, 16) if textures is not None and (mat_table[:, c] >= 0).any()),
        tri_bounds=tri_bounds,
        has_hair=bool((mat_table[:, 0] == float(BsdfType.HAIR)).any()),
        **_curve_fields(arrays, device),
        v0=f32("v0"),
        e1=f32("e1"),
        e2=f32("e2"),
        geom_mask=torch.tensor(np.ascontiguousarray(arrays["geom_mask"], np.int32), device=device),
        attr_table=f32("attr_table"),
        mat_table=f32("mat_table"),
        light_table=f32("light_table"),
        num_lights=int(arrays["num_lights"]),
        num_triangles=int(arrays["num_triangles"]),
        **{k: tuple(float(x) for x in np.asarray(arrays[k]).ravel()) for k in ("world_lo", "world_hi")
           if not _is_none(arrays.get(k))},
    )


def _fields(value, names) -> list:
    """A NamedTuple's fields as numpy arrays, from a dict by name or a tuple in order."""
    if isinstance(value, dict):
        return [np.asarray(value[name]) for name in names]
    return [np.asarray(a) for a in value]


def _curve_fields(arrays: dict, device) -> dict:
    """The curve fields of a DeviceScene from `curves`, `cones` and, where
    given, `cones_packed` and `cone_bounds`."""
    if _is_none(arrays.get("curves")) or _is_none(arrays.get("cones")):
        return {}
    curves = _fields(arrays["curves"], CURVE_FIELDS)
    cones = C.FlatCones(*_fields(arrays["cones"], C.FlatCones._fields))
    if _is_none(arrays.get("cones_packed")):
        perm = C.morton_sort_cones(cones)
        cones = C.FlatCones(*[f[perm] for f in cones])
        rows, bounds = C.pack_cones(cones)
    else:
        rows, bounds = np.asarray(arrays["cones_packed"], np.float32), np.asarray(arrays["cone_bounds"], np.float32)

    def to(a, dtype):
        return torch.tensor(np.ascontiguousarray(a, dtype), device=device)

    geom = to(C.cone_major_rows(rows), np.float32)
    return dict(
        curves=DeviceCurves(*[to(a, np.float32) for a in curves[:8]], to(curves[8], np.int32)),
        num_cones=int(cones.a.shape[0]),
        cone_geom=geom,
        cone_attr=to(C.cone_attr_rows(rows), np.float32),
        cone_bounds=to(bounds, np.float32),
        cone_sbounds=to(C.cone_super_bounds(bounds), np.float32),
        cone_tree=C.cone_tree(geom),
        cone_reach=C.cone_reach(geom),
        curve_refine=bool(arrays.get("curve_refine", True)),
    )


def frame_state_from_arrays(arrays: dict, device):
    """FrameState from numpy arrays by field name (a JAX FrameState converted
    with `{name: np.asarray(field)}`, or the port's own)."""
    from strelka_tpu_torch.ops.integrator import FrameState

    device = torch.device(device)
    f32 = lambda k: torch.tensor(np.ascontiguousarray(arrays[k], np.float32), device=device)  # noqa: E731
    i32 = lambda k: torch.tensor(np.ascontiguousarray(arrays[k], np.int32), device=device)  # noqa: E731
    return FrameState(
        accum=f32("accum"),
        diffuse=f32("diffuse"),
        diffuse_counter=i32("diffuse_counter"),
        specular=f32("specular"),
        specular_counter=i32("specular_counter"),
    )
