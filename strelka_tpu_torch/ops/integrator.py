"""Wavefront path-tracing integrator — the PyTorch port of
strelka_tpu/ops/integrator.py (the replacement for the OptiX megakernel
__raygen__rg, OptixRender.cu:80-248, + __closesthit__radiance,
OptixRender_radiance_closest_hit.cu:456-606).

All W*H*spp rays of a launch advance together through the bounce loop;
branch divergence becomes masked selects. Each bounce runs one Sobol draw
(kernel K1), one closest-hit sweep (radiance rays, mask PRIMARY: K5 over
the scene's BVH, K2 over a flat scene), the surface phase (the miss, the
hit triangle's attributes from its attr row, the light hit, the material:
K13 on the card, kernels/surface.py), the BSDF phase (the cutout, the
emission and bsdf_sample: K10, kernels/shade.py) and the NEE phase: its
light sample and shadow ray (K11), one any-hit sweep (the shadow rays, mask
SHADOW: K6 or K3) and the light's contribution (K12, kernels/nee.py); the
rest of the shading is plain PyTorch on component-major Vec3.
A scene with curves adds, per bounce, the closest round-cone sweep (K7),
in K13 the Newton refinement of its winner to the exact swept envelope
(ops/curve_refine.py) and the curve's shading frame and material row, and
the cone shadow sweep (K8), and turns on the fibre lobes of ops/hair.py.

A scene with textures (DeviceScene.textures) adds, per bounce, the ray
cone's footprint at the hit (in K13) and the texture lookups of shade_textures:
one-texel stochastic trilinear by default, its uniforms hashed from the
sample index, the ray's slot, the bounce and the lookup slot, so that the
port draws the texels the JAX package draws. A scene without textures takes
none of this.

The port follows the JAX package's CPU path: barycentrics from the
intersector, prim ids in the scene's triangle order (BVH leaf order), the
curve parameter u from the winning cone's axial root. The wavefront's
order is the reference's for the device: on the CPU row-major and
unsorted, on the card its accelerator path's Z-order pixels and, on the
larger scenes, the bounce sort (accelerated, sort_by_default). Reference
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

from strelka_tpu_torch.kernels import nee as KN
from strelka_tpu_torch.kernels import shade as KS
from strelka_tpu_torch.kernels import surface as KSF
from strelka_tpu_torch.ops import bsdf as B
from strelka_tpu_torch.ops import sampler as S
from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.bsdf import EventType
from strelka_tpu_torch.ops.curves import CurveHit
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
    RAY_MASK_PRIMARY,
    RAY_MASK_SHADOW,
    DeviceScene,
)
from strelka_tpu_torch.utils import profiling as P

Dim = S.SampleDimension


class LaunchParams(NamedTuple):
    """Per-launch values (subset of Params, OptixRenderParams.h:38-68).

    Each field is a host value (an int, a numpy array) or a tensor, on the
    scene's device or not: render_launch takes it through torch.as_tensor
    onto the device, which leaves a tensor already there as it is. With
    tensors on the device the launch reads no value on the host, so a CUDA
    graph captures it once for every value (render/render.py).

    cone_spread: the ray cone's spread (ray_cone_spread's f32 value, computed
    on the host); None computes it from clip_to_view, which reads that
    matrix on the host."""

    subframe_index: int  # accumulated spp so far
    clip_to_view: np.ndarray  # [4,4] f32
    view_to_world: np.ndarray  # [4,4] f32
    exposure: np.ndarray  # [3] f32
    bg_color: np.ndarray  # [3] f32
    cone_spread: object = None  # f32 value, or None


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


def tex_stochastic() -> bool:
    """One-texel stochastic filtering, resolved as the JAX package resolves
    its `tex_stochastic` flag: STRELKA_TEX_STOCHASTIC if set, else on."""
    env = os.environ.get("STRELKA_TEX_STOCHASTIC")
    if env:
        return env == "1"
    return True


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


def shade_textures(scene: DeviceScene, mat: B.SurfaceParams, frame: B.ShadingFrame, tex_rows, uv, t_hit,
                   cone_spread: float, sample_idx: torch.Tensor, ray_slot: torch.Tensor, depth: int):
    """Texture lookups modulating material params + normal mapping, at one
    bounce (the tex_lookup path of the MDL runtime,
    texture_support_cuda.h:287-528): the diffuse texture replaces the
    constant color, roughness/metallic textures override their scalars (R
    channel), a normal map perturbs the frame.

    tex_rows: 8 [N] rows, a material row's columns 12-19 (12-15 the texture
    ids, 16-19 the uv transform); uv: ((u, v), uv_density_log2)
    (kernels/surface.py:shade_surface's). Lookups
    are trilinear across the mip chain, the footprint the ray cone's at the
    hit (cone_spread * t_hit, t_hit the path length so far) with the prim's
    uv density and the uv transform's scale; one-texel stochastic by
    default (tex_stochastic), its uniforms from tex_uniforms (keyed by
    ray_slot, the lanes' wavefront slots). Lookup slots
    are 0 diffuse, 1 roughness, 2 metallic, 3 normal, as in the JAX
    package; a column that no material row uses (scene.tex_columns) is not
    looked up, which changes no lane: its ids are all -1."""
    from strelka_tpu_torch.textures import sample_trilinear, sample_trilinear_stochastic

    atlas = scene.textures
    mat_rows = dict(zip(range(12, 20), tex_rows))  # by the material row's column
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


def closest_curve_hit(scene: DeviceScene, origin: Vec3, direction: Vec3, tmin, tmax, active) -> CurveHit:
    """The closest curve hit of each ray: the round-cone sweep (K7), then,
    where the scene was built for it, the refinement (kernels/surface.py:
    refine_curve_hit)."""
    chit = intersect_curves_closest(scene, origin, direction, tmin, tmax, active=active)
    return KSF.refine_curve_hit(scene.curves, origin, direction, chit) if scene.curve_refine else chit


# ---- the wavefront order of the reference's accelerator path
# (strelka_tpu/ops/integrator.py:371-563 and render_launch :1044-1067): pixels
# in Z-order, and from bounce 1 on the whole wavefront sorted by a
# position-Morton / direction-octant key, so that the rays a warp or a ray
# tile holds lie close together. Neither changes an untextured image; a
# textured one draws its stochastic texels by wavefront slot (tex_uniforms).

SORT_MIN_TRIANGLES = 16384  # the reference's rule (:1062-1067): sort where the
SORT_MIN_CURVE_SEGMENTS = 2048  # culled intersectors have blocks enough to matter


def accelerated(scene: DeviceScene) -> bool:
    """Whether a launch takes the reference's accelerator-path wavefront
    order (its scene.use_pallas): the scene is on a CUDA device. The CPU
    keeps the CPU reference's row-major, unsorted order."""
    return scene.device.type == "cuda"


def sort_by_default(scene: DeviceScene) -> bool:
    """render_launch's sort_rays=None: sort on the accelerator path where the
    scene has SORT_MIN_TRIANGLES triangles or SORT_MIN_CURVE_SEGMENTS curve
    segments (box_field, kitchen and hair_long do; Cornell, coffeetable and
    hair_patch do not)."""
    return accelerated(scene) and (scene.num_triangles >= SORT_MIN_TRIANGLES
                                   or scene.num_curve_segments >= SORT_MIN_CURVE_SEGMENTS)


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


def _spread3(v: torch.Tensor) -> torch.Tensor:
    """The low 10 bits of v (int64) spread to every third bit (Morton)."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def _ray_sort_key(scene: DeviceScene, position: Vec3, direction: Vec3) -> torch.Tensor:
    """The reference's default sort key, (morton << 3) | octant, int32 (at
    most 27 bits): the ray origin's 24-bit Morton code over the scene's
    world bounds (8 bits an axis, clip((c - lo) / ext, 0, 1) * 255 in f32
    with ext = max(hi - lo, 1e-9) and 1/ext taken in Python, as the
    reference's weak-typed scalars round them) and the direction octant in
    the low 3 bits. A NaN coordinate quantises to 0, as XLA converts it."""

    def q(c, lo_c, hi_c):
        ext = max(hi_c - lo_c, 1e-9)
        x = torch.clamp((c - float(np.float32(lo_c))) * float(np.float32(1.0 / ext)), 0.0, 1.0)
        x = torch.where(torch.isnan(x), 0.0, x)
        return (x * 255.0).to(torch.int64)

    lo, hi = scene.world_lo, scene.world_hi
    mx = _spread3(q(position.x, lo[0], hi[0]))
    my = _spread3(q(position.y, lo[1], hi[1]))
    mz = _spread3(q(position.z, lo[2], hi[2]))
    morton = mx | (my << 1) | (mz << 2)
    return ((morton << 3) | V.octant(direction)).to(torch.int32)


DEAD_KEY = 0x7FFFFFFF  # above every live key (< 2^27): dead lanes go to the tail


def _sort_wavefront(scene: DeviceScene, origin: Vec3, direction: Vec3, alive, f32_cols, bit_cols):
    """The whole wavefront reordered by _ray_sort_key, dead lanes last (the
    reference gives them 0xFFFFFFFF; any key above the live ones sorts the
    same): a stable sort of int32 keys, the counterpart of the reference's
    jnp.argsort outside any kernel, then _permute_packed. Returns the
    permuted columns."""
    key = torch.where(alive, _ray_sort_key(scene, origin, direction), DEAD_KEY)
    perm = torch.sort(key, stable=True).indices.to(torch.int32)
    return _permute_packed(perm, f32_cols, bit_cols)


def _as_i32(c: torch.Tensor) -> torch.Tensor:
    """A state column as int32 words: f32 by its bits, bool as 0/1, an int64
    column of u32 values by its low 32 bits."""
    if c.dtype == torch.float32:
        return c.view(torch.int32)
    return c.to(torch.int32)


def _from_i32(r: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.float32:
        return r.view(torch.float32)
    if like.dtype == torch.bool:
        return r != 0
    if like.dtype == torch.int64:
        return r.to(torch.int64) & S.M32
    return r.to(like.dtype)


def _permute_packed(perm: torch.Tensor, f32_cols, bit_cols):
    """Many [N] state columns permuted by one row gather with transpose,
    table[perm].T: the columns stacked as an [N, F] int32 table, which
    kernel K4 copies as f32 words (bits only, no arithmetic: int values
    under 2^23, which are f32 subnormals, and NaN patterns pass unchanged)
    and the plain version gathers on the CPU. perm: [N] int32. Returns
    (f32 columns, other columns), each in its own dtype."""
    cols = list(f32_cols) + list(bit_cols)
    table = torch.stack([_as_i32(c) for c in cols], dim=1)
    rows = V.gather_rows_t(table.view(torch.float32), perm).view(torch.int32)
    out = [_from_i32(rows[i], c) for i, c in enumerate(cols)]
    return out[:len(f32_cols)], out[len(f32_cols):]


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
    sort_rays: bool = False,
):
    """One path per entry -> (radiance Vec3, first_event [N], lanes).

    sort_rays: from bounce 1 on, reorder the whole wavefront by the
    position-Morton / direction-octant key before each bounce (one sort, one
    packed [N, 21] permute through K4), as the reference's accelerator path
    does; radiance and first_event come back in the entries' order (one
    [N, 4] permute). Each ray keeps its wavefront slot (ray_id), which keys
    its texture uniforms.

    cone_spread: the ray cone's spread angle a unit of path length (an f32
    value or a 0-d f32 tensor, ray_cone_spread), which sizes a textured
    scene's mip footprint.

    depth0_dims: the depth-0 draw of dimensions (0, 1, 2, 3, 4) at
    sample_idx ([5, N], as S.random_dims gives it), which the caller has
    drawn already (render_launch takes the camera jitter from its rows 0
    and 1).

    lanes: while the span recorder is on (utils/profiling.py), the
    [max_depth, 5] int64 counts of each bounce on the device: the lanes
    alive at the closest sweep, the shadow rays cast, the lanes swept (a
    scene with curves sweeps its cones with the same lanes), the lanes whose
    closest hit is a curve and those whose closest hit is a triangle; else
    None. The bounce's phases are the recorder's device spans (bounce.order,
    bounce.sample, bounce.closest, bounce.surface with bounce.texture,
    bounce.bsdf, bounce.nee with bounce.shadow, bounce.next, then
    launch.unorder) inside a launch record its caller opened; on a scene
    with curves bounce.closest holds closest.triangles and closest.curves,
    and bounce.shadow holds shadow.triangles and shadow.curves."""
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
    surface_tables = KSF.tables_of(scene)
    bg = f32_on(params.bg_color, dev)
    tmin_mat = torch.full((n,), material_ray_tmin, dtype=torch.float32, device=dev)
    tmax_big = torch.full((n,), 1e16, dtype=torch.float32, device=dev)
    shadow_tmin = torch.full((n,), shadow_ray_tmin, dtype=torch.float32, device=dev)
    lanes = P.lane_counts(max_depth, dev)
    has_curves = scene.has_curves
    enable_hair = has_curves or scene.has_hair
    # ray-cone mip selection: the accumulated path length (footprint =
    # cone_spread * t_total at the hit)
    t_total = torch.zeros(n, dtype=torch.float32, device=dev)
    # each lane's wavefront slot before any sort: the identity until sorted
    ray_id = torch.arange(n, dtype=torch.int32, device=dev)
    sorted_once = False

    for depth in range(max_depth):
        if sort_rays and depth >= 1:
            P.device_phase("bounce.order", depth)
            f32s, bits = _sort_wavefront(
                scene, origin, direction, alive,
                [origin.x, origin.y, origin.z, direction.x, direction.y, direction.z,
                 radiance.x, radiance.y, radiance.z, throughput.x, throughput.y, throughput.z,
                 last_bsdf_pdf, t_total],
                [sample_idx, first_event, prev_prim, inside, specular_bounce, alive, ray_id])
            origin, direction = Vec3(*f32s[0:3]), Vec3(*f32s[3:6])
            radiance, throughput = Vec3(*f32s[6:9]), Vec3(*f32s[9:12])
            last_bsdf_pdf, t_total = f32s[12], f32s[13]
            sample_idx, first_event, prev_prim, inside, specular_bounce, alive, ray_id = bits
            sorted_once = True
        # the 5 folded Sobol dimensions of this bounce in one draw (K1);
        # dimension = Dim % 5, so eBSDF2 and eLightId share dim 2, as in
        # the reference (RandomSampler.h:224)
        P.device_phase("bounce.sample", depth)
        dim_rows = depth0_dims if depth == 0 else S.random_dims(sample_idx, depth, (0, 1, 2, 3, 4))
        rnd = lambda dim: dim_rows[int(dim) % 5]  # noqa: E731

        P.device_phase("bounce.closest", depth)
        if lanes is not None:
            lanes[depth, 0].add_(alive.sum())
            lanes[depth, 2].add_(n)
        # curve (hair) primitives: the round-cone sweep beside the triangles'
        # (each its own child span), the closest of triangle and curve wins
        chit = None
        with P.device_span("closest.triangles") if has_curves else P.NULL:
            hit = intersect_closest(
                scene, origin, direction, tmin_mat, tmax_big, RAY_MASK_PRIMARY,
                active=alive, exclude=prev_prim,
            )
        if has_curves:
            with P.device_span("closest.curves"):
                chit = intersect_curves_closest(scene, origin, direction, tmin_mat, tmax_big, active=alive)
        # ---- the curve refinement, the miss, the triangle's attributes, the
        # light hit, the material and the curve's frame (kernel K13 on the
        # card), then the texture lookups
        P.device_phase("bounce.surface", depth)
        sf = KSF.shade_surface(surface_tables, hit, chit, origin, direction, inside, alive, specular_bounce,
                               last_bsdf_pdf, radiance, throughput, t_total, bg, depth=depth)
        radiance, throughput, position, frame, mat = sf.radiance, sf.throughput, sf.position, sf.frame, sf.mat
        is_curve, hit_surface = sf.is_curve, sf.hit_surface
        if lanes is not None:
            lanes[depth, 3].add_(is_curve.sum())
            lanes[depth, 4].add_((alive & (hit.prim >= 0) & ~is_curve).sum())
        if scene.textures is not None:
            with P.device_span("bounce.texture"):
                mat, frame = shade_textures(scene, mat, frame, sf.tex_rows, sf.uv, sf.t_hit, cone_spread, sample_idx,
                                            ray_id, depth)
            t_total = sf.t_hit

        if debug == 1:
            normals_col = (frame.normal + 1.0) * 0.5
            radiance = V.where(hit_surface, normals_col, radiance)
            first_event = torch.where(hit_surface, EventType.eUndef, first_event).to(torch.int32)
            break

        # ---- the cutout decision, the emission, bsdf_sample, the cutout's
        # override and the path state it updates: kernel K10 on the card
        P.device_phase("bounce.bsdf", depth)
        xi = (rnd(Dim.eBSDF0), rnd(Dim.eBSDF1), rnd(Dim.eBSDF2), rnd(Dim.eBSDF3))
        smp, cut, shade, radiance, throughput, first_event, specular_bounce = KS.shade_bsdf(
            mat, frame, direction, xi, sample_idx, inside, hit_surface, radiance, throughput, first_event,
            specular_bounce, depth=depth, enable_hair=enable_hair)

        # ---- NEE (estimateDirectLighting, cu:312-324 + sampleLight :260-310):
        # the light sample and the shadow ray (kernel K11 on the card), the
        # shadow sweep, then the light's contribution (kernel K12)
        P.device_phase("bounce.nee", depth)
        if num_lights > 0:
            nl = KN.nee_light(shade, smp.event_type, rnd(Dim.eLightId), rnd(Dim.eLightPointX),
                              rnd(Dim.eLightPointY), position, frame, is_curve, hit.prim, scene.light_table,
                              num_lights=num_lights, method=rect_light_sampling_method)
            with P.device_span("bounce.shadow"):
                if lanes is not None:
                    lanes[depth, 1].add_(nl.active.sum())
                with P.device_span("shadow.triangles") if has_curves else P.NULL:
                    occluded = intersect_any(
                        scene, nl.shadow_org, nl.to_light, shadow_tmin,
                        nl.dist_to_light, RAY_MASK_SHADOW, active=nl.active, exclude=nl.exclude,
                    )
                if has_curves:
                    with P.device_span("shadow.curves"):
                        occluded = occluded | intersect_curves_any(
                            scene, nl.shadow_org, nl.to_light, shadow_tmin, nl.dist_to_light, active=nl.active)
            radiance, throughput, shade = KN.nee_shade(nl, occluded, inside, mat, frame, direction, radiance,
                                                       throughput, shade, scene.light_table, enable_hair=enable_hair)

        # ---- next segment setup (cu:591-605)
        P.device_phase("bounce.next", depth)
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

    if sorted_once:
        # back to the entries' order: one scatter builds the inverse
        # permutation, then one packed row gather
        P.device_phase("launch.unorder")
        inv = torch.empty(n, dtype=torch.int32, device=dev).scatter_(
            0, ray_id.to(torch.int64), torch.arange(n, dtype=torch.int32, device=dev))
        f32s, bits = _permute_packed(inv, [radiance.x, radiance.y, radiance.z], [first_event])
        radiance, first_event = Vec3(*f32s), bits[0]
    return radiance, first_event, lanes


def ray_cone_spread(params: LaunchParams, height: int) -> float:
    """The ray cone's spread a unit of path length: the per-pixel angle of
    the projection, 2 |clip_to_view[1, 1]| / height (clip_to_view[1, 1] is
    tan(fov_y / 2)), in f32 as the JAX package computes it. On the host: on
    CUDA, dividing a tensor by a Python number multiplies by its f32
    reciprocal, which can be an ulp off this division."""
    c2v = np.asarray(torch.as_tensor(params.clip_to_view).cpu(), np.float32)
    return float(np.float32(2.0) * np.abs(c2v[1, 1]) / np.float32(height))


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
    sort_rays: bool | None = None,
    py_offset: int | None = None,
    full_height: int | None = None,
):
    """__raygen__rg equivalent: run samples_per_launch paths per pixel, update
    the accumulators, return (new_state, hdr_image [3,H,W]).

    Runs on the scene's device. Tonemapping is the Render layer's job.

    The wavefront's order is the reference's (:1044-1067). On the
    accelerator path (accelerated: the scene is on a CUDA device) pixels go
    in Z-order unless STRELKA_NO_ZORDER=1, read at each launch (a captured
    launch keeps the order of its capture), and the per-pixel results come
    back to row-major order in one packed [n, 11] permute; sort_rays=None
    sorts the bounces there by sort_by_default. On the CPU both stay off
    unless sort_rays=True. Neither changes an untextured image.

    py_offset/full_height: a row band (parallel/sharding.py) renders the
    [height, width] band of a [full_height, width] frame whose top row is
    global row py_offset. The global row feeds the Sobol seed and the camera
    NDC, so the bands of a frame equal the whole launch bit for bit; state
    and image stay band-local, and so do the Z-order and the sort (a
    textured scene's bands key their texels by band-local slots, as in the
    reference).

    While the span recorder is on (utils/profiling.py), the launch's phases
    are device spans of the launch record its caller opened (launch.camera,
    trace_paths' bounces, launch.accumulate) and the bounces' lane counts go
    to the recorder's counter."""
    P.device_phase("launch.camera")
    dev = scene.device
    n = width * height
    spl = 1 if debug == 1 else samples_per_launch
    fh = height if full_height is None else full_height

    # all samples of the launch ride ONE wavefront of spl*W*H rays, pixels
    # in Z-order on the accelerator path (a ray tile is a square screen
    # block, not a thin strip) and row-major on the CPU reference's
    zorder = None
    if accelerated(scene) and os.environ.get("STRELKA_NO_ZORDER") != "1":
        zorder, z_inv = pixel_zorder(width, height, dev)
        idx = zorder
    else:
        idx = torch.arange(n, dtype=torch.int64, device=dev)
    px = (idx % width).repeat(spl)
    py = (idx // width).repeat(spl)
    if py_offset is not None:
        py = py + int(py_offset)
    s_of_ray = torch.arange(spl, dtype=torch.int64, device=dev).repeat_interleave(n)
    sub = torch.as_tensor(params.subframe_index, dtype=torch.int64, device=dev)
    sample_index = (sub + s_of_ray) & S.M32
    sample_idx = S.make_sample_index(px, py, sample_index, max_sample_count)
    # the depth-0 draw once (K1): its rows ePixelX and ePixelY are the camera
    # jitter, and trace_paths takes the whole draw for its first bounce
    dims0 = S.random_dims(sample_idx, 0, (0, 1, 2, 3, 4))
    origin, direction = generate_camera_rays(params, px, py, dims0[Dim.ePixelX % 5], dims0[Dim.ePixelY % 5],
                                             width, fh)
    radiance, first_event, lanes = trace_paths(
        scene, params, sample_idx, origin, direction,
        max_depth=max_depth,
        rect_light_sampling_method=rect_light_sampling_method,
        shadow_ray_tmin=shadow_ray_tmin,
        material_ray_tmin=material_ray_tmin,
        debug=debug,
        depth0_dims=dims0,
        cone_spread=ray_cone_spread(params, fh) if params.cone_spread is None else params.cone_spread,
        sort_rays=sort_by_default(scene) if sort_rays is None else sort_rays,
    )
    P.device_phase("launch.accumulate")
    P.add_lanes(lanes)
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
    if zorder is not None:
        # back to row-major pixel order: one packed [n, 11] row gather
        f32s, bits = _permute_packed(z_inv, [*result, *dsum, *ssum], [dcount, scount])
        result, dsum, ssum = Vec3(*f32s[0:3]), Vec3(*f32s[3:6]), Vec3(*f32s[6:9])
        dcount, scount = bits

    img = lambda v: torch.stack([v.x, v.y, v.z]).reshape(3, height, width)  # noqa: E731
    result_img = img(result * (1.0 / spl))
    dcount2 = dcount.reshape(height, width)
    scount2 = scount.reshape(height, width)
    d_mean = img(dsum) / torch.clamp(dcount2, min=1)
    s_mean = img(ssum) / torch.clamp(scount2, min=1)

    exposure = f32_on(params.exposure, dev).reshape(3, 1, 1)

    # --- diffuse/specular AOV accumulation (OptixRender.cu:157-210); the
    # launch's first sample (sub == 0) starts from empty AOVs, selected on
    # the device as the reference's jnp.where does
    first = sub == 0
    zc = torch.zeros_like(dcount2)
    prev_d = torch.where(first, zc, state.diffuse_counter)
    prev_s = torch.where(first, zc, state.specular_counter)
    new_diffuse = torch.where(
        (dcount2 > 0)[None],
        _accumulate_planar(state.diffuse, d_mean, exposure, prev_d),
        torch.where(first, 0.0, state.diffuse),
    )
    new_dcount = torch.where(dcount2 > 0, prev_d + dcount2, prev_d)
    new_specular = torch.where(
        (scount2 > 0)[None],
        _accumulate_planar(state.specular, s_mean, exposure, prev_s),
        torch.where(first, 0.0, state.specular),
    )
    new_scount = torch.where(scount2 > 0, prev_s + scount2, prev_s)

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
    return new_state, image


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
