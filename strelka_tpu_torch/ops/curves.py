"""Ray / cubic-B-spline curve (hair) intersection — the PyTorch port of
strelka_tpu/ops/curves.py.

The reference uses OptiX's built-in ROUND_CUBIC_BSPLINE intersector
(OptixRender.cpp:554-560). As in the JAX package, each B-spline segment is
flattened at build time into `CURVE_SUBDIV` round cones (sphere-swept line
segments) with a closed-form intersection, and shading attributes are
evaluated on the true spline: the hit's spline parameter u comes from the
cone's index and the axial position of the hit on it.

What is here:
  * the B-spline basis and evaluators, `FlatCones`, `CurveHit`;
  * the host build in numpy: `flatten_curves_np`, `morton_sort_cones` (with
    the package's own Morton sorter), `pack_cones` ([12, M_pad] rows and
    per-256 sub-block boxes, the layout of the JAX package's TPU build),
    `cone_super_bounds`, and the device's one cone table made of the rows:
    `cone_major_rows` ([M_pad, 8] geometry) and `cone_attr_rows` (u0, u1,
    segment);
  * `intersect_curves_closest_plain` / `intersect_curves_any_plain`: the
    blocked dense sweep of `intersect_curves_closest`, operation for
    operation. They are the plain versions of kernels K7 and K8
    (kernels/cones.py) and sweep every cone;
  * `cone_hit`, `cone_hit_to_seg_u`, `curve_shading_frame_vec`;
  * `tile_box_d2`, `tile_sweep_order_k`: the per-tile box distances and
    K-nearest selection that feed kernel K9's open flag (kernels/open_w.py);
  * `sub_blocks_entered`, `any_hit_need`: the sub-blocks and cones a culled
    sweep needs for given rays, counted in plain PyTorch for the kernels'
    bounds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.vec import Vec3

MISS_T = 1e16
CURVE_SUBDIV = 8  # round cones per cubic segment (the reference's default)
CONE_TBLK = 256  # cones per culled sub-block
CONE_SUPER = 8  # sub-blocks per superblock
# kernel K9 gives the cone sweeps a near-to-far superblock order per tile of
# CONE_ORDER_TILE rays from this many superblocks on (the reference's
# _CONE_WL_MIN_NSB: below it the ascending sweep's few boxes cost nothing)
CONE_ORDER_MIN_NSB = 32
CONE_ORDER_TILE = 64  # of 32, 64, 128, 256 the least K7 + order time on hair_long (scripts/torch_cone_tile_probe.py)
# packed row numbers ([12, M_pad], pack_cones)
ROW_A, ROW_B, ROW_RA, ROW_RB, ROW_U0, ROW_U1, ROW_SEG = 0, 3, 6, 7, 8, 9, 10
# columns of the cone-major geometry [M_pad, 8] and rows of the attributes [3, M_pad]
GEOM_A, GEOM_RA, GEOM_B, GEOM_RB = 0, 3, 4, 7
ATTR_U0, ATTR_U1, ATTR_SEG = 0, 1, 2
# f32 operations of one ray-cone test (csrc/cones.cu:ray_cone, the closed
# form of strelka_tpu/ops/curves.py:_cone_block): ba, oa (6), ra - rb (1),
# five dots (25), d2 (2), k2 (2), k1 (6), k0 (10), h (3), the guarded k2 (2),
# the body root (max, sqrt, negate, subtract, divide: 5), y (2), the body's
# three comparisons (3), two cap spheres (22 each: oc 3, two dots 10, r*r and
# its subtraction 2, the discriminant 2, the root 4, its comparison 1), the
# three selects (3), two minima (2) and the interval and radius comparisons (3).
CONE_FLOPS = 119
# rays per plain-version chunk ([chunk, block] temporaries)
_RAY_CHUNK = {"cpu": 4096, "cuda": 32768}


def bspline_basis(u):
    """Uniform cubic B-spline basis weights for p0..p3 at parameter u."""
    u2 = u * u
    u3 = u2 * u
    b0 = (1.0 - 3.0 * u + 3.0 * u2 - u3) / 6.0
    b1 = (4.0 - 6.0 * u2 + 3.0 * u3) / 6.0
    b2 = (1.0 + 3.0 * u + 3.0 * u2 - 3.0 * u3) / 6.0
    b3 = u3 / 6.0
    return b0, b1, b2, b3


def bspline_basis_deriv(u):
    u2 = u * u
    d0 = (-3.0 + 6.0 * u - 3.0 * u2) / 6.0
    d1 = (-12.0 * u + 9.0 * u2) / 6.0
    d2 = (3.0 + 6.0 * u - 9.0 * u2) / 6.0
    d3 = 3.0 * u2 / 6.0
    return d0, d1, d2, d3


def eval_bspline(p0, p1, p2, p3, u):
    """Position on the spline; p*: [..., 3], u: [...] -> [..., 3]."""
    b0, b1, b2, b3 = bspline_basis(u)
    return b0[..., None] * p0 + b1[..., None] * p1 + b2[..., None] * p2 + b3[..., None] * p3


def eval_bspline_scalar(w0, w1, w2, w3, u):
    b0, b1, b2, b3 = bspline_basis(u)
    return b0 * w0 + b1 * w1 + b2 * w2 + b3 * w3


def eval_bspline_tangent(p0, p1, p2, p3, u):
    d0, d1, d2, d3 = bspline_basis_deriv(u)
    return d0[..., None] * p0 + d1[..., None] * p1 + d2[..., None] * p2 + d3[..., None] * p3


class FlatCones(NamedTuple):
    """Flattened curve subsegments (round cones). Leading dim S*K."""

    a: object  # [M, 3] start point
    b: object  # [M, 3] end point
    ra: object  # [M] start radius
    rb: object  # [M] end radius
    seg_id: object  # [M] i32 parent cubic segment
    u0: object  # [M] spline parameter at a
    u1: object  # [M] spline parameter at b


class CurveHit(NamedTuple):
    t: torch.Tensor  # [N] f32, 1e16 = miss
    seg: torch.Tensor  # [N] i32, -1 = miss
    u: torch.Tensor  # [N] spline parameter


# ---------------------------------------------------------------------------
# host build (numpy)
# ---------------------------------------------------------------------------


def flatten_curves_np(curves_np: dict, subdiv: int = CURVE_SUBDIV, refine: bool = True) -> FlatCones:
    """Segments (p0..p3 [S, 3], w0..w3 [S]) -> round cones, cone k * S + s
    being subdivision k of segment s.

    refine: the hits will be refined to the exact envelope
    (ops/curve_refine.py), so the radii are inflated by 4/3 of the
    mid-subsegment chord deviation: the swept cones then cover the envelope,
    and the ghosts the inflation admits are rejected by the refinement."""
    us = np.linspace(0.0, 1.0, subdiv + 1, dtype=np.float32)
    p = [np.asarray(curves_np[f"p{j}"], np.float32) for j in range(4)]
    w = [np.asarray(curves_np[f"w{j}"], np.float32) for j in range(4)]
    s = p[0].shape[0]
    b = bspline_basis(us)  # 4 x [K+1]
    pts = sum(b[j][:, None, None] * p[j][None] for j in range(4))  # [K+1, S, 3]
    rads = sum(b[j][:, None] * w[j][None] for j in range(4))  # [K+1, S]
    ra = rads[:-1].reshape(-1)
    rb = rads[1:].reshape(-1)
    if refine:
        ums = (0.5 * (us[:-1] + us[1:])).astype(np.float32)
        bm = bspline_basis(ums)
        mid_pts = sum(bm[j][:, None, None] * p[j][None] for j in range(4))
        mid_rads = sum(bm[j][:, None] * w[j][None] for j in range(4))
        chord_mid = 0.5 * (pts[:-1] + pts[1:])
        dev_c = np.linalg.norm(mid_pts - chord_mid, axis=-1)
        dev_r = np.maximum(mid_rads - 0.5 * (rads[:-1] + rads[1:]), 0.0)
        # 4/3 safety: the cubic's largest chord deviation is near but not
        # exactly at the midpoint
        pad = ((4.0 / 3.0) * (dev_c + dev_r)).reshape(-1).astype(np.float32)
        ra = ra + pad
        rb = rb + pad
    seg = np.broadcast_to(np.arange(s, dtype=np.int32)[None, :], (subdiv, s))
    u0 = np.broadcast_to(us[:-1, None], (subdiv, s))
    u1 = np.broadcast_to(us[1:, None], (subdiv, s))
    return FlatCones(
        a=pts[:-1].reshape(-1, 3),
        b=pts[1:].reshape(-1, 3),
        ra=ra,
        rb=rb,
        seg_id=seg.reshape(-1),
        u0=u0.reshape(-1).astype(np.float32),
        u1=u1.reshape(-1).astype(np.float32),
    )


def morton_order(points: np.ndarray) -> np.ndarray:
    """Permutation sorting [M, 3] points by 30-bit Morton code (stable)."""
    c = np.asarray(points)
    lo = c.min(axis=0)
    ext = np.maximum(c.max(axis=0) - lo, 1e-12)
    q = np.clip(((c - lo) / ext * 1023.0).astype(np.uint32), 0, 1023).astype(np.uint64)

    def part1by2(x):
        x &= np.uint64(0x3FF)
        x = (x | (x << np.uint64(16))) & np.uint64(0x30000FF)
        x = (x | (x << np.uint64(8))) & np.uint64(0x300F00F)
        x = (x | (x << np.uint64(4))) & np.uint64(0x30C30C3)
        x = (x | (x << np.uint64(2))) & np.uint64(0x9249249)
        return x

    code = part1by2(q[:, 0]) | (part1by2(q[:, 1]) << np.uint64(1)) | (part1by2(q[:, 2]) << np.uint64(2))
    return np.argsort(code, kind="stable")


def morton_sort_cones(cones: FlatCones) -> np.ndarray:
    """Permutation sorting cones by the Morton code of their midpoint.

    The midpoint goes through the mean of three equal corners, as the
    reference sorts cones with its triangle sorter."""
    mid = 0.5 * (np.asarray(cones.a) + np.asarray(cones.b))
    return morton_order(np.stack([mid, mid, mid], axis=1).mean(axis=1))


def pack_cones(cones: FlatCones, tblk: int = CONE_TBLK, super_: int = CONE_SUPER):
    """FlatCones -> ([12, M_pad] rows, [8, nb] sub-block boxes), numpy f32.

    Rows: a.xyz, b.xyz, ra, rb, u0, u1, seg_id (as an f32 value), pad.
    M_pad is a multiple of tblk * super_; padding has ra = rb = -1 (never
    hit) and boxes without live cones are inverted (lo = 1e30, hi = -1e30)."""
    m = int(cones.a.shape[0])
    step = tblk * super_
    m_pad = ((m + step - 1) // step) * step
    rows = np.zeros((12, m_pad), np.float32)
    a = np.asarray(cones.a, np.float32)
    b = np.asarray(cones.b, np.float32)
    ra = np.asarray(cones.ra, np.float32)
    rb = np.asarray(cones.rb, np.float32)
    rows[0:3, :m] = a.T
    rows[3:6, :m] = b.T
    rows[ROW_RA, :m] = ra
    rows[ROW_RB, :m] = rb
    rows[ROW_U0, :m] = np.asarray(cones.u0, np.float32)
    rows[ROW_U1, :m] = np.asarray(cones.u1, np.float32)
    rows[ROW_SEG, :m] = np.asarray(cones.seg_id, np.float32)
    rows[ROW_RA, m:] = -1.0
    rows[ROW_RB, m:] = -1.0
    nb = m_pad // tblk
    lo = np.full((m_pad, 3), 1e30, np.float32)
    hi = np.full((m_pad, 3), -1e30, np.float32)
    live = np.zeros(m_pad, bool)
    live[:m] = ra >= 0.0
    lo[:m] = np.minimum(a - ra[:, None], b - rb[:, None])
    hi[:m] = np.maximum(a + ra[:, None], b + rb[:, None])
    lo[~live] = 1e30
    hi[~live] = -1e30
    bounds = np.zeros((8, nb), np.float32)
    bounds[0:3] = lo.reshape(nb, tblk, 3).min(axis=1).T
    bounds[3:6] = hi.reshape(nb, tblk, 3).max(axis=1).T
    return rows, bounds


def cone_super_bounds(bounds: np.ndarray, super_: int = CONE_SUPER) -> np.ndarray:
    """[8, nb] sub-block boxes -> [8, nb / super_] superblock boxes."""
    bounds = np.asarray(bounds, np.float32)
    nsb = bounds.shape[1] // super_
    out = np.zeros((8, nsb), np.float32)
    out[0:3] = bounds[0:3].reshape(3, nsb, super_).min(axis=2)
    out[3:6] = bounds[3:6].reshape(3, nsb, super_).max(axis=2)
    return out


def cone_major_rows(rows: np.ndarray) -> np.ndarray:
    """[12, M_pad] packed rows -> [M_pad, 8] = (a.xyz, ra, b.xyz, rb): the
    cones' geometry as the device holds it, one 32-byte sector a cone."""
    rows = np.asarray(rows, np.float32)
    return np.ascontiguousarray(
        np.stack([rows[0], rows[1], rows[2], rows[ROW_RA], rows[3], rows[4], rows[5], rows[ROW_RB]], axis=1))


def cone_attr_rows(rows: np.ndarray) -> np.ndarray:
    """[12, M_pad] packed rows -> [3, M_pad] = (u0, u1, segment as an f32
    value): what a hit needs of its cone beside the geometry."""
    return np.ascontiguousarray(np.asarray(rows, np.float32)[[ROW_U0, ROW_U1, ROW_SEG]])


# ---------------------------------------------------------------------------
# the dense sweep: plain version of kernels K7 and K8
# ---------------------------------------------------------------------------


def ray_round_cone(o, d, a, b, ra, rb, tmin, tmax):
    """Closed-form ray against sphere-swept segments (round cones).

    o, d: (x, y, z) of [R, 1], tmin, tmax [R, 1]; a, b: (x, y, z) of [1, B]
    (every ray against the same cones) or [R, B] (each ray against its own);
    ra, rb likewise. Returns (t [R, B], axial y in [0, 1], hit). The
    operation order of strelka_tpu/ops/curves.py:_ray_round_cone."""
    ox, oy, oz = o
    dx, dy, dz = d
    ax, ay, az = a
    bx, by, bz = b
    bax, bay, baz = bx - ax, by - ay, bz - az
    oax, oay, oaz = ox - ax, oy - ay, oz - az
    rr = ra - rb
    m0 = bax * bax + bay * bay + baz * baz
    m1 = oax * bax + oay * bay + oaz * baz
    m2 = dx * bax + dy * bay + dz * baz
    m3 = dx * oax + dy * oay + dz * oaz
    m5 = oax * oax + oay * oay + oaz * oaz
    ra_b = ra
    d2 = m0 - rr * rr
    k2 = d2 - m2 * m2
    k1 = d2 * m3 - m1 * m2 + m2 * rr * ra_b
    k0 = d2 * m5 - m1 * m1 + 2.0 * m1 * rr * ra_b - d2 * ra_b * ra_b
    h = k1 * k1 - k0 * k2
    safe_k2 = torch.where(torch.abs(k2) > 1e-12, k2, 1e-12)
    t_body = (-torch.sqrt(torch.clamp(h, min=0.0)) - k1) / safe_k2
    y = m1 + t_body * m2  # axial position * m0
    body_ok = (h > 0.0) & (y > 0.0) & (y < d2)

    def sphere(cx, cy, cz, r):
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        bq = ocx * dx + ocy * dy + ocz * dz
        cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        hq = bq * bq - cq
        tq = -bq - torch.sqrt(torch.clamp(hq, min=0.0))
        return tq, hq > 0.0

    t_ca, ok_ca = sphere(ax, ay, az, ra)
    t_cb, ok_cb = sphere(bx, by, bz, rb)
    t_body_m = torch.where(body_ok, t_body, MISS_T)
    t_ca_m = torch.where(ok_ca, t_ca, MISS_T)
    t_cb_m = torch.where(ok_cb, t_cb, MISS_T)
    t = torch.minimum(t_body_m, torch.minimum(t_ca_m, t_cb_m))
    in_range = (t > tmin) & (t < tmax)
    hit = (t < MISS_T) & in_range
    y_norm = torch.clamp(y / torch.clamp(d2, min=1e-12), 0.0, 1.0)
    y_norm = torch.where(t == t_ca_m, 0.0, torch.where(t == t_cb_m, 1.0, y_norm))
    return torch.where(hit, t, MISS_T), y_norm, hit


def _geom_columns(g):
    """Cone geometry [..., 8] -> (a, b, ra, rb): views, no copy."""
    a = tuple(g[..., GEOM_A + k] for k in range(3))
    b = tuple(g[..., GEOM_B + k] for k in range(3))
    return a, b, g[..., GEOM_RA], g[..., GEOM_RB]


def _columns(c):
    return tuple(x[:, None] for x in c)


def intersect_curves_closest_plain(geom, o, d, tmin, tmax, block: int = CONE_TBLK, name: str = "cone_closest"):
    """Plain K7: every ray against every cone of the geometry table [M, 8].

    o, d: (x, y, z) triples of [N] f32; a lane with tmax <= tmin misses.
    Cones go by in ascending blocks: `argmin` inside a block and a strict <
    across blocks, so of equal t the lowest cone index wins, whatever the
    block size. Returns (t [N] (1e16 = miss), cone [N] i32 (-1 = miss),
    y [N] axial position on the winning cone in [0, 1])."""
    K.note_plain(name, tmin.device)
    n, m = tmin.shape[0], geom.shape[0]
    dev = tmin.device
    t_out = torch.full((n,), MISS_T, dtype=torch.float32, device=dev)
    c_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    y_out = torch.zeros(n, dtype=torch.float32, device=dev)
    chunk = max(256, _RAY_CHUNK[dev.type] * CONE_TBLK // block)
    for r0 in range(0, n, chunk):
        rs = slice(r0, min(n, r0 + chunk))
        oc, dc = _columns([c[rs] for c in o]), _columns([c[rs] for c in d])
        tn, tx = tmin[rs, None], tmax[rs, None]
        best_t, best_c, best_y = t_out[rs], c_out[rs], y_out[rs]
        rr = torch.arange(best_t.shape[0], device=dev)
        for start in range(0, m, block):
            stop = min(m, start + block)
            a, b, ra, rb = _geom_columns(geom[None, start:stop])
            t, y, hit = ray_round_cone(oc, dc, a, b, ra, rb, tn, tx)
            t = torch.where(hit & (ra >= 0.0), t, MISS_T)
            arg = torch.argmin(t, dim=1)  # first (lowest index) of equal minima
            t_blk = t[rr, arg]
            better = t_blk < best_t
            best_c = torch.where(better, (start + arg).to(torch.int32), best_c)
            best_y = torch.where(better, y[rr, arg], best_y)
            best_t = torch.where(better, t_blk, best_t)
        t_out[rs], c_out[rs], y_out[rs] = best_t, best_c, best_y
    return t_out, c_out, y_out


def intersect_curves_any_plain(geom, o, d, tmin, tmax, block: int = CONE_TBLK):
    """Plain K8 -> occluded [N] bool: the closest sweep's hit set, as the
    reference's intersect_curves_any."""
    return intersect_curves_closest_plain(geom, o, d, tmin, tmax, block, name="cone_any")[1] >= 0


def cone_hit(attr, t, cone, y) -> CurveHit:
    """(t, cone, y) of a sweep -> CurveHit: the cone's segment and
    u = u0 + (u1 - u0) * y, from the cones' attribute rows [3, M]
    (strelka_tpu/ops/curves.py:283)."""
    c = torch.clamp(cone, min=0).to(torch.int64)
    u0, u1 = attr[ATTR_U0][c], attr[ATTR_U1][c]
    miss = cone < 0
    return CurveHit(
        t=torch.where(miss, MISS_T, t),
        seg=torch.where(miss, -1, attr[ATTR_SEG][c].to(torch.int32)),
        u=torch.where(miss, 0.0, u0 + (u1 - u0) * y),
    )


def cone_hit_to_seg_u(cones: FlatCones, origins: Vec3, directions: Vec3, t, cone_idx) -> CurveHit:
    """Winning cone index + t -> (seg, spline u), u from the hit point's
    axial position on the cone (what the TPU path does after its kernels)."""
    c = torch.clamp(cone_idx, min=0).to(torch.int64)
    a = Vec3(*(cones.a[c, k] for k in range(3)))
    b = Vec3(*(cones.b[c, k] for k in range(3)))
    ra, rb = cones.ra[c], cones.rb[c]
    u0, u1 = cones.u0[c], cones.u1[c]
    seg = cones.seg_id[c]
    ba = b - a
    p = origins + directions * t
    pa = p - a
    rr = ra - rb
    m0 = V.dot(ba, ba)
    d2 = m0 - rr * rr
    y = V.dot(pa, ba)
    y_norm = torch.clamp(y / torch.clamp(d2, min=1e-12), 0.0, 1.0)
    u = u0 + (u1 - u0) * y_norm
    miss = cone_idx < 0
    return CurveHit(
        t=torch.where(miss, MISS_T, t),
        seg=torch.where(miss, -1, seg).to(torch.int32),
        u=torch.where(miss, 0.0, u),
    )


def curve_shading_frame_vec(curves, seg, u, hit_position: Vec3):
    """Normal, tangent, binormal at a curve hit (fillCurveGeomData, cu:423-454):
    the normal is the offset from the spine with its axial part removed, the
    tangent the spline's. curves: p0..p3 [S, 3]."""
    s = torch.clamp(seg, min=0).to(torch.int64)
    b0, b1, b2, b3 = bspline_basis(u)
    d0, d1, d2, d3 = bspline_basis_deriv(u)
    g = lambda t: Vec3(t[s, 0], t[s, 1], t[s, 2])  # noqa: E731
    p0, p1, p2, p3 = g(curves.p0), g(curves.p1), g(curves.p2), g(curves.p3)
    spine = p0 * b0 + p1 * b1 + p2 * b2 + p3 * b3
    tangent = V.normalize(p0 * d0 + p1 * d1 + p2 * d2 + p3 * d3, eps=1e-12)
    n = hit_position - spine
    n = n - tangent * V.dot(n, tangent)
    norm = V.length(n)
    ok = norm > 1e-9
    inv = 1.0 / torch.clamp(norm, min=1e-9)
    fallback = V.splat((0.0, 0.0, 1.0), norm.shape[0], norm.device)
    n = V.where(ok, n * inv, fallback)
    binormal = V.cross(n, tangent)
    return n, tangent, binormal


# ---------------------------------------------------------------------------
# per-tile box distances (what feeds kernel K9's open flag)
# ---------------------------------------------------------------------------


def tile_box_d2(origins, sbounds, tile: int):
    """[n_tiles, nsb] squared distance from each tile's mean ray origin (lanes
    past the end count as zeros) to each superblock box
    (strelka_tpu/ops/pallas_intersect.py:tile_box_d2). origins: (x, y, z) of [N]."""
    n = origins[0].shape[0]
    pad = -n % tile
    d2 = 0.0
    for c in range(3):
        o = torch.cat([origins[c], origins[c].new_zeros(pad)]) if pad else origins[c]
        cm = o.reshape(-1, tile).mean(dim=1)[:, None]
        dx = torch.clamp(torch.maximum(sbounds[c][None, :] - cm, cm - sbounds[3 + c][None, :]), min=0.0)
        d2 = d2 + dx * dx
    return d2


def tile_sweep_order_k(origins, sbounds, tile: int, k: int):
    """Each tile's K nearest superblocks -> (order [n_tiles, K] i32, the K-th
    least distance [n_tiles], d2 [n_tiles, nsb]); of equal distances the
    lower index first (strelka_tpu/ops/pallas_intersect.py:tile_sweep_order_k)."""
    d2 = tile_box_d2(origins, sbounds, tile)
    kk = min(k, d2.shape[1])
    vals, order = torch.sort(d2, dim=1, stable=True)
    return order[:, :kk].to(torch.int32), vals[:, kk - 1].contiguous(), d2


# ---------------------------------------------------------------------------
# the work a culled sweep needs
# ---------------------------------------------------------------------------


def slab_enters(o, d, tmin, tmax, bounds):
    """[R] rays x [8, B] boxes -> [R, B] bool: the slab test of kernels K7/K8
    (strelka_tpu/ops/pallas_intersect.py:_tile_hits_block per ray): inv =
    1 / where(|d| > 1e-20, d, 1e-20), tnear <= tfar with equality, inverted
    boxes rejected."""
    tnear = tmin[:, None]
    tfar = tmax[:, None]
    for c in range(3):
        inv = 1.0 / torch.where(torch.abs(d[c]) > 1e-20, d[c], 1e-20)
        t0 = (bounds[c][None, :] - o[c][:, None]) * inv[:, None]
        t1 = (bounds[3 + c][None, :] - o[c][:, None]) * inv[:, None]
        tnear = torch.maximum(tnear, torch.minimum(t0, t1))
        tfar = torch.minimum(tfar, torch.maximum(t0, t1))
    return (tnear <= tfar) & (bounds[0] <= bounds[3])[None, :]


def _live_cones(geom, nb: int):
    """Cones with ra >= 0 (not padding) in each of the nb sub-blocks -> [nb] f32."""
    return (geom[:, GEOM_RA] >= 0.0).reshape(nb, -1).sum(dim=1).to(torch.float32)


def sub_blocks_entered(geom, bounds, o, d, tmin, tmax, chunk: int = 16384):
    """Per ray, the number of sub-block boxes its interval [tmin, tmax]
    enters and the cones with ra >= 0 in them, and per box whether any ray
    enters it -> ([N] i32, [N] i64, [B] bool). With tmax the final t of a
    closest sweep this is the work the sweep needs: a culled sweep that knew
    the answer would test these boxes' cones."""
    n, nb = tmin.shape[0], bounds.shape[1]
    live = _live_cones(geom, nb)
    blocks = torch.zeros(n, dtype=torch.int32, device=tmin.device)
    cones = torch.zeros(n, dtype=torch.int64, device=tmin.device)
    touched = torch.zeros(nb, dtype=torch.bool, device=tmin.device)
    for r0 in range(0, n, chunk):
        rs = slice(r0, min(n, r0 + chunk))
        enters = slab_enters([c[rs] for c in o], [c[rs] for c in d], tmin[rs], tmax[rs], bounds)
        enters = enters & (tmax[rs] > tmin[rs])[:, None]
        blocks[rs] = enters.sum(dim=1, dtype=torch.int32)
        cones[rs] = (enters.to(torch.float32) @ live).to(torch.int64)  # counts below 2^24: exact
        touched |= enters.any(dim=0)
    return blocks, cones, touched


def any_hit_need(geom, bounds, o, d, tmin, tmax, chunk: int = 32768):
    """What an occlusion sweep needs for these rays, counted without the
    kernel: each ray goes through the sub-blocks its interval enters in
    ascending order and tests their cones with ra >= 0 in ascending order, up
    to and including its first occluder -> (sub-blocks [N] i32, cones [N]
    i32, per box whether a ray tested it [B] bool)."""
    n, nb = tmin.shape[0], bounds.shape[1]
    tblk = geom.shape[0] // nb
    dev = tmin.device
    blocks = torch.zeros(n, dtype=torch.int32, device=dev)
    cones = torch.zeros(n, dtype=torch.int32, device=dev)
    touched = torch.zeros(nb, dtype=torch.bool, device=dev)
    blocked = geom.reshape(nb, tblk, 8)
    ids = torch.arange(nb, device=dev)
    for r0 in range(0, n, chunk):
        rs = slice(r0, min(n, r0 + chunk))
        oc, dc, tn, tx = [c[rs] for c in o], [c[rs] for c in d], tmin[rs], tmax[rs]
        enters = slab_enters(oc, dc, tn, tx, bounds) & (tx > tn)[:, None]
        count = enters.sum(dim=1)
        # a ray's entered sub-blocks in ascending order, first in its row
        lists = torch.sort(torch.where(enters, ids[None, :], nb), dim=1).values[:, :max(int(count.max()), 1)]
        ray = torch.nonzero(count > 0)[:, 0]
        step = 0
        while ray.numel():
            blk = lists[ray, step]
            a, b, ra, rb = _geom_columns(blocked[blk])
            _, _, hit = ray_round_cone(_columns([c[ray] for c in oc]), _columns([c[ray] for c in dc]), a, b, ra, rb,
                                       tn[ray, None], tx[ray, None])
            valid = ra >= 0.0
            hit = hit & valid
            occluded = hit.any(dim=1)
            first = torch.argmax(hit.to(torch.int8), dim=1)
            upto = torch.cumsum(valid, dim=1)
            tested = torch.where(occluded, upto.gather(1, first[:, None])[:, 0], upto[:, -1])
            blocks[r0 + ray] += 1
            cones[r0 + ray] += tested.to(torch.int32)
            touched[blk] = True
            step += 1
            ray = ray[~occluded & (count[ray] > step)]
    return blocks, cones, touched
