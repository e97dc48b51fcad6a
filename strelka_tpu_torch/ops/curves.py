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
  * `cone_tree_levels`, `cone_tree`: the tree over the Morton-sorted cones
    that kernels K7 and K8 walk (leaves of CONE_LEAF consecutive cones,
    inner nodes of CONE_WIDE consecutive children, boxes only: the cones
    stay in place), and `cone_tree_walk`, the plain count of that walk;
  * `tile_box_d2`, `tile_sweep_order_k`: the per-tile box distances and
    K-nearest selection that feed kernel K9's open flag (kernels/open_w.py);
  * `cones_entered`, `sub_blocks_entered`, `any_hit_need`: the cones and
    sub-blocks a culled sweep needs for given rays, counted in plain PyTorch
    for the kernels' bounds.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.slab import slab_enters, slab_tnear
from strelka_tpu_torch.ops.vec import Vec3

MISS_T = 1e16
CURVE_SUBDIV = 8  # round cones per cubic segment (the reference's default)
CONE_TBLK = 256  # cones per sub-block of the packed rows (the JAX package's TPU blocking; K9's boxes)
CONE_SUPER = 8  # sub-blocks per superblock
# the cone tree (cone_tree): cones a leaf and children an inner node, a lane
# each in kernels K7/K8 (csrc/cones.cu:kLeaf, kWide), and the most box levels
# the kernels' per-warp stack holds (csrc/cones.cu:kMaxLevels; 32^6 leaves)
CONE_LEAF = 32
CONE_WIDE = 32
CONE_MAX_LEVELS = 6
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


def cone_tree_levels(m_pad: int) -> tuple:
    """The box levels of the cone tree over m_pad cones (a multiple of
    CONE_LEAF), top first: ((first box, boxes), ...) in one [8, total] table.
    The last level holds the leaves, leaf j the cones [CONE_LEAF j,
    CONE_LEAF (j + 1)); the top level holds at most CONE_WIDE boxes; below it,
    level l + 1 holds CONE_WIDE times as many boxes as level l, and box
    CONE_WIDE j + k of level l + 1 is child k of box j of level l (boxes past
    the cones are padding). The depth follows the number of cones."""
    if m_pad < 1 or m_pad % CONE_LEAF:
        raise ValueError(f"{m_pad} cones: the cone tree takes whole leaves of {CONE_LEAF}")
    held = [m_pad // CONE_LEAF]  # the boxes a level needs, from the leaves up
    while held[0] > CONE_WIDE:
        held.insert(0, -(-held[0] // CONE_WIDE))
    counts = [held[0] * CONE_WIDE ** k for k in range(len(held))]
    first = np.cumsum([0] + counts[:-1])
    return tuple((int(f), int(c)) for f, c in zip(first, counts))


def cone_boxes(geom) -> torch.Tensor:
    """Cone rows [..., 8] (a tensor or an array) -> each cone's own box as
    rows [8, ...] f32 (lo.xyz, hi.xyz, two zero rows): lo = min(a - ra,
    b - rb), hi = max(a + ra, b + rb), the arithmetic of pack_cones' boxes and
    of kernels K7/K8's leaf test; padding (ra < 0) inverted (lo = 1e30,
    hi = -1e30), as the kernels' arithmetic leaves it too."""
    g = torch.as_tensor(geom, dtype=torch.float32)
    a, b, ra, rb = _geom_columns(g)
    pad = ~(ra >= 0.0)
    lo = [torch.where(pad, 1e30, torch.minimum(a[k] - ra, b[k] - rb)) for k in range(3)]
    hi = [torch.where(pad, -1e30, torch.maximum(a[k] + ra, b[k] + rb)) for k in range(3)]
    return torch.stack(lo + hi + [torch.zeros_like(ra)] * 2)


def cone_tree(geom) -> torch.Tensor:
    """[M_pad, 8] cone rows in their (Morton) order (a tensor, on any device,
    or an array) -> the cone tree's boxes [8, total] f32 on the same device
    (lo.xyz, hi.xyz, two zero rows; levels by cone_tree_levels): a leaf's
    box holds its cones' boxes (cone_boxes), an inner box its
    children's; a box without a live cone is inverted. The cones are not
    moved, so cone indices, the tie rule and the cone table are unchanged.
    Built with tensor reductions on the cones' device."""
    g = torch.as_tensor(geom, dtype=torch.float32)
    levels = cone_tree_levels(int(g.shape[0]))
    own = cone_boxes(g)
    total = levels[-1][0] + levels[-1][1]
    out = torch.zeros((8, total), dtype=torch.float32, device=g.device)
    out[0:3] = 1e30
    out[3:6] = -1e30
    first, _ = levels[-1]
    leaves = g.shape[0] // CONE_LEAF
    out[0:3, first:first + leaves] = own[0:3].view(3, leaves, CONE_LEAF).amin(dim=2)
    out[3:6, first:first + leaves] = own[3:6].view(3, leaves, CONE_LEAF).amax(dim=2)
    for (f, c), (fc, cc) in zip(levels[-2::-1], levels[:0:-1]):
        out[0:3, f:f + c] = out[0:3, fc:fc + cc].reshape(3, c, CONE_WIDE).amin(dim=2)
        out[3:6, f:f + c] = out[3:6, fc:fc + cc].reshape(3, c, CONE_WIDE).amax(dim=2)
    return out


# ---------------------------------------------------------------------------
# the dense sweep: plain version of kernels K7 and K8
# ---------------------------------------------------------------------------


def ray_round_cone(o, d, a, b, ra, rb, tmin, tmax, any_hit: bool = False):
    """Closed-form ray against sphere-swept segments (round cones).

    o, d: (x, y, z) of [R, 1], tmin, tmax [R, 1]; a, b: (x, y, z) of [1, B]
    (every ray against the same cones) or [R, B] (each ray against its own);
    ra, rb likewise. Returns (t [R, B], axial y in [0, 1], hit); y is the
    closed form's on the pairs it evaluates (below) and 0 on the others.

    The closed form (_round_cone_closed_form) runs on the pairs whose ray
    passes within the cone's bounding sphere with a wide margin (a few f32
    operations a pair); every other pair misses. The margin, half the
    sphere's radius and a thousandth of the distance to its centre, is orders
    of magnitude above the closed form's rounding, so the pairs it drops
    miss in the closed form too and t, y and hit are what the closed form
    gives on every pair that can hit. Cones with ra < 0 (padding, which
    every sweep drops) miss."""
    shape = tuple(max(sz) for sz in zip(o[0].shape, a[0].shape, ra.shape, tmin.shape))
    cx, cy, cz = ((ak + bk) * 0.5 for ak, bk in zip(a, b))
    wx, wy, wz = cx - o[0], cy - o[1], cz - o[2]
    ww = wx * wx + wy * wy + wz * wz
    wd = wx * d[0] + wy * d[1] + wz * d[2]
    dd = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
    bx, by, bz = (bk - ak for ak, bk in zip(a, b))
    rad = torch.sqrt(bx * bx + by * by + bz * bz) * 0.5 + torch.maximum(ra, rb)
    # the centre's squared distance to the ray's line against (1.5 rad + |w| / 1000)^2 <= 4.5 rad^2 + 2e-6 |w|^2
    near = (ww * dd - wd * wd <= (4.5 * rad * rad + 2e-6 * ww) * dd) & (ra >= 0.0)
    rows, cols = torch.nonzero(near.expand(shape), as_tuple=True)
    pick = lambda x: x.expand(shape)[rows, cols]  # noqa: E731
    t_k, y_k, hit_k = _round_cone_closed_form(tuple(pick(c) for c in o), tuple(pick(c) for c in d),
                                              tuple(pick(c) for c in a), tuple(pick(c) for c in b), pick(ra),
                                              pick(rb), pick(tmin), pick(tmax), any_hit)
    dev = tmin.device
    t = torch.full(shape, MISS_T, dtype=torch.float32, device=dev)
    y = torch.zeros(shape, dtype=torch.float32, device=dev)
    hit = torch.zeros(shape, dtype=torch.bool, device=dev)
    t[rows, cols], y[rows, cols], hit[rows, cols] = t_k, y_k, hit_k
    return t, y, hit


def _round_cone_closed_form(o, d, a, b, ra, rb, tmin, tmax, any_hit: bool):
    """ray_round_cone's closed form on broadcastable tensors, every pair.

    strelka_tpu/ops/curves.py:_ray_round_cone rounded as the JAX package's
    CPU render rounds it (the golden images): XLA's CPU backend fuses the
    scan body of intersect_curves_closest into loops whose products LLVM
    contracts into FMAs where a product has one use, and folds `x - y > 0`
    into `x > y`. Each fma below is one such contraction (V.fma rounds
    once), every other product rounds on its own. The body's h > 0 test
    compares the two rounded products; the caps' hq > 0 does the same in
    the closest sweep, while the any-hit sweep (any_hit=True), which also
    takes the cap's square root in that loop, tests the contracted hq."""
    ba = tuple(bk - ak for bk, ak in zip(b, a))
    oa = tuple(ok - ak for ok, ak in zip(o, a))
    rr = ra - rb
    m0 = V.dot_fma(ba, ba)
    m1 = V.dot_fma(oa, ba)
    m2 = V.dot_fma(d, ba)
    m3 = V.dot_fma(d, oa)
    m5 = V.dot_fma(oa, oa)
    d2 = V.fma(-rr, rr, m0)
    k2 = V.fma(-m2, m2, d2)
    k1 = V.fma(ra, rr * m2, V.fma(m3, d2, -(m1 * m2)))
    k0 = V.fma(-ra, ra * d2, V.fma(ra, (rr * 2.0) * m1, V.fma(m5, d2, -(m1 * m1))))
    k0k2 = k2 * k0
    h = V.fma(k1, k1, -k0k2)
    safe_k2 = torch.where(torch.abs(k2) > 1e-12, k2, 1e-12)
    t_body = (-torch.sqrt(torch.clamp(h, min=0.0)) - k1) / safe_k2
    y = V.fma(m2, t_body, m1)  # axial position * m0
    body_ok = (k1 * k1 > k0k2) & (y > 0.0) & (y < d2)

    def sphere(oc, m_oo, r):
        bq = V.dot_fma(d, oc)
        cq = V.fma(-r, r, m_oo)
        hq = V.fma(bq, bq, -cq)
        tq = -bq - torch.sqrt(torch.clamp(hq, min=0.0))
        return tq, (hq > 0.0) if any_hit else (bq * bq > cq)

    t_ca, ok_ca = sphere(oa, m5, ra)
    ob = tuple(ok - bk for ok, bk in zip(o, b))
    t_cb, ok_cb = sphere(ob, V.dot_fma(ob, ob), rb)
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


def intersect_curves_closest_plain(geom, o, d, tmin, tmax, block: int = CONE_TBLK, name: str = "cone_closest",
                                   any_hit: bool = False):
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
            t, y, hit = ray_round_cone(oc, dc, a, b, ra, rb, tn, tx, any_hit)
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
    """Plain K8 -> occluded [N] bool: the hit set of the closest sweep, as
    the reference's intersect_curves_any, with the caps tested as its
    compiled any-hit loop tests them (ray_round_cone(any_hit=True))."""
    return intersect_curves_closest_plain(geom, o, d, tmin, tmax, block, name="cone_any", any_hit=True)[1] >= 0


def cone_hit(attr, t, cone, y) -> CurveHit:
    """(t, cone, y) of a sweep -> CurveHit: the cone's segment and
    u = u0 + (u1 - u0) * y, from the cones' attribute rows [3, M]
    (strelka_tpu/ops/curves.py:283, which XLA's CPU backend contracts into
    fma(u1 - u0, y, u0))."""
    c = torch.clamp(cone, min=0).to(torch.int64)
    u0, u1 = attr[ATTR_U0][c], attr[ATTR_U1][c]
    miss = cone < 0
    return CurveHit(
        t=torch.where(miss, MISS_T, t),
        seg=torch.where(miss, -1, attr[ATTR_SEG][c].to(torch.int32)),
        u=torch.where(miss, 0.0, V.fma(u1 - u0, y, u0)),
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
                                       tn[ray, None], tx[ray, None], any_hit=True)
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


class ConeWalk(NamedTuple):
    """What a walk of the cone tree did for each ray ([N] each)."""

    boxes: torch.Tensor  # i32: inner boxes slab-tested (the top level's, then CONE_WIDE an inner node opened)
    leaves: torch.Tensor  # i32: leaves swept (each of their cones' own boxes slab-tested)
    cones: torch.Tensor  # i32: cones whose own box the interval entered, which the closed form then tested
    forms: torch.Tensor  # i32: leaves whose cones went through the closed form (one entered box or more)
    t: torch.Tensor  # f32: the closest walk's final t; the any-hit walk's least t in its last leaf (1e16: none)


def cone_tree_walk(geom, tree, o, d, tmin, tmax, any_hit: bool = False, chunk: int = 8192) -> ConeWalk:
    """What kernel K7 (or K8, any_hit=True) does on its walk of the cone
    tree, counted in plain PyTorch (csrc/cones.cu:cone_kernel). A live ray
    slab-tests the top level's boxes and keeps the entered ones on a stack:
    K7 the nearest on top (of equal tnear the lower box), K8 the lowest box
    on top. It pops the top entry; K7 drops it when its tnear is greater than
    its best t (strict, since a box at tnear = best t can still hold a cone
    of equal t and a lower index). An inner box has its CONE_WIDE children
    slab-tested against [tmin, min(best t, tmax)] ([tmin, tmax] for K8) and
    pushed the same way; a leaf has its CONE_LEAF cones' own boxes
    (cone_boxes) slab-tested against the same interval, and where one or
    more is entered, the cones whose box is entered go through the closed
    form. An empty stack ends the walk, and K8 also ends it after the leaf
    with its first hit. geom [M_pad, 8], tree [8, total] (cone_tree)."""
    levels = cone_tree_levels(geom.shape[0])
    n, dev = tmin.shape[0], tmin.device
    inf = float("inf")
    starts = torch.tensor([f for f, _ in levels] + [levels[-1][0] + levels[-1][1]], device=dev)
    leaf0 = levels[-1][0]
    cap = len(levels) * CONE_WIDE
    lane = torch.arange(CONE_WIDE, device=dev)  # a box a lane
    in_leaf = torch.arange(CONE_LEAF, device=dev)  # a cone a lane
    out = ConeWalk(*(torch.zeros(n, dtype=torch.int32, device=dev) for _ in range(4)),
                   torch.full((n,), MISS_T, dtype=torch.float32, device=dev))
    for r0 in range(0, n, chunk):
        rs = slice(r0, min(n, r0 + chunk))
        oc, dc, tn, tx = [c[rs] for c in o], [c[rs] for c in d], tmin[rs], tmax[rs]
        r = tn.shape[0]
        st_t = torch.full((r, cap), inf, dtype=torch.float32, device=dev)
        st_n = torch.zeros((r, cap), dtype=torch.int64, device=dev)
        sp = torch.zeros(r, dtype=torch.int64, device=dev)
        best = torch.full((r,), MISS_T, dtype=torch.float32, device=dev)
        boxes, leaves, cones, forms = (torch.zeros(r, dtype=torch.int32, device=dev) for _ in range(4))
        live = torch.ones(r, dtype=torch.bool, device=dev)  # K8: cleared by the first hit
        ray = lambda rows: ([c[rows] for c in oc], [c[rows] for c in dc], tn[rows])  # noqa: E731
        bound = lambda rows: tx[rows] if any_hit else torch.minimum(best[rows], tx[rows])  # noqa: E731

        def push(rows, first, count):
            ids = first[:, None] + lane[None, :count]  # [R', count]
            v = slab_tnear(*ray(rows), bound(rows), tree[:, ids])
            key = torch.where(v < inf, 0.0, inf) if any_hit else v  # K8: the entered boxes in index order
            sv, si = torch.sort(key, dim=1, stable=True)  # K7: nearest first, of equal tnear the lower box
            n_in = (v < inf).sum(dim=1)
            k = lane[None, :count]
            ok = k < n_in[:, None]
            pos = sp[rows, None] + n_in[:, None] - 1 - k  # the first to pop on top
            at = rows[:, None].expand_as(pos)[ok]
            st_t[at, pos[ok]] = v.gather(1, si)[ok]
            st_n[at, pos[ok]] = ids.gather(1, si)[ok]
            sp[rows] += n_in
            boxes[rows] += count

        push(torch.nonzero(tx > tn)[:, 0], torch.zeros(int((tx > tn).sum()), dtype=torch.int64, device=dev),
             levels[0][1])
        while True:
            act = torch.nonzero((sp > 0) & live)[:, 0]
            if not act.numel():
                break
            sp[act] -= 1
            tnv, node = st_t[act, sp[act]], st_n[act, sp[act]]
            if not any_hit:
                keep = tnv <= best[act]
                act, node = act[keep], node[keep]
            leaf = node >= leaf0
            la = act[leaf]
            if la.numel():
                g = geom[(node[leaf] - leaf0)[:, None] * CONE_LEAF + in_leaf[None, :]]  # [R', L, 8]
                o_l, d_l, tn_l = ray(la)
                entered = slab_tnear(o_l, d_l, tn_l, bound(la), cone_boxes(g)) < inf  # [R', L]
                a, b, ra, rb = _geom_columns(g)
                t, _, hit = ray_round_cone(_columns(o_l), _columns(d_l), a, b, ra, rb, tn_l[:, None],
                                           tx[la, None], any_hit)
                t = torch.where(hit & entered, t, MISS_T).min(dim=1).values
                leaves[la] += 1
                cones[la] += entered.sum(dim=1, dtype=torch.int32)
                forms[la] += entered.any(dim=1).to(torch.int32)
                best[la] = torch.minimum(best[la], t)
                if any_hit:
                    live[la[t < MISS_T]] = False
            ia, inode = act[~leaf], node[~leaf]
            if ia.numel():
                lvl = torch.searchsorted(starts, inode, right=True) - 1
                push(ia, starts[lvl + 1] + CONE_WIDE * (inode - starts[lvl]), CONE_WIDE)
        out.boxes[rs], out.leaves[rs], out.cones[rs], out.forms[rs], out.t[rs] = boxes, leaves, cones, forms, best
    return out


def cones_entered(geom, o, d, tmin, tfar, chunk: int = 64):
    """Per ray, the live cones whose own box (cone_boxes) its interval
    [tmin, tfar] enters by the port's box test -> [N] i64. With tfar the
    final t of a closest sweep this is the least work of any walk over these
    boxes: the count of the kernels' roofline (benchmark/bounds.py counts
    the same cones on its own boxes)."""
    boxes = cone_boxes(geom)
    live = tfar > tmin
    out = torch.zeros(tmin.shape[0], dtype=torch.int64, device=tmin.device)
    for r0 in range(0, tmin.shape[0], chunk):
        rs = slice(r0, min(tmin.shape[0], r0 + chunk))
        enters = slab_enters([c[rs] for c in o], [c[rs] for c in d], tmin[rs], tfar[rs], boxes)
        out[rs] = torch.where(live[rs], enters.sum(dim=1), 0)
    return out
