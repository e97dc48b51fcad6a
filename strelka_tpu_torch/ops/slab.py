"""The port's one ray-box test: the reference's slab test with a margin.

Every walk that culls by boxes takes it: kernels K2/K3 over the 32-triangle
group boxes, K5 over the child boxes of its BVH, K7/K8 over the boxes of
the cone tree and each swept leaf's cones' own boxes, and K9 over the
superblock boxes of a tile's rays. The device twin is
csrc/common.cuh:strelka_slab_safe, with the same operations in the same
order (built with -fmad=false), so the plain walks and the kernels agree
bit for bit.

The reference's test (strelka_tpu/ops/pallas_intersect.py:_tile_hits_block,
ops/bvh.py:_slab_test): inv = 1 / where(|d| > 1e-20, d, 1e-20), per axis
t0 = (lo - o) * inv, t1 = (hi - o) * inv, tnear = max(tmin, min(t0, t1)),
tfar = min(tmax, max(t0, t1)), entered when tnear <= tfar. Möller–Trumbore
(and the round-cone closed form) can accept a hit that its own rounding
puts just outside the box of its primitive, or at a t just below the
box's rounded entry, and an exact box test then drops it. The margin:

  * the box is padded on every side by PAD * (|o|_inf + |box|_inf), where
    |box|_inf is the largest magnitude of its six coordinates: the hit
    point's rounding error scales with the magnitudes the test works on;
  * tnear is lowered by SLACK * |tnear| before it is compared with
    min(tfar, tmax) and before a walk compares it with its best t: the
    slab test's own rounding is relative to t.

PERF.md section 6 ("The margin, derived") derives both constants and the
domain they cover: every hit that Möller–Trumbore accepts at a normalised
determinant |det| / (|d| |e1| |e2|) >= NU_MIN (the sine of the triangle's
angle at v0 times the cosine of the ray's angle to the normal) lies in the
padded box of any box holding its triangle, at a tnear no greater than its
t. With PAD = SLACK = 0 the test is the reference's, bit for bit.
"""

from __future__ import annotations

import torch

PAD = 2.0 ** -13  # box pad per unit of |o|_inf + |box|_inf (csrc/common.cuh:kStrelkaPad)
SLACK = 2.0 ** -20  # tnear lowered by this share of |tnear| (csrc/common.cuh:kStrelkaSlack)
NU_MIN = 0.077  # the least normalised determinant the margin covers (PERF.md section 6)


def ray_scale(o):
    """|o|_inf of each ray: (x, y, z) of [R] -> [R]."""
    return torch.maximum(torch.maximum(torch.abs(o[0]), torch.abs(o[1])), torch.abs(o[2]))


def box_scale(bounds):
    """|box|_inf: the largest magnitude of a box's six coordinates, [8, ...] -> [...]."""
    a = torch.abs(bounds[0:6])
    return torch.maximum(torch.maximum(torch.maximum(a[0], a[1]), torch.maximum(a[2], a[3])),
                         torch.maximum(a[4], a[5]))


def inv_dir(d):
    """The reference's reciprocal direction 1 / where(|d| > 1e-20, d, 1e-20), per component."""
    return [1.0 / torch.where(torch.abs(c) > 1e-20, c, 1e-20) for c in d]


def slab_tnear(o, d, tmin, tmax, bounds, pad: float = PAD, slack: float = SLACK, reach: float = 0.0):
    """[R] rays x [8, B] boxes (or [8, R, B], each ray its own) -> [R, B]
    f32: the lowered tnear where the ray's interval [tmin, tmax] enters the
    padded box, inf where it does not or the box is inverted (lo > hi).

    With `reach` (the boxes of round cones, ops/curves.py:CONE_REACH) the
    pad is the larger of PAD * s and sqrt(r^2 + (reach * s)^2) - r, where
    s = |o|_inf + |box|_inf and r is the box's row 6, the least radius of
    its cones: the distance beyond a cone's surface at which its closed form
    can still report a hit (ROADMAP C.6)."""
    if bounds.dim() == 2:
        bounds = bounds[:, None, :]
    inv = inv_dir(d)
    s = ray_scale(o)[:, None] + box_scale(bounds)
    p = s * pad
    if reach:
        g = s * reach
        p = torch.maximum(p, torch.sqrt(bounds[6] * bounds[6] + g * g) - bounds[6])
    tnear = tmin[:, None]
    tfar = tmax[:, None]
    for c in range(3):
        t0 = ((bounds[c] - p) - o[c][:, None]) * inv[c][:, None]
        t1 = ((bounds[3 + c] + p) - o[c][:, None]) * inv[c][:, None]
        tnear = torch.maximum(tnear, torch.minimum(t0, t1))
        tfar = torch.minimum(tfar, torch.maximum(t0, t1))
    tnear = tnear - torch.abs(tnear) * slack
    return torch.where((tnear <= tfar) & (bounds[0] <= bounds[3]), tnear, float("inf"))


def slab_enters(o, d, tmin, tmax, bounds):
    """[R] rays x [8, B] boxes -> [R, B] bool: does the ray's interval
    [tmin, tmax] enter the box (slab_tnear)?"""
    return slab_tnear(o, d, tmin, tmax, bounds) < float("inf")


def normalised_det(d, e1, e2, paired: bool = False):
    """|d . (e1 x e2)| / (|d| |e1| |e2|) in f64 for rays d [R] (x, y, z) and
    triangles e1, e2 [T, 3] -> [R, T], or with `paired` one triangle a ray
    (e1, e2 [R, 3]) -> [R]: the sine of the triangle's angle at v0 times the
    cosine of the ray's angle to its normal. The margin covers every hit at
    NU_MIN or above."""
    dd = torch.stack([c.double() for c in d], dim=1)
    n = torch.linalg.cross(e1.double(), e2.double())
    sides = torch.linalg.norm(e1.double(), dim=1) * torch.linalg.norm(e2.double(), dim=1)
    if paired:
        return torch.abs((dd * n).sum(dim=1)) / torch.clamp(torch.linalg.norm(dd, dim=1) * sides, min=1e-300)
    den = torch.linalg.norm(dd, dim=1)[:, None] * sides[None, :]
    return torch.abs(dd @ n.T) / torch.clamp(den, min=1e-300)
