"""Kernels K7 (closest hit) and K8 (any hit) over round cones (hair).

K7 `cone_closest` and K8 `cone_any` replace the three cone kernels of
strelka_tpu/ops/curves.py (pallas_intersect_cones, _fusedk, _wl: one
function, three TPU schedules); the CUDA source is csrc/cones.cu, which
also gives their schedule (persistent warps, one ray a warp; K7 walks each
ray's boxes nearest first). Their
plain version is the dense sweep `ops/curves.py:intersect_curves_closest_plain`,
the CPU reference's `intersect_curves_closest` in PyTorch; the kernels do the
same f32 arithmetic per (ray, cone) and keep the lowest index of equal t, so
they are held to equality.

Rays: o and d are (x, y, z) triples of [N] f32 tensors, tmin/tmax [N] f32
(tmax <= tmin: a dead lane). Cones: a `PackedCones`, the device's one cone
table [M_pad, 8] = (a.xyz, ra, b.xyz, rb) (ops/curves.py:cone_major_rows of
the rows of pack_cones), which the kernels and the plain version both read,
with the [8, nb] sub-block boxes and the [8, nb / super] superblock boxes
(pack_cones, cone_super_bounds). `cull=False` sweeps every cone (the brute
force the culled sweep is compared with). `order`, a `SweepOrder` from kernel
K9 (kernels/open_w.py:sweep_order), gives each ray tile its superblocks:
K8 (and K7 with `near_to_far=False`) walks them in the list's order in place
of ascending, K7 takes them as its candidates and walks those it enters
nearest first. The result is the same whatever the walk, and the plain
version and `cull=False` ignore both. `stats=True` also returns a
`ConeStats`: per ray the sub-blocks swept and the cone positions stepped
through, and for the launch the lane slots its cone loop issued and those
that tested a cone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refport.ops import curves as C
from refport.ops.slab import slab_enters

SUPER_NEAR_TO_FAR = 8  # sub-blocks a superblock on K7's near-to-far walk (a lane each)
LANES = 32
STEP = 64  # cones a warp tests a step (csrc/cones.cu:kStep): a sub-block holds a whole number of steps
SMEM_PER_BLOCK = 227 * 1024  # the most shared memory a block on the H100 can use
COUNTER_MAX = 2 ** 31 - 1  # the kernels' ray counter is an int32


class PackedCones(NamedTuple):
    geom: torch.Tensor  # [M_pad, 8] f32: (a.xyz, ra, b.xyz, rb)
    bounds: torch.Tensor  # [8, nb] f32
    sbounds: torch.Tensor  # [8, nb / super] f32

    @property
    def shape(self) -> tuple:
        """(cones, sub-blocks, superblocks): what defines a launch beside the rays."""
        return (self.geom.shape[0], self.bounds.shape[1], self.sbounds.shape[1])


class ConeStats(NamedTuple):
    per_ray: torch.Tensor  # [2, N] i32: sub-blocks swept, cone positions stepped through (padding included)
    slots: torch.Tensor  # [2] i64: lane slots the cone loop issued, lane slots that tested a cone


def closest_plain(o, d, tmin, tmax, cones: PackedCones, block: int = C.CONE_TBLK):
    """Plain K7 -> (t, cone, y), each [N]."""
    return C.intersect_curves_closest_plain(cones.geom, o, d, tmin, tmax, block)


def any_plain(o, d, tmin, tmax, cones: PackedCones, block: int = C.CONE_TBLK):
    """Plain K8 -> occluded [N] bool."""
    return C.intersect_curves_any_plain(cones.geom, o, d, tmin, tmax, block)


RAY_CHUNK = 4096  # rays whose sub-block boxes are tested together
PAIR_CHUNK = 16384  # (ray, sub-block) pairs whose cones are tested together


def culled_plain(o, d, tmin, tmax, cones: PackedCones, any_hit: bool = False):
    """The dense sweep's answer, testing only the cones of the sub-blocks a
    ray's interval enters (the port's box test with its margin,
    ops/slab.py:slab_enters, on the sub-block boxes) -> (t, cone, y), each
    [N]. Of equal t the lowest cone index wins, as in the dense sweep."""
    n, dev = tmin.shape[0], tmin.device
    nb = cones.bounds.shape[1]
    tblk = cones.geom.shape[0] // nb
    geom = cones.geom.view(nb, tblk, 8)
    best_t = torch.full((n,), C.MISS_T, dtype=torch.float32, device=dev)
    best_c = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_y = torch.zeros(n, dtype=torch.float32, device=dev)
    big = torch.iinfo(torch.int64).max
    for r0 in range(0, n, RAY_CHUNK):
        r1 = min(n, r0 + RAY_CHUNK)
        oc, dc = [c[r0:r1] for c in o], [c[r0:r1] for c in d]
        tn, tx = tmin[r0:r1], tmax[r0:r1]
        enters = slab_enters(oc, dc, tn, tx, cones.bounds) & (tx > tn)[:, None]
        rays, blocks = torch.nonzero(enters, as_tuple=True)
        for p0 in range(0, rays.numel(), PAIR_CHUNK):
            r, b = rays[p0:p0 + PAIR_CHUNK], blocks[p0:p0 + PAIR_CHUNK]
            a_, b_, ra, rb = C._geom_columns(geom[b])
            t, y, hit = C.ray_round_cone(tuple(c[r][:, None] for c in oc), tuple(c[r][:, None] for c in dc),
                                         a_, b_, ra, rb, tn[r][:, None], tx[r][:, None], any_hit)
            t = torch.where(hit & (ra >= 0.0), t, C.MISS_T)
            arg = torch.argmin(t, dim=1)  # first (lowest index) of equal minima
            rows = torch.arange(r.numel(), device=dev)
            t_p, y_p, c_p = t[rows, arg], y[rows, arg], b * tblk + arg
            ray = r + r0
            # the least (t, cone) of each ray's pairs, merged with what earlier chunks found
            t_min = best_t.clone().scatter_reduce_(0, ray, t_p, "amin")
            at_min = (t_p == t_min[ray]) & (t_p < C.MISS_T)
            c_min = torch.full((n,), big, dtype=torch.int64, device=dev).scatter_reduce_(
                0, ray[at_min], c_p[at_min], "amin")
            keep_old = (best_t == t_min) & (best_c >= 0) & (best_c < c_min)
            won = at_min & (c_p == c_min[ray]) & ~keep_old[ray]
            best_y = best_y.scatter(0, ray[won], y_p[won])
            best_c = torch.where(keep_old | (c_min == big), best_c, c_min)
            best_t = t_min
    return best_t, best_c.to(torch.int32), best_y


def cone_closest(o, d, tmin, tmax, cones: PackedCones):
    """K7's function: the dense sweep's answer from the cones of the entered sub-blocks -> (t, cone, y)."""
    return culled_plain(o, d, tmin, tmax, cones)


def cone_any(o, d, tmin, tmax, cones: PackedCones):
    """K8's function: occlusion by any cone of the entered sub-blocks -> [N] bool."""
    return culled_plain(o, d, tmin, tmax, cones, any_hit=True)[1] >= 0
