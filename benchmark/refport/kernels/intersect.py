"""Kernels K2 (closest hit) and K3 (any hit) over a flat triangle list.

K2 replaces `strelka_tpu/ops/pallas_intersect.py:pallas_intersect_closest_mxu_small`
and K3 `pallas_intersect_any_mxu_small`; the CUDA source is csrc/intersect.cu,
which also gives their schedule. The plain versions `closest_plain` and
`any_plain` follow `intersect_closest_bruteforce` and
`intersect_any_bruteforce` of strelka_tpu/ops/intersect.py: f32
Möller–Trumbore in the same operation order, triangles in blocks of 512
(and rays in chunks) so that 2^16 rays stay small in memory. CPU tensors
take them.

Rays are component arrays: o and d are (x, y, z) triples of [N] f32
tensors, tmin/tmax [N] f32, exclude [N] int32 or None (the prim each ray
starts from, rejected by id). Triangles: v0, e1, e2 [T, 3] f32 and the
geometry mask [T] int32, in groups of GROUP consecutive triangles with the
boxes of `tri_group_bounds` ([8, G], `DeviceScene.tri_bounds` of a flat
scene). The kernels test the triangles of the groups a ray's interval
enters by the port's box test with its margin (`ops/slab.py:slab_tnear`),
so that no hit the dense sweep finds is culled (`cull=False`: every group,
the sweep the culled one is held against). The reference sweeps with
`culled_plain`: the dense sweep's Möller–Trumbore on the triangles of the
groups whose box, padded eight times more than the port pads it, the ray's
whole interval enters, merged to the dense sweep's answer (of equal t the
lowest prim). Its domain is at CULL_PAD.
"""

from __future__ import annotations

import numpy as np
import torch

from refport import kernels as K
from refport.ops.slab import slab_tnear

MISS_T = 1e16
GROUP = 32  # triangles a group (csrc/intersect.cu:kGroup): one a lane of a warp
_TRI_BLOCK = 512
# rays per plain-version chunk: [chunk, 512] temporaries of 8 MB on the CPU,
# 128 MB on the card (where the plain version runs only to check the kernel)
_RAY_CHUNK = {"cpu": 4096, "cuda": 65536}
# f32 operations of one ray-triangle test (csrc/common.cuh:strelka_ray_tri): two
# crosses (9 each), four dots (5 each), three subtractions, the reciprocal,
# three scalings by it and u + v.
MT_FLOPS = 46
COUNTER_MAX = 2 ** 31 - 2 ** 24  # the warp schedule's int32 ray counter runs past n by the warps in flight


def tri_group_bounds(v0, e1, e2, geom_mask) -> np.ndarray:
    """Per-group boxes -> [8, G] f32, G = ceil(T / GROUP): rows min xyz, max
    xyz, 0, 0. The reference's block_bounds (strelka_tpu/ops/
    pallas_intersect.py) with tblk = GROUP and super_ = 1: padded and mask-0
    triangles get an inverted box (1e30, -1e30), so a group of them is never
    entered."""
    t = v0.shape[0]
    t_pad = -(-t // GROUP) * GROUP
    ng = t_pad // GROUP
    v0 = np.asarray(v0, np.float32)
    p1 = v0 + np.asarray(e1, np.float32)
    p2 = v0 + np.asarray(e2, np.float32)
    lo = np.minimum(np.minimum(v0, p1), p2)
    hi = np.maximum(np.maximum(v0, p1), p2)
    live = np.asarray(geom_mask) != 0
    big = np.float32(1e30)
    lo = np.concatenate([np.where(live[:, None], lo, big), np.full((t_pad - t, 3), big, np.float32)])
    hi = np.concatenate([np.where(live[:, None], hi, -big), np.full((t_pad - t, 3), -big, np.float32)])
    out = np.zeros((8, ng), np.float32)
    out[0:3] = lo.reshape(ng, GROUP, 3).min(axis=1).T
    out[3:6] = hi.reshape(ng, GROUP, 3).max(axis=1).T
    return out


def mt_block(o, d, v0, e1, e2, tmin, tmax):
    """Möller–Trumbore: rays [R] x triangles [B] (or [R, B], each ray its
    own) -> t, u, v, hit [R, B].

    The operation order of strelka_tpu/ops/intersect.py:_ray_tri_block."""
    oc = [c[:, None] for c in o]
    dc = [c[:, None] for c in d]
    v0c = [v0[..., k] for k in range(3)]
    e1c = [e1[..., k] for k in range(3)]
    e2c = [e2[..., k] for k in range(3)]

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    pvec = cross(dc, e2c)
    det = dot(e1c, pvec)
    det_ok = torch.abs(det) > 1e-12
    inv_det = torch.where(det_ok, 1.0 / det, 0.0)
    tv = (oc[0] - v0c[0], oc[1] - v0c[1], oc[2] - v0c[2])
    u = dot(tv, pvec) * inv_det
    qvec = cross(tv, e1c)
    vv = dot(dc, qvec) * inv_det
    t = dot(e2c, qvec) * inv_det
    hit = det_ok & (u >= 0.0) & (vv >= 0.0) & (u + vv <= 1.0) & (t > tmin[:, None]) & (t < tmax[:, None])
    return t, u, vv, hit


def _valid(hit, mask_blk, ray_mask, start, exclude):
    hit = hit & ((mask_blk & ray_mask) != 0)[None, :]
    if exclude is not None:
        ids = start + torch.arange(mask_blk.shape[0], dtype=torch.int32, device=mask_blk.device)
        hit = hit & (ids[None, :] != exclude[:, None])
    return hit


def closest_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int):
    """Plain K2 -> (t, prim, u, v), each [N]."""
    K.note_plain("intersect_closest", tmin.device)
    n, ntri = tmin.shape[0], v0.shape[0]
    dev = tmin.device
    t_out = torch.full((n,), MISS_T, dtype=torch.float32, device=dev)
    p_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros(n, dtype=torch.float32, device=dev)
    v_out = torch.zeros(n, dtype=torch.float32, device=dev)
    chunk = _RAY_CHUNK[dev.type]
    for r0 in range(0, n, chunk):
        rs = slice(r0, min(n, r0 + chunk))
        oc, dc = [c[rs] for c in o], [c[rs] for c in d]
        ex = exclude[rs] if exclude is not None else None
        best_t, best_p, best_u, best_v = t_out[rs], p_out[rs], u_out[rs], v_out[rs]
        rows = torch.arange(best_t.shape[0], device=dev)
        for start in range(0, ntri, _TRI_BLOCK):
            bs = slice(start, min(ntri, start + _TRI_BLOCK))
            t, u, v, hit = mt_block(oc, dc, v0[bs], e1[bs], e2[bs], tmin[rs], tmax[rs])
            hit = _valid(hit, mask[bs], ray_mask, start, ex)
            t = torch.where(hit, t, MISS_T)
            arg = torch.argmin(t, dim=1)  # first (lowest id) of equal minima
            t_blk = t[rows, arg]
            better = t_blk < best_t
            best_p = torch.where(better, (start + arg).to(torch.int32), best_p)
            best_u = torch.where(better, u[rows, arg], best_u)
            best_v = torch.where(better, v[rows, arg], best_v)
            best_t = torch.where(better, t_blk, best_t)
        t_out[rs], p_out[rs], u_out[rs], v_out[rs] = best_t, best_p, best_u, best_v
    return t_out, p_out, u_out, v_out


def any_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int):
    """Plain K3 -> occluded [N] bool."""
    K.note_plain("intersect_any", tmin.device)
    n, ntri = tmin.shape[0], v0.shape[0]
    occ = torch.zeros(n, dtype=torch.bool, device=tmin.device)
    chunk = _RAY_CHUNK[tmin.device.type]
    for r0 in range(0, n, chunk):
        rs = slice(r0, min(n, r0 + chunk))
        oc, dc = [c[rs] for c in o], [c[rs] for c in d]
        ex = exclude[rs] if exclude is not None else None
        acc = occ[rs]
        for start in range(0, ntri, _TRI_BLOCK):
            bs = slice(start, min(ntri, start + _TRI_BLOCK))
            _, _, _, hit = mt_block(oc, dc, v0[bs], e1[bs], e2[bs], tmin[rs], tmax[rs])
            acc = acc | _valid(hit, mask[bs], ray_mask, start, ex).any(dim=1)
        occ[rs] = acc
    return occ


# The reference's cull: the port's box test (ops/slab.py) with 8x its pad and
# slack, against each ray's whole interval [tmin, tmax]. The port's margin is
# derived for hits at a normalised determinant of NU_MIN (0.077) or more. The
# hit point's rounding error grows about as 1 / the determinant, so to first
# order 8x covers about 0.0096 or more. That is an estimate; below it the
# cull is held by measurement alone:
# test_bench_reference.py's grazing rays (aimed at triangle edges and vertices
# nearly in their plane, hits below 1e-6) find no hit of the dense sweep
# lost, where the port's own pad loses some
CULL_PAD = 2.0 ** -10
CULL_SLACK = 2.0 ** -17
RAY_CHUNK = 1024  # rays whose group boxes are tested together
PAIR_CHUNK = 65536  # (ray, group) pairs whose triangles are tested together


def culled_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int, bounds, any_hit: bool = False):
    """The dense sweep's answer, testing only the triangles of the groups
    whose padded box (bounds: tri_group_bounds) the ray's interval enters
    -> (t, prim, u, v), each [N], or with any_hit occluded [N] bool. The
    same Möller–Trumbore on each (ray, triangle) as closest_plain; of equal
    t the lowest prim wins, as in the dense sweep."""
    n, ntri, dev = tmin.shape[0], v0.shape[0], tmin.device
    ng = bounds.shape[1]
    pad = ng * GROUP - ntri
    tris = [torch.cat([a, a.new_zeros((pad, 3))]).view(ng, GROUP, 3) for a in (v0, e1, e2)]
    gmask = torch.cat([mask, mask.new_zeros(pad)]).view(ng, GROUP)
    lane = torch.arange(GROUP, device=dev)
    best_t = torch.full((n,), MISS_T, dtype=torch.float32, device=dev)
    best_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros(n, dtype=torch.float32, device=dev)
    best_v = torch.zeros(n, dtype=torch.float32, device=dev)
    occluded = torch.zeros(n, dtype=torch.int32, device=dev)
    big = torch.iinfo(torch.int64).max
    for r0 in range(0, n, RAY_CHUNK):
        r1 = min(n, r0 + RAY_CHUNK)
        oc, dc = [c[r0:r1] for c in o], [c[r0:r1] for c in d]
        tn, tx = tmin[r0:r1], tmax[r0:r1]
        enters = slab_tnear(oc, dc, tn, tx, bounds, CULL_PAD, CULL_SLACK) < float("inf")
        rays, groups = torch.nonzero(enters & (tx > tn)[:, None], as_tuple=True)
        for p0 in range(0, rays.numel(), PAIR_CHUNK):
            r, g = rays[p0:p0 + PAIR_CHUNK], groups[p0:p0 + PAIR_CHUNK]
            t, u, v, hit = mt_block([c[r] for c in oc], [c[r] for c in dc], *(a[g] for a in tris), tn[r], tx[r])
            ids = g[:, None] * GROUP + lane
            hit = hit & ((gmask[g] & ray_mask) != 0)
            if exclude is not None:
                hit = hit & (ids != exclude[r0 + r][:, None])
            ray = r + r0
            if any_hit:
                occluded.index_add_(0, ray, hit.any(dim=1).to(torch.int32))
                continue
            t = torch.where(hit, t, MISS_T)
            arg = torch.argmin(t, dim=1)  # first (lowest id) of equal minima
            rows = torch.arange(r.numel(), device=dev)
            t_p, u_p, v_p, p_p = t[rows, arg], u[rows, arg], v[rows, arg], ids[rows, arg]
            # the least (t, prim) of each ray's pairs, merged with what earlier chunks found
            t_min = best_t.clone().scatter_reduce_(0, ray, t_p, "amin")
            at_min = (t_p == t_min[ray]) & (t_p < MISS_T)
            p_min = torch.full((n,), big, dtype=torch.int64, device=dev).scatter_reduce_(
                0, ray[at_min], p_p[at_min], "amin")
            keep_old = (best_t == t_min) & (best_p >= 0) & (best_p < p_min)
            won = at_min & (p_p == p_min[ray]) & ~keep_old[ray]
            best_u = best_u.scatter(0, ray[won], u_p[won])
            best_v = best_v.scatter(0, ray[won], v_p[won])
            best_p = torch.where(keep_old | (p_min == big), best_p, p_min)
            best_t = t_min
    if any_hit:
        return occluded > 0
    return best_t, best_p.to(torch.int32), best_u, best_v


def intersect_closest(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int, bounds=None):
    """K2's function on any device -> (t, prim, u, v): the culled sweep with
    the group boxes, else the plain dense sweep."""
    if bounds is None:
        return closest_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask)
    return culled_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask, bounds)


def intersect_any(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int, bounds=None):
    """K3's function on any device -> [N] bool: the culled sweep with the
    group boxes, else the plain dense sweep."""
    if bounds is None:
        return any_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask)
    return culled_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask, bounds, any_hit=True)
