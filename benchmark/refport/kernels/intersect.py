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
the sweep the culled one is held against).
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


def intersect_closest(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int, bounds=None):
    """K2's function: the plain dense sweep on any device -> (t, prim, u, v)."""
    return closest_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask)


def intersect_any(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int, bounds=None):
    """K3's function: the plain dense sweep on any device -> [N] bool."""
    return any_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask)
