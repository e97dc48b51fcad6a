"""Kernels K2 (closest hit) and K3 (any hit) over a flat triangle list.

K2 replaces `strelka_tpu/ops/pallas_intersect.py:pallas_intersect_closest_mxu_small`
and K3 `pallas_intersect_any_mxu_small`; the CUDA source is csrc/intersect.cu.
The plain versions below follow `intersect_closest_bruteforce` and
`intersect_any_bruteforce` of strelka_tpu/ops/intersect.py: f32
Möller–Trumbore in the same operation order, triangles in blocks of 512
(and rays in chunks) so that 2^16 rays stay small in memory.

Rays are component arrays: o and d are (x, y, z) triples of [N] f32
tensors, tmin/tmax [N] f32, exclude [N] int32 or None (the prim each ray
starts from, rejected by id). Triangles: v0, e1, e2 [T, 3] f32 and the
geometry mask [T] int32.
"""

from __future__ import annotations

import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import build

MISS_T = 1e16
_TRI_BLOCK = 512
# rays per plain-version chunk: [chunk, 512] temporaries of 8 MB on the CPU,
# 128 MB on the card (where the plain version runs only to check the kernel)
_RAY_CHUNK = {"cpu": 4096, "cuda": 65536}
# f32 operations of one ray-triangle test (csrc/intersect.cu:ray_tri): two
# crosses (9 each), four dots (5 each), three subtractions, the reciprocal,
# three scalings by it and u + v.
MT_FLOPS = 46


def mt_block(o, d, v0, e1, e2, tmin, tmax):
    """Möller–Trumbore: rays [R] x triangles [B] -> t, u, v, hit [R, B].

    The operation order of strelka_tpu/ops/intersect.py:_ray_tri_block."""
    oc = [c[:, None] for c in o]
    dc = [c[:, None] for c in d]
    v0c = [v0[None, :, k] for k in range(3)]
    e1c = [e1[None, :, k] for k in range(3)]
    e2c = [e2[None, :, k] for k in range(3)]

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


def check_rays_tris(o, d, tmin, tmax, exclude, v0, e1, e2, mask, name):
    """Raise on what the intersection kernels (K2/K3, K5/K6) do not take."""
    K.require_cuda(tmin, name)
    n = tmin.shape[0]
    dev = tmin.device
    for a in (*o, *d, tmin, tmax):
        if a.dtype != torch.float32 or a.shape != (n,) or not a.is_contiguous() or a.device != dev:
            raise ValueError(f"{name}: ray components must be contiguous [N] f32 on {dev}")
    if exclude is not None and (exclude.dtype != torch.int32 or exclude.shape != (n,)
                                or not exclude.is_contiguous() or exclude.device != dev):
        raise ValueError(f"{name}: exclude must be a contiguous [N] int32 tensor on {dev}")
    ntri = v0.shape[0]
    for a in (v0, e1, e2):
        if a.dtype != torch.float32 or a.shape != (ntri, 3) or not a.is_contiguous() or a.device != dev:
            raise ValueError(f"{name}: v0/e1/e2 must be contiguous [T, 3] f32 on {dev}")
    if mask.dtype != torch.int32 or mask.shape != (ntri,) or not mask.is_contiguous() or mask.device != dev:
        raise ValueError(f"{name}: geometry mask must be a contiguous [T] int32 tensor on {dev}")
    if ntri >= 2 ** 31:
        raise ValueError(f"{name}: too many triangles")


def ray_tri_ptrs(o, d, tmin, tmax, exclude, v0, e1, e2, mask):
    """Device pointers: 8 ray components and exclude (None = null), then v0, e1, e2, mask."""
    return [a.data_ptr() for a in (*o, *d, tmin, tmax)] + [
        exclude.data_ptr() if exclude is not None else None,
        v0.data_ptr(), e1.data_ptr(), e2.data_ptr(), mask.data_ptr(),
    ]


def intersect_closest(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int):
    """K2 -> (t, prim, u, v): t = 1e16, prim = -1, u = v = 0 on a miss."""
    if tmin.device.type == "cpu":
        return closest_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask)
    check_rays_tris(o, d, tmin, tmax, exclude, v0, e1, e2, mask, "intersect_closest")
    n = tmin.shape[0]
    dev = tmin.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, prim, u, v
    rc = build.load().strelka_intersect_closest(
        *ray_tri_ptrs(o, d, tmin, tmax, exclude, v0, e1, e2, mask), int(ray_mask), n, v0.shape[0],
        t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), build.stream_ptr(dev),
    )
    build.check(rc, "intersect_closest")
    K.count_launch("intersect_closest", (n, v0.shape[0]))  # rays, triangles
    return t, prim, u, v


def intersect_any(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int):
    """K3 -> occluded [N] bool."""
    if tmin.device.type == "cpu":
        return any_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask)
    check_rays_tris(o, d, tmin, tmax, exclude, v0, e1, e2, mask, "intersect_any")
    n = tmin.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=tmin.device)
    if n == 0:
        return occ
    rc = build.load().strelka_intersect_any(
        *ray_tri_ptrs(o, d, tmin, tmax, exclude, v0, e1, e2, mask), int(ray_mask), n, v0.shape[0],
        occ.data_ptr(), build.stream_ptr(tmin.device),
    )
    build.check(rc, "intersect_any")
    K.count_launch("intersect_any", (n, v0.shape[0]))  # rays, triangles
    return occ
