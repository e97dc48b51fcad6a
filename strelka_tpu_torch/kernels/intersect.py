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
the sweep the culled one is held against). `closest_walk_plain` and
`any_walk_plain` repeat the walks of one ray a warp in plain PyTorch, with
the groups each ray tests; the kernels count them with `stats=True`.
"""

from __future__ import annotations

import numpy as np
import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import build
from strelka_tpu_torch.ops.slab import slab_tnear

MISS_T = 1e16
GROUP = 32  # triangles a group (csrc/intersect.cu:kGroup): one a lane of a warp
SCHEDULES = {"warp": 0, "thread": 1}  # one ray a warp, one ray a thread
THREAD_MAX_GROUPS = 8  # up to this many groups a launch takes one ray a thread (pick_schedule)
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


def _group_rows(grp, ntri, dev):
    """Triangle ids [R, GROUP] of the groups grp [R] and which of them exist."""
    j = grp[:, None] * GROUP + torch.arange(GROUP, device=dev)[None, :]
    return j.clamp(max=ntri - 1), j < ntri


def _group_hits(oc, dc, tn, tx, ex, v0, e1, e2, mask, ray_mask, grp):
    """Rays [R] against the triangles of their groups grp [R] -> t, u, v, hit [R, GROUP], ids [R, GROUP]."""
    j, exists = _group_rows(grp, v0.shape[0], grp.device)
    t, u, v, hit = mt_block(oc, dc, v0[j], e1[j], e2[j], tn, tx)
    hit = hit & exists & ((mask[j] & ray_mask) != 0)
    if ex is not None:
        hit = hit & (j != ex[:, None])
    return t, u, v, hit, j


def closest_walk_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int, bounds):
    """K2's walk with one ray a warp, in plain PyTorch -> (t, prim, u, v,
    groups tested), each [N]. Each live ray slab-tests the group boxes 32 at
    a time against [tmin, min(best t, tmax)], takes the entered groups of
    those 32 nearest first (of equal tnear the lowest group), tests each
    group's triangles (a triangle replaces the best hit on t < best, or on
    equal t and a lower id) and stops at the first group whose tnear is
    greater than its best t. The result is `closest_plain`'s bit for bit."""
    n, ng = tmin.shape[0], bounds.shape[1]
    dev = tmin.device
    inf = float("inf")
    t_out = torch.full((n,), MISS_T, dtype=torch.float32, device=dev)
    p_out = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros(n, dtype=torch.float32, device=dev)
    v_out = torch.zeros(n, dtype=torch.float32, device=dev)
    g_out = torch.zeros(n, dtype=torch.int32, device=dev)
    chunk = _RAY_CHUNK[dev.type]
    for r0 in range(0, n, chunk):
        rs = slice(r0, min(n, r0 + chunk))
        oc, dc, tn, tx = [c[rs] for c in o], [c[rs] for c in d], tmin[rs], tmax[rs]
        ex = exclude[rs] if exclude is not None else None
        best_t, best_p = t_out[rs].clone(), p_out[rs].clone()
        best_u, best_v, tested = u_out[rs].clone(), v_out[rs].clone(), g_out[rs].clone()
        live = torch.nonzero(tx > tn)[:, 0]
        sel = lambda ids: ([c[ids] for c in oc], [c[ids] for c in dc])  # noqa: E731
        for base in range(0, ng, GROUP):
            rows = live
            bound = torch.minimum(best_t[rows], tx[rows])
            tnear = slab_tnear(*sel(rows), tn[rows], bound, bounds[:, base:base + GROUP])
            while rows.numel():
                at = torch.argmin(tnear, dim=1)  # the first (lowest group) of equal minima
                take = tnear.gather(1, at[:, None])[:, 0] <= best_t[rows]  # strict stop: tnear > best t
                rows, tnear, at = rows[take], tnear[take], at[take]
                tnear[torch.arange(rows.shape[0], device=dev), at] = inf
                tested[rows] += 1
                t, u, v, hit, j = _group_hits(*sel(rows), tn[rows], tx[rows], None if ex is None else ex[rows], v0,
                                              e1, e2, mask, ray_mask, base + at)
                bt, bp = best_t[rows, None], best_p[rows, None]
                better = hit & ((t < bt) | ((t == bt) & (j < bp)))
                k = torch.nonzero(better.any(dim=1))[:, 0]
                a = torch.argmin(torch.where(better, t, inf), dim=1)[k]  # the least t, of equal t the lowest id
                up = rows[k]
                best_t[up], best_p[up] = t[k, a], j[k, a].to(torch.int32)
                best_u[up], best_v[up] = u[k, a], v[k, a]
        t_out[rs], p_out[rs], u_out[rs], v_out[rs], g_out[rs] = best_t, best_p, best_u, best_v, tested
    return t_out, p_out, u_out, v_out, g_out


def any_walk_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int, bounds):
    """K3's walk with one ray a warp, in plain PyTorch -> (occluded [N] bool,
    groups tested [N] i32, triangles whose mask matches in those groups [N]
    i64, per group whether a ray tested it [G] bool). Each live ray takes the
    groups its interval [tmin, tmax] enters in ascending order and stops
    after the group with its first hit."""
    n, ng = tmin.shape[0], bounds.shape[1]
    dev = tmin.device
    occ = torch.zeros(n, dtype=torch.bool, device=dev)
    groups = torch.zeros(n, dtype=torch.int32, device=dev)
    tris = torch.zeros(n, dtype=torch.int64, device=dev)
    touched = torch.zeros(ng, dtype=torch.bool, device=dev)
    matching = _matching(mask, ray_mask, ng)
    chunk = _RAY_CHUNK[dev.type]
    for r0 in range(0, n, chunk):
        rs = slice(r0, min(n, r0 + chunk))
        oc, dc, tn, tx = [c[rs] for c in o], [c[rs] for c in d], tmin[rs], tmax[rs]
        ex = exclude[rs] if exclude is not None else None
        entered = (slab_tnear(oc, dc, tn, tx, bounds) < float("inf")) & (tx > tn)[:, None]
        acc = occ[rs].clone()
        for g in torch.nonzero(entered.any(dim=0))[:, 0].tolist():
            rows = torch.nonzero(entered[:, g] & ~acc)[:, 0]
            if not rows.numel():
                continue
            grp = torch.full((rows.shape[0],), g, dtype=torch.int64, device=dev)
            *_, hit, _ = _group_hits([c[rows] for c in oc], [c[rows] for c in dc], tn[rows], tx[rows],
                                     None if ex is None else ex[rows], v0, e1, e2, mask, ray_mask, grp)
            groups[r0 + rows] += 1
            tris[r0 + rows] += matching[g]
            touched[g] = True
            acc[rows] = hit.any(dim=1)
        occ[rs] = acc
    return occ, groups, tris, touched


def _matching(mask, ray_mask: int, ng: int):
    """Triangles whose mask matches the ray mask, per group -> [G] i64."""
    j, exists = _group_rows(torch.arange(ng, device=mask.device), mask.shape[0], mask.device)
    return (((mask[j] & ray_mask) != 0) & exists).sum(dim=1)


def groups_entered(o, d, tmin, tfar, mask, ray_mask: int, bounds, chunk: int = 16384):
    """Per ray, the groups whose box its interval [tmin, tfar] enters and
    the triangles whose mask matches in them, and per group whether a ray
    enters it -> ([N] i32, [N] i64, [G] bool). With tfar the final t of a
    closest sweep this is the work K2 needs."""
    n, ng = tmin.shape[0], bounds.shape[1]
    dev = tmin.device
    matching = _matching(mask, ray_mask, ng).to(torch.float64)
    groups = torch.zeros(n, dtype=torch.int32, device=dev)
    tris = torch.zeros(n, dtype=torch.int64, device=dev)
    touched = torch.zeros(ng, dtype=torch.bool, device=dev)
    for r0 in range(0, n, chunk):
        rs = slice(r0, min(n, r0 + chunk))
        entered = (slab_tnear([c[rs] for c in o], [c[rs] for c in d], tmin[rs], tfar[rs], bounds) < float("inf"))
        entered = entered & (tfar[rs] > tmin[rs])[:, None]
        groups[rs] = entered.sum(dim=1, dtype=torch.int32)
        tris[rs] = (entered.to(torch.float64) @ matching).to(torch.int64)
        touched |= entered.any(dim=0)
    return groups, tris, touched


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


def pick_schedule(ntri: int, stats: bool) -> str:
    """The schedule a launch takes when the caller names none: one ray a
    thread for a scene of at most THREAD_MAX_GROUPS groups (a ray's walk
    there is a few slab tests and a group at most, cheaper on one lane than
    on a warp), one ray a warp above, and whenever the groups tested are
    counted."""
    return "warp" if stats or -(-ntri // GROUP) > THREAD_MAX_GROUPS else "thread"


def _check_groups(bounds, ntri: int, cull: bool, schedule: str, stats: bool, n: int, dev, name: str) -> int:
    """The group boxes and the schedule a launch takes -> the number of groups."""
    ng = -(-ntri // GROUP)
    if schedule not in SCHEDULES:
        raise ValueError(f"{name}: schedule must be one of {sorted(SCHEDULES)}")
    if stats and schedule != "warp":
        raise ValueError(f"{name}: only the one-ray-a-warp schedule counts the groups a ray tests")
    if schedule == "warp" and n > COUNTER_MAX:
        raise ValueError(f"{name}: {n} rays: the int32 ray counter could overflow")
    if cull:
        if bounds is None:
            raise ValueError(f"{name}: the cull needs the group boxes (tri_group_bounds); cull=False sweeps all")
        if (bounds.dtype != torch.float32 or bounds.shape != (8, ng) or not bounds.is_contiguous()
                or bounds.device != dev):
            raise ValueError(f"{name}: group boxes must be contiguous [8, {ng}] f32 on {dev}")
    return ng


def _launch(entry: str, o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int, bounds, cull: bool,
            schedule, stats: bool):
    """Check, launch and count one K2/K3 call -> (its outputs, the groups
    tested per ray or None). K2's four outputs (and the counts) are rows of
    one allocation: the host time of a call is part of a main path's."""
    name = entry.removeprefix("strelka_")
    check_rays_tris(o, d, tmin, tmax, exclude, v0, e1, e2, mask, name)
    n, ntri = tmin.shape[0], v0.shape[0]
    dev = tmin.device
    schedule = schedule or pick_schedule(ntri, stats)
    ng = _check_groups(bounds, ntri, cull, schedule, stats, n, dev, name)
    if entry == "strelka_intersect_any":
        outs = (torch.empty(n, dtype=torch.bool, device=dev),)
        groups = torch.empty(n, dtype=torch.int32, device=dev) if stats else None
    else:
        rows = torch.empty((5 if stats else 4, n), dtype=torch.float32, device=dev)  # t, prim, u, v, groups
        outs = (rows[0], rows[1].view(torch.int32), rows[2], rows[3])
        groups = rows[4].view(torch.int32) if stats else None
    if n:
        next_ray = torch.empty(1, dtype=torch.int32, device=dev) if schedule == "warp" else None
        rc = getattr(build.load(), entry)(
            *ray_tri_ptrs(o, d, tmin, tmax, exclude, v0, e1, e2, mask), bounds.data_ptr() if cull else None,
            int(ray_mask), n, ntri, ng, int(bool(cull)), SCHEDULES[schedule],
            None if next_ray is None else next_ray.data_ptr(), *(a.data_ptr() for a in outs),
            None if groups is None else groups.data_ptr(), build.stream_ptr(dev),
        )
        build.check(rc, name)
        K.count_launch(name, (n, ntri))  # rays, triangles
    return outs, groups


def intersect_closest(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int, bounds=None, cull: bool = True,
                      stats: bool = False, schedule=None):
    """K2 -> (t, prim, u, v): t = 1e16, prim = -1, u = v = 0 on a miss; with
    stats=True (t, prim, u, v, groups tested [N] i32). bounds: the group
    boxes (tri_group_bounds), which the cull needs; cull=False sweeps every
    group. schedule "warp" (one ray a warp) or "thread" (one ray a thread),
    the same result; None takes `pick_schedule`'s. CPU tensors take the
    dense plain version."""
    if tmin.device.type == "cpu":
        if stats:
            raise ValueError("intersect_closest: stats come from the kernel; the plain version counts nothing")
        return closest_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask)
    outs, groups = _launch("strelka_intersect_closest", o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask,
                           bounds, cull, schedule, stats)
    return (*outs, groups) if stats else outs


def intersect_any(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask: int, bounds=None, cull: bool = True,
                  stats: bool = False, schedule=None):
    """K3 -> occluded [N] bool; with stats=True (occluded, groups tested [N] i32).
    Arguments as intersect_closest's."""
    if tmin.device.type == "cpu":
        if stats:
            raise ValueError("intersect_any: stats come from the kernel; the plain version counts nothing")
        return any_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask)
    (occ,), groups = _launch("strelka_intersect_any", o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask, bounds,
                             cull, schedule, stats)
    return (occ, groups) if stats else occ
