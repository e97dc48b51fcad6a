"""The work a closest-hit sweep needs, counted from the scene's primitives alone.

The yardstick of the kernels' roofline shares. It counts what the rays that
reached a kernel need, whatever tree, sub-block or order the kernel walks:
the primitives whose axis-aligned box a ray's final interval [tmin, t] meets,
t being the ray's closest hit (or its tmax on a miss). The arithmetic is that
of the program's probe (chip_smoke.py: bvh_rows, cone_rows), re-based from
the program's tree and sub-blocks onto the primitives:

* triangles (K5, the BVH closest hit): bytes, each ray's inputs and its hit
  once, and each needed triangle's 40 bytes (v0, e1, e2, mask) once however
  many rays need it, at the card's HBM bandwidth;
* round cones (K7, the cone closest hit): CONE_FLOPS f32 operations per
  (ray, needed cone) at the card's f32 rate, or the rays' bytes where more;
* flat triangles (K2, the closest hit over a flat list): per ray,
  GROUP_BOX_FLOPS for each box of GROUP consecutive triangles (the kernel's
  cull unit, csrc/intersect.cu:kGroup) that its final interval meets, and
  MT_FLOPS for each triangle of those groups whose mask matches, at the
  card's f32 rate, or the rays' bytes (inputs and hit) where more.

The needed primitives are counted over a seeded sample of the live rays:
the cone tests scale to all live rays; the union of needed triangles is the
sample's, a lower count than all rays' (so the share is never overstated).
"""

from __future__ import annotations

import torch

from refport.kernels.intersect import tri_group_bounds

# NVIDIA H100 SXM data sheet, dense: HBM3 bandwidth and f32 outside the tensor cores (at 700 W)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
RAY_IN_BYTES = 36  # origin, direction, tmin, tmax, exclude (f32 / i32)
HIT_BYTES = 16  # t, prim, u, v
TRI_BYTES = 40  # v0, e1, e2 (f32 x 3 each), mask (i32)
CONE_RAY_IN_BYTES = 32  # origin, direction, tmin, tmax
CONE_HIT_BYTES = 12  # t, cone, y
CONE_FLOPS = 119  # f32 operations of one round-cone test (chip_smoke.py: csrc/cones.cu:ray_cone's closed form)
GROUP = 32  # consecutive triangles a group box holds (csrc/intersect.cu:kGroup)
GROUP_BOX_FLOPS = 24  # f32 operations of one slab test (ops/bvh.py:SLAB_FLOPS)
MT_FLOPS = 46  # f32 operations of one Möller-Trumbore test (csrc/common.cuh:strelka_ray_tri)
SAMPLE_RAYS = 2048
CHUNK = 128  # sampled rays a box pass
TINY = 1e-30


def box_overlaps(o, d, tmin, tfar, lo, hi) -> torch.Tensor:
    """[R, B] bool: whether ray r's interval [tmin, tfar] meets box b
    ([B, 3] corners). A direction component of 0 meets a slab only where the
    origin lies in it."""
    inside = torch.ones((o.shape[0], lo.shape[0]), dtype=torch.bool, device=o.device)
    tn = tmin[:, None].clone()
    tf = tfar[:, None].clone()
    for k in range(3):
        oc, dc = o[:, k:k + 1], d[:, k:k + 1]
        flat = dc.abs() < TINY
        inv = 1.0 / torch.where(flat, torch.ones_like(dc), dc)
        t1 = (lo[None, :, k] - oc) * inv
        t2 = (hi[None, :, k] - oc) * inv
        tn = torch.where(flat, tn, torch.maximum(tn, torch.minimum(t1, t2)))
        tf = torch.where(flat, tf, torch.minimum(tf, torch.maximum(t1, t2)))
        inside = inside & (~flat | ((oc >= lo[None, :, k]) & (oc <= hi[None, :, k])))
    return inside & (tn <= tf)


def sample_rays(live: torch.Tensor, seed: int, count: int = SAMPLE_RAYS) -> torch.Tensor:
    """Indices of up to `count` live rays, drawn from the seed."""
    idx = torch.nonzero(live).flatten()
    if idx.numel() <= count:
        return idx
    gen = torch.Generator(device="cpu").manual_seed(int(seed) & 0x7FFFFFFFFFFFFFFF)
    pick = torch.randperm(idx.numel(), generator=gen)[:count].to(idx.device)
    return idx[pick]


def _needed(o, d, tmin, tfar, lo, hi, keep):
    """Per sampled ray: a [R, B] bool of the boxes its interval meets (keep-masked), in chunks."""
    for r0 in range(0, o.shape[0], CHUNK):
        rs = slice(r0, r0 + CHUNK)
        yield box_overlaps(o[rs], d[rs], tmin[rs], tfar[rs], lo, hi) & keep[None, :]


def triangle_bound_s(calls, seed: int) -> float:
    """Seconds the card needs at its bandwidth for the K5 calls of one
    launch: calls are (o [N,3], d [N,3], tmin, tmax, t_hit, v0, e1, e2,
    mask, ray_mask) with t_hit the call's closest t (1e16 on a miss)."""
    total = 0.0
    for i, (o, d, tmin, tmax, t_hit, v0, e1, e2, mask, ray_mask) in enumerate(calls):
        n = tmin.shape[0]
        p1, p2 = v0 + e1, v0 + e2
        lo = torch.minimum(torch.minimum(v0, p1), p2)
        hi = torch.maximum(torch.maximum(v0, p1), p2)
        keep = (mask & ray_mask) != 0
        tfar = torch.minimum(t_hit, tmax)
        pick = sample_rays(tmax > tmin, seed + i)
        union = torch.zeros(v0.shape[0], dtype=torch.bool, device=v0.device)
        for need in _needed(o[pick], d[pick], tmin[pick], tfar[pick], lo, hi, keep):
            union |= need.any(dim=0)
        total += (n * (RAY_IN_BYTES + HIT_BYTES) + int(union.sum()) * TRI_BYTES) / PEAK_BYTES_PER_S
    return total


def cone_bound_s(calls, seed: int) -> float:
    """Seconds the card needs for the K7 calls of one launch: calls are
    (o [N,3], d [N,3], tmin, tmax, t_hit, geom [M,8] = a.xyz, ra, b.xyz, rb)."""
    total = 0.0
    for i, (o, d, tmin, tmax, t_hit, geom) in enumerate(calls):
        n = tmin.shape[0]
        a, ra, b, rb = geom[:, 0:3], geom[:, 3], geom[:, 4:7], geom[:, 7]
        r = torch.maximum(ra, rb)[:, None]
        lo = torch.minimum(a, b) - r
        hi = torch.maximum(a, b) + r
        keep = ra >= 0.0
        live = tmax > tmin
        pick = sample_rays(live, seed + i)
        tfar = torch.minimum(t_hit, tmax)
        tests = 0
        for need in _needed(o[pick], d[pick], tmin[pick], tfar[pick], lo, hi, keep):
            tests += int(need.sum())
        scaled = tests * int(live.sum()) / max(int(pick.numel()), 1)
        ops_s = scaled * CONE_FLOPS / PEAK_F32_PER_S
        bytes_s = n * (CONE_RAY_IN_BYTES + CONE_HIT_BYTES) / PEAK_BYTES_PER_S
        total += max(ops_s, bytes_s)
    return total


def group_boxes(v0, e1, e2, keep):
    """The boxes of each GROUP consecutive triangles over the kept ones
    ([G, 3] lo, hi; inverted where a group keeps none: the reference's
    tri_group_bounds) and the triangles each keeps ([G] i64)."""
    b = torch.from_numpy(tri_group_bounds(*(x.cpu().numpy() for x in (v0, e1, e2, keep)))).to(v0.device)
    g = b.shape[1]
    kept = torch.cat([keep, keep.new_zeros(g * GROUP - keep.shape[0])]).reshape(g, GROUP).sum(dim=1)
    return b[0:3].T, b[3:6].T, kept


def flat_bound_s(calls, seed: int) -> float:
    """Seconds the card needs for the K2 calls of one launch: calls are as
    triangle_bound_s's. The group boxes a sampled live ray's final interval
    meets and their mask-matching triangles, scaled to all live rays, at
    the card's f32 rate; or the rays' bytes where more."""
    total = 0.0
    for i, (o, d, tmin, tmax, t_hit, v0, e1, e2, mask, ray_mask) in enumerate(calls):
        n = tmin.shape[0]
        lo, hi, kept = group_boxes(v0, e1, e2, (mask & ray_mask) != 0)
        live = tmax > tmin
        pick = sample_rays(live, seed + i)
        tfar = torch.minimum(t_hit, tmax)
        ops = 0
        for need in _needed(o[pick], d[pick], tmin[pick], tfar[pick], lo, hi, kept > 0):
            ops += int(need.sum()) * GROUP_BOX_FLOPS + int((need.to(torch.int64) * kept).sum()) * MT_FLOPS
        scaled = ops * int(live.sum()) / max(int(pick.numel()), 1)
        bytes_s = n * (RAY_IN_BYTES + HIT_BYTES) / PEAK_BYTES_PER_S
        total += max(scaled / PEAK_F32_PER_S, bytes_s)
    return total
