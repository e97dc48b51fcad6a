"""Kernels K5 (closest hit) and K6 (any hit) over a threaded BVH.

K5 `bvh_closest` and K6 `bvh_any` replace the large-scene intersection
kernels of strelka_tpu/ops/pallas_intersect.py (the superblock sweeps, the
fused-K phase 1, pallas_open_w and the work-list kernels: one function,
many TPU schedules); the CUDA source is csrc/bvh.cu. Their plain version is
the lockstep traversal `ops/bvh.py:intersect_bvh_plain`, the CPU
reference's `intersect_bvh` in PyTorch; the kernels walk the same nodes in
the same order with the same f32 arithmetic, so they are held to equality.

Rays as for K2/K3: o and d are (x, y, z) triples of [N] f32 tensors,
tmin/tmax [N] f32 (tmax <= tmin: a dead lane), exclude [N] int32 or None.
Triangles (v0, e1, e2 [T, 3] f32, mask [T] int32) are in the BVH's leaf
order, and so are the prim ids going in (exclude) and coming out.
"""

from __future__ import annotations

import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import build
from strelka_tpu_torch.kernels.intersect import check_rays_tris, ray_tri_ptrs
from strelka_tpu_torch.ops.bvh import DeviceBvh, intersect_bvh_plain


def closest_plain(o, d, tmin, tmax, exclude, bvh: DeviceBvh, v0, e1, e2, mask, ray_mask: int):
    """Plain K5 -> (t, prim, u, v), each [N]."""
    return intersect_bvh_plain(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, ray_mask, name="bvh_closest")


def any_plain(o, d, tmin, tmax, exclude, bvh: DeviceBvh, v0, e1, e2, mask, ray_mask: int):
    """Plain K6 -> occluded [N] bool."""
    prim = intersect_bvh_plain(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, ray_mask, any_hit=True,
                               name="bvh_any")[1]
    return prim >= 0


def _check_bvh(bvh: DeviceBvh, v0, dev, name):
    nodes = bvh.nodes
    if (nodes.dtype != torch.int32 or nodes.dim() != 2 or nodes.shape[1] != 8 or nodes.shape[0] < 1
            or not nodes.is_contiguous() or nodes.device != dev or nodes.data_ptr() % 16):
        raise ValueError(f"{name}: bvh.nodes must be a contiguous, 16-byte aligned [n, 8] int32 tensor on {dev}")
    if v0.shape[0] < 1:
        raise ValueError(f"{name}: no triangles")


def bvh_closest(o, d, tmin, tmax, exclude, bvh: DeviceBvh, v0, e1, e2, mask, ray_mask: int):
    """K5 -> (t, prim, u, v): t = 1e16, prim = -1, u = v = 0 on a miss."""
    if tmin.device.type == "cpu":
        return closest_plain(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, ray_mask)
    check_rays_tris(o, d, tmin, tmax, exclude, v0, e1, e2, mask, "bvh_closest")
    _check_bvh(bvh, v0, tmin.device, "bvh_closest")
    n = tmin.shape[0]
    dev = tmin.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n == 0:
        return t, prim, u, v
    ptrs = ray_tri_ptrs(o, d, tmin, tmax, exclude, v0, e1, e2, mask)  # 9 of the rays, 4 of the triangles
    rc = build.load().strelka_bvh_closest(
        *ptrs[:9], bvh.nodes.data_ptr(), bvh.num_nodes, *ptrs[9:], int(ray_mask), n, v0.shape[0],
        t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), build.stream_ptr(dev),
    )
    build.check(rc, "bvh_closest")
    K.count_launch("bvh_closest", (n, bvh.num_nodes, v0.shape[0]))  # rays, nodes, triangles
    return t, prim, u, v


def bvh_any(o, d, tmin, tmax, exclude, bvh: DeviceBvh, v0, e1, e2, mask, ray_mask: int):
    """K6 -> occluded [N] bool."""
    if tmin.device.type == "cpu":
        return any_plain(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, ray_mask)
    check_rays_tris(o, d, tmin, tmax, exclude, v0, e1, e2, mask, "bvh_any")
    _check_bvh(bvh, v0, tmin.device, "bvh_any")
    n = tmin.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=tmin.device)
    if n == 0:
        return occ
    ptrs = ray_tri_ptrs(o, d, tmin, tmax, exclude, v0, e1, e2, mask)  # 9 of the rays, 4 of the triangles
    rc = build.load().strelka_bvh_any(
        *ptrs[:9], bvh.nodes.data_ptr(), bvh.num_nodes, *ptrs[9:], int(ray_mask), n, v0.shape[0],
        occ.data_ptr(), build.stream_ptr(tmin.device),
    )
    build.check(rc, "bvh_any")
    K.count_launch("bvh_any", (n, bvh.num_nodes, v0.shape[0]))  # rays, nodes, triangles
    return occ

