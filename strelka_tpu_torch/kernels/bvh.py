"""Kernels K5 (closest hit) and K6 (any hit) over a BVH.

K5 `bvh_closest` and K6 `bvh_any` replace the large-scene intersection
kernels of strelka_tpu/ops/pallas_intersect.py (the superblock sweeps, the
fused-K phase 1, pallas_open_w and the work-list kernels: one function,
many TPU schedules); the CUDA source is csrc/bvh.cu.

K5 walks each ray's tree near to far over the child table
(`DeviceBvh.children`, ops/bvh.py:child_rows) with the port's box test and
a per-thread stack of ops/bvh.py:STACK entries; its plain version is
`ops/bvh.py:intersect_bvh_ordered_plain` (the same order, test and
counters), and its result is the dense sweep's (t, prim) on every lane.
K6 runs the reference's stackless DFS walk over the packed rows with the
port's box test (ops/slab.py:slab_tnear); its plain version is
`ops/bvh.py:intersect_bvh_plain(margin=True)`, the CPU reference's
`intersect_bvh` in PyTorch with that test (its default keeps the
reference's exact one). Both are held to equality with their plain
versions.

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
from strelka_tpu_torch.ops.bvh import (CHILD_COLS, STACK, DeviceBvh, intersect_bvh_ordered_plain,
                                       intersect_bvh_plain)


def closest_plain(o, d, tmin, tmax, exclude, bvh: DeviceBvh, v0, e1, e2, mask, ray_mask: int, counts: bool = False):
    """Plain K5 -> (t, prim, u, v), each [N]; with counts=True also the
    per-ray OrderedCounts (child boxes and triangles tested)."""
    return intersect_bvh_ordered_plain(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, ray_mask, counts=counts,
                                       name="bvh_closest")


def any_plain(o, d, tmin, tmax, exclude, bvh: DeviceBvh, v0, e1, e2, mask, ray_mask: int):
    """Plain K6 -> occluded [N] bool."""
    prim = intersect_bvh_plain(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, ray_mask, any_hit=True,
                               margin=True, name="bvh_any")[1]
    return prim >= 0


def check_stack(bvh: DeviceBvh, name: str = "bvh_closest") -> None:
    """Raise on a tree deeper than K5's stack: its walk would overflow."""
    if bvh.depth > STACK:
        raise ValueError(f"{name}: the tree is {bvh.depth} internal nodes deep; the walk's stack holds {STACK}")


def _check_bvh(bvh: DeviceBvh, v0, dev, name):
    nodes = bvh.nodes
    if (nodes.dtype != torch.int32 or nodes.dim() != 2 or nodes.shape[1] != 8 or nodes.shape[0] < 1
            or not nodes.is_contiguous() or nodes.device != dev or nodes.data_ptr() % 16):
        raise ValueError(f"{name}: bvh.nodes must be a contiguous, 16-byte aligned [n, 8] int32 tensor on {dev}")
    if v0.shape[0] < 1:
        raise ValueError(f"{name}: no triangles")


def _check_children(bvh: DeviceBvh, v0, dev) -> None:
    rows = bvh.children
    if (rows is None or rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != CHILD_COLS
            or rows.shape[0] < 1 or not rows.is_contiguous() or rows.device != dev or rows.data_ptr() % 16):
        raise ValueError(f"bvh_closest: bvh.children must be a contiguous, 16-byte aligned [m, {CHILD_COLS}] int32 "
                         f"tensor on {dev} (ops/bvh.py:child_rows)")
    if v0.shape[0] < 1:
        raise ValueError("bvh_closest: no triangles")
    check_stack(bvh)


def bvh_closest(o, d, tmin, tmax, exclude, bvh: DeviceBvh, v0, e1, e2, mask, ray_mask: int, stats: bool = False):
    """K5 -> (t, prim, u, v): t = 1e16, prim = -1, u = v = 0 on a miss; with
    stats=True also the child boxes and the triangles each ray tested, [N]
    i32 each. CPU tensors take the plain version (without stats)."""
    if tmin.device.type == "cpu":
        if stats:
            raise ValueError("bvh_closest: stats come from the kernel; closest_plain(counts=True) counts the same")
        return closest_plain(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, ray_mask)
    check_rays_tris(o, d, tmin, tmax, exclude, v0, e1, e2, mask, "bvh_closest")
    dev = tmin.device
    _check_children(bvh, v0, dev)
    n = tmin.shape[0]
    out = torch.empty((6 if stats else 4, n), dtype=torch.float32, device=dev)  # t, prim, u, v, nodes, tris
    t, prim, u, v = out[0], out[1].view(torch.int32), out[2], out[3]
    counts = (out[4].view(torch.int32), out[5].view(torch.int32)) if stats else ()
    if n:
        ptrs = ray_tri_ptrs(o, d, tmin, tmax, exclude, v0, e1, e2, mask)  # 9 of the rays, 4 of the triangles
        rc = build.load().strelka_bvh_closest(
            *ptrs[:9], bvh.children.data_ptr(), bvh.children.shape[0], bvh.depth, *ptrs[9:], int(ray_mask), n,
            v0.shape[0], t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
            *((c.data_ptr() for c in counts) if stats else (None, None)), build.stream_ptr(dev),
        )
        build.check(rc, "bvh_closest")
        K.count_launch("bvh_closest", (n, bvh.num_nodes, v0.shape[0]))  # rays, nodes, triangles
    return (t, prim, u, v, *counts)


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

