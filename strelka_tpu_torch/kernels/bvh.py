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
K6 walks the same child table in the same order with the same stack and
stops at the first hit Möller–Trumbore accepts, reading the triangles as
48-byte rows that its wrapper makes from the v0, e1, e2 and mask it is
given (`triangle_rows`, kept while those tensors are unchanged); its plain
version is `intersect_bvh_ordered_plain(any_hit=True)` on the same tensors. Both are held to equality
with their plain versions (result and per-ray counters). The reference's
own walk, the stackless DFS over the packed rows
(`ops/bvh.py:intersect_bvh_plain`, with margin=True on the port's box
test), stays the yardstick of K6's bound.

Rays as for K2/K3: o and d are (x, y, z) triples of [N] f32 tensors,
tmin/tmax [N] f32 (tmax <= tmin: a dead lane), exclude [N] int32 or None.
Triangles (v0, e1, e2 [T, 3] f32, mask [T] int32) are in the BVH's leaf
order, and so are the prim ids going in (exclude) and coming out.
"""

from __future__ import annotations

import collections

import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import build
from strelka_tpu_torch.kernels.intersect import check_rays_tris, ray_tri_ptrs
from strelka_tpu_torch.ops.bvh import CHILD_COLS, STACK, DeviceBvh, intersect_bvh_ordered_plain

# K6's triangle table: 12 f32 a row (48 bytes, three 16-byte loads): v0, e1, e2, the geometry mask's bits, 0, 0
TRI_ROW_COLS = 12
_ROWS_KEPT = 4  # triangle tables kept, the most recent first out last (one a scene in use)
_rows_kept: collections.OrderedDict = collections.OrderedDict()


def closest_plain(o, d, tmin, tmax, exclude, bvh: DeviceBvh, v0, e1, e2, mask, ray_mask: int, counts: bool = False):
    """Plain K5 -> (t, prim, u, v), each [N]; with counts=True also the
    per-ray OrderedCounts (child boxes and triangles tested)."""
    return intersect_bvh_ordered_plain(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, ray_mask, counts=counts,
                                       name="bvh_closest")


def any_plain(o, d, tmin, tmax, exclude, bvh: DeviceBvh, v0, e1, e2, mask, ray_mask: int, counts: bool = False):
    """Plain K6 -> occluded [N] bool; with counts=True also the per-ray
    OrderedCounts (child boxes tested, two a row fetched, and triangles
    tested up to the first hit)."""
    out = intersect_bvh_ordered_plain(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, ray_mask, counts=counts,
                                      name="bvh_any", any_hit=True)
    return (out[1] >= 0, out[4]) if counts else out[1] >= 0


def check_stack(bvh: DeviceBvh, name: str = "bvh_closest") -> None:
    """Raise on a tree deeper than the walks' stack (K5, K6): it would overflow."""
    if bvh.depth > STACK:
        raise ValueError(f"{name}: the tree is {bvh.depth} internal nodes deep; the walk's stack holds {STACK}")


def _check_children(bvh: DeviceBvh, v0, dev, name: str = "bvh_closest") -> None:
    rows = bvh.children
    if (rows is None or rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != CHILD_COLS
            or rows.shape[0] < 1 or not rows.is_contiguous() or rows.device != dev or rows.data_ptr() % 16):
        raise ValueError(f"{name}: bvh.children must be a contiguous, 16-byte aligned [m, {CHILD_COLS}] int32 "
                         f"tensor on {dev} (ops/bvh.py:child_rows)")
    if v0.shape[0] < 1:
        raise ValueError(f"{name}: no triangles")
    check_stack(bvh, name)


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


def tri_rows(v0, e1, e2, mask) -> torch.Tensor:
    """Triangles (v0, e1, e2 [T, 3] f32, geometry mask [T] i32) -> [T,
    TRI_ROW_COLS] f32 rows, K6's table: v0, e1, e2, the mask's bits (read
    back as an int32, never converted), 0, 0."""
    rows = torch.zeros((v0.shape[0], TRI_ROW_COLS), dtype=torch.float32, device=v0.device)
    rows[:, 0:3], rows[:, 3:6], rows[:, 6:9] = v0, e1, e2
    rows[:, 9] = mask.to(torch.int32).view(torch.float32)
    return rows


def triangle_rows(v0, e1, e2, mask) -> torch.Tensor:
    """`tri_rows` of these tensors, made once and kept while they are
    unchanged: the key is each tensor's device, address, shape, strides and
    version counter (an in-place write bumps it), and the entry holds the
    tensors, so no other tensor can take their memory while it is kept."""
    tris = (v0, e1, e2, mask)
    key = tuple((t.device, t.data_ptr(), t.shape, t.stride(), t._version) for t in tris)
    entry = _rows_kept.get(key)
    if entry is None:
        entry = _rows_kept[key] = (tri_rows(*tris), tris)
        while len(_rows_kept) > _ROWS_KEPT:
            _rows_kept.popitem(last=False)
    else:
        _rows_kept.move_to_end(key)
    return entry[0]


def bvh_any(o, d, tmin, tmax, exclude, bvh: DeviceBvh, v0, e1, e2, mask, ray_mask: int, stats: bool = False):
    """K6 -> occluded [N] bool; with stats=True also the child boxes and the
    triangles each ray tested, [N] i32 each. The kernel reads these v0, e1,
    e2 and mask as `triangle_rows`. CPU tensors take the plain version
    (without stats)."""
    if tmin.device.type == "cpu":
        if stats:
            raise ValueError("bvh_any: stats come from the kernel; any_plain(counts=True) counts the same")
        return any_plain(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, ray_mask)
    check_rays_tris(o, d, tmin, tmax, exclude, v0, e1, e2, mask, "bvh_any")
    dev = tmin.device
    _check_children(bvh, v0, dev, "bvh_any")
    n = tmin.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    counts = torch.empty((2, n), dtype=torch.int32, device=dev) if stats else None
    if n:
        ptrs = ray_tri_ptrs(o, d, tmin, tmax, exclude, v0, e1, e2, mask)[:9]  # the rays'
        rows = triangle_rows(v0, e1, e2, mask)
        rc = build.load().strelka_bvh_any(
            *ptrs, bvh.children.data_ptr(), bvh.children.shape[0], bvh.depth, rows.data_ptr(), int(ray_mask),
            n, v0.shape[0], occ.data_ptr(), *((counts[0].data_ptr(), counts[1].data_ptr()) if stats else (None, None)),
            build.stream_ptr(dev),
        )
        build.check(rc, "bvh_any")
        K.count_launch("bvh_any", (n, bvh.num_nodes, v0.shape[0]))  # rays, nodes, triangles
    return (occ, counts[0], counts[1]) if stats else occ
