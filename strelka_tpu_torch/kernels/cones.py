"""Kernels K7 (closest hit) and K8 (any hit) over round cones (hair).

K7 `cone_closest` and K8 `cone_any` replace the three cone kernels of
strelka_tpu/ops/curves.py (pallas_intersect_cones, _fusedk, _wl: one
function, three TPU schedules); the CUDA source is csrc/cones.cu, which
also gives their schedule (persistent warps, one ray a warp, each ray's
walk of the cone tree nearest first). Their plain version is the dense
sweep `ops/curves.py:intersect_curves_closest_plain`, the CPU reference's
`intersect_curves_closest` in PyTorch; the kernels do the same f32
arithmetic per (ray, cone) and keep the lowest index of equal t, so they
are held to equality.

Rays: o and d are (x, y, z) triples of [N] f32 tensors, tmin/tmax [N] f32
(tmax <= tmin: a dead lane). Cones: a `PackedCones`, the device's one cone
table [M_pad, 8] = (a.xyz, ra, b.xyz, rb) (ops/curves.py:cone_major_rows of
the rows of pack_cones), which the kernels and the plain version both read,
with the boxes of the tree over it [8, total] (ops/curves.py:cone_tree).
`cull=False` sweeps every cone (the brute force the tree walk is compared
with). `stats=True` also returns a `ConeStats`: per ray the inner boxes
slab-tested, the leaves swept and the cones whose own box the ray's
interval entered, which the closed form tested (the plain count of the same
walk is ops/curves.py:cone_tree_walk), and for the launch the lane slots of
the closed form's steps (32 a leaf that ran it) and those that tested a
cone.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import build
from strelka_tpu_torch.ops import curves as C

LANES = 32
COUNTER_MAX = 2 ** 31 - 1  # the kernels' ray counter is an int32


class PackedCones(NamedTuple):
    geom: torch.Tensor  # [M_pad, 8] f32: (a.xyz, ra, b.xyz, rb)
    tree: torch.Tensor  # [8, total] f32: the cone tree's boxes (ops/curves.py:cone_tree)

    @property
    def shape(self) -> tuple:
        """(cones, tree boxes): what defines a launch beside the rays."""
        return (self.geom.shape[0], self.tree.shape[1])

    @property
    def levels(self) -> tuple:
        """The tree's levels, top first: ((first box, boxes), ...)."""
        return C.cone_tree_levels(self.geom.shape[0])


class ConeStats(NamedTuple):
    per_ray: torch.Tensor  # [3, N] i32: inner boxes slab-tested, leaves swept, cones whose own box was entered
    slots: torch.Tensor  # [2] i64: lane slots of the closed form's steps, lane slots that tested a cone


def closest_plain(o, d, tmin, tmax, cones: PackedCones, block: int = C.CONE_TBLK):
    """Plain K7 -> (t, cone, y), each [N]."""
    return C.intersect_curves_closest_plain(cones.geom, o, d, tmin, tmax, block)


def any_plain(o, d, tmin, tmax, cones: PackedCones, block: int = C.CONE_TBLK):
    """Plain K8 -> occluded [N] bool."""
    return C.intersect_curves_any_plain(cones.geom, o, d, tmin, tmax, block)


def grid(n: int, blocks_per_sm: int, threads: int, sms: int) -> int:
    """Blocks of a persistent launch: as many as fit on the card at once (the
    occupancy of the built kernel x the SMs), fewer where the rays are fewer.
    A warp takes at most one index past the end of the rays, so the kernels'
    int32 ray counter holds n + blocks x threads."""
    if blocks_per_sm < 1:
        raise ValueError("the cone kernel does not fit on an SM")
    blocks = max(1, min(blocks_per_sm * sms, -(-n * LANES // threads)))  # a warp a ray
    if n + blocks * threads > COUNTER_MAX:
        raise ValueError(f"{n} rays: the kernels' int32 ray counter could overflow")
    return blocks


def _check(o, d, tmin, tmax, cones: PackedCones, name: str) -> None:
    K.require_cuda(tmin, name)
    n = tmin.shape[0]
    dev = tmin.device
    for a in (*o, *d, tmin, tmax):
        if a.dtype != torch.float32 or a.shape != (n,) or not a.is_contiguous() or a.device != dev:
            raise ValueError(f"{name}: ray components must be contiguous [N] f32 on {dev}")
    geom, tree = cones
    for a, dim in ((geom, 1), (tree, 0)):
        if (a.dtype != torch.float32 or a.dim() != 2 or a.shape[dim] != 8 or not a.is_contiguous()
                or a.device != dev):
            raise ValueError(f"{name}: cone geometry [M, 8] and tree boxes [8, total] must be contiguous f32 on {dev}")
    if geom.data_ptr() % 16:
        raise ValueError(f"{name}: the cone geometry must be 16-byte aligned")
    m, total = cones.shape
    if m >= 2 ** 31 or m % C.CONE_LEAF:
        raise ValueError(f"{name}: {m} cones do not divide into leaves of {C.CONE_LEAF}")
    levels = cones.levels
    if len(levels) > C.CONE_MAX_LEVELS or sum(c for _, c in levels) != total:
        raise ValueError(f"{name}: a tree of {total} boxes in {len(levels)} levels is not the cone tree of {m} "
                         f"cones (at most {C.CONE_MAX_LEVELS} levels)")


_occupancy: dict = {}  # (any hit, device) -> (blocks per SM, threads a block)


def occupancy(any_hit: bool, device) -> tuple:
    """(blocks per SM, threads a block) of K8 (any_hit) or K7, from the CUDA
    occupancy calculator on the built kernel (asked once per kernel)."""
    key = (bool(any_hit), torch.device(device))
    if key not in _occupancy:
        blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(key[-1]):
            rc = build.load().strelka_cone_occupancy(int(key[0]), ctypes.byref(blocks), ctypes.byref(threads))
        build.check(rc, "strelka_cone_occupancy")
        _occupancy[key] = (blocks.value, threads.value)
    return _occupancy[key]


def _launch(entry: str, o, d, tmin, tmax, cones: PackedCones, cull: bool, outs, stats) -> None:
    n = tmin.shape[0]
    dev = tmin.device
    blocks_per_sm, threads = occupancy(entry == "strelka_cone_any", dev)
    blocks = grid(n, blocks_per_sm, threads, torch.cuda.get_device_properties(dev).multi_processor_count)
    next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
    levels = cones.levels
    first = (ctypes.c_int * (len(levels) + 1))(*[f for f, _ in levels], cones.tree.shape[1])
    rc = getattr(build.load(), entry)(
        *(a.data_ptr() for a in (*o, *d, tmin, tmax)), cones.geom.data_ptr(), cones.tree.data_ptr(), first,
        len(levels), cones.geom.shape[0], int(bool(cull)), n, blocks, next_ray.data_ptr(),
        *(a.data_ptr() for a in outs),
        *((stats.per_ray.data_ptr(), stats.slots.data_ptr()) if stats is not None else (None, None)),
        build.stream_ptr(dev),
    )
    build.check(rc, entry)


def _new_stats(n: int, dev) -> ConeStats:
    return ConeStats(torch.empty((3, n), dtype=torch.int32, device=dev), torch.zeros(2, dtype=torch.int64, device=dev))


def launch_shape(n: int, cones: PackedCones) -> tuple:
    """A launch's shape: rays, cones, tree boxes."""
    return (n, *cones.shape)


def cone_closest(o, d, tmin, tmax, cones: PackedCones, cull: bool = True, stats: bool = False):
    """K7 -> (t, cone, y): t = 1e16, cone = -1, y = 0 on a miss; with
    stats=True (t, cone, y, ConeStats)."""
    if tmin.device.type == "cpu":
        if stats:
            raise ValueError("cone_closest: stats come from the kernel; the plain version counts nothing")
        return closest_plain(o, d, tmin, tmax, cones)
    _check(o, d, tmin, tmax, cones, "cone_closest")
    n = tmin.shape[0]
    dev = tmin.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    cone = torch.empty(n, dtype=torch.int32, device=dev)
    y = torch.empty(n, dtype=torch.float32, device=dev)
    st = _new_stats(n, dev) if stats else None
    if n:
        _launch("strelka_cone_closest", o, d, tmin, tmax, cones, cull, (t, cone, y), st)
        K.count_launch("cone_closest", launch_shape(n, cones))
    return (t, cone, y, st) if stats else (t, cone, y)


def cone_any(o, d, tmin, tmax, cones: PackedCones, cull: bool = True, stats: bool = False):
    """K8 -> occluded [N] bool; with stats=True (occluded, ConeStats)."""
    if tmin.device.type == "cpu":
        if stats:
            raise ValueError("cone_any: stats come from the kernel; the plain version counts nothing")
        return any_plain(o, d, tmin, tmax, cones)
    _check(o, d, tmin, tmax, cones, "cone_any")
    n = tmin.shape[0]
    dev = tmin.device
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    st = _new_stats(n, dev) if stats else None
    if n:
        _launch("strelka_cone_any", o, d, tmin, tmax, cones, cull, (occ,), st)
        K.count_launch("cone_any", launch_shape(n, cones))
    return (occ, st) if stats else occ
