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

import ctypes
from typing import NamedTuple, Optional

import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import build
from strelka_tpu_torch.kernels.open_w import SweepOrder
from strelka_tpu_torch.ops import curves as C

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


def grid(n: int, blocks_per_sm: int, threads: int, sms: int) -> int:
    """Blocks of a persistent launch: as many as fit on the card at once (the
    occupancy of the built kernel x the SMs), fewer where the rays are fewer.
    A warp takes at most one index past the end of the rays, so the kernels'
    int32 ray counter holds n + blocks x threads."""
    if blocks_per_sm < 1:
        raise ValueError("the cone kernel does not fit on an SM at this shared-memory size")
    blocks = max(1, min(blocks_per_sm * sms, -(-n * LANES // threads)))  # a warp a ray
    if n + blocks * threads > COUNTER_MAX:
        raise ValueError(f"{n} rays: the kernels' int32 ray counter could overflow")
    return blocks


def check_near_to_far(cones: PackedCones, list_cap: int, threads: int) -> None:
    """K7's near-to-far walk keeps 8 sub-blocks' tnears on 8 lanes and a list
    of list_cap (tnear, superblock) entries a warp in shared memory."""
    _, nb, nsb = cones.shape
    if nb // nsb != SUPER_NEAR_TO_FAR:
        raise ValueError(f"near_to_far: {nb // nsb} sub-blocks a superblock; the walk takes {SUPER_NEAR_TO_FAR}")
    if list_cap < 1 or list_cap * (threads // LANES) * 8 > SMEM_PER_BLOCK:
        raise ValueError(f"near_to_far: a list of {list_cap} entries a ray does not fit in a block's shared memory")


def _check(o, d, tmin, tmax, cones: PackedCones, order: Optional[SweepOrder], name: str) -> None:
    K.require_cuda(tmin, name)
    n = tmin.shape[0]
    dev = tmin.device
    for a in (*o, *d, tmin, tmax):
        if a.dtype != torch.float32 or a.shape != (n,) or not a.is_contiguous() or a.device != dev:
            raise ValueError(f"{name}: ray components must be contiguous [N] f32 on {dev}")
    geom, bounds, sbounds = cones
    for a, dim, size in ((geom, 1, 8), (bounds, 0, 8), (sbounds, 0, 8)):
        if (a.dtype != torch.float32 or a.dim() != 2 or a.shape[dim] != size or not a.is_contiguous()
                or a.device != dev):
            raise ValueError(f"{name}: cone geometry [M, 8], boxes [8, nb] and superblock boxes [8, nsb] must be "
                             f"contiguous f32 on {dev}")
    if geom.data_ptr() % 16:
        raise ValueError(f"{name}: the cone geometry must be 16-byte aligned")
    m, nb, nsb = cones.shape
    if nb < 1 or nsb < 1 or m % nb or nb % nsb or m >= 2 ** 31:
        raise ValueError(f"{name}: {m} cones do not divide into {nb} sub-blocks and {nsb} superblocks")
    if (m // nb) % STEP or nb // nsb > LANES:
        raise ValueError(f"{name}: sub-blocks of {m // nb} cones and superblocks of {nb // nsb} sub-blocks; the "
                         f"kernels take whole steps of {STEP} cones and at most {LANES} sub-blocks a superblock")
    if order is not None:
        n_tiles = -(-n // order.tile)
        for a, shape, dtype in ((order.order, (n_tiles, nsb), torch.int32), (order.count, (n_tiles,), torch.int32),
                                (order.tnear, (n_tiles, nsb), torch.float32)):
            if a.dtype != dtype or a.shape != shape or not a.is_contiguous() or a.device != dev:
                raise ValueError(f"{name}: the sweep order must be contiguous i32 [{n_tiles}, {nsb}] with counts "
                                 f"i32 [{n_tiles}] and tnears f32 [{n_tiles}, {nsb}] on {dev}")


_occupancy: dict = {}  # (any hit, cull, near to far, list cap, device) -> (blocks per SM, threads a block)


def occupancy(any_hit: bool, cull: bool, near_to_far: bool, device) -> tuple:
    """(blocks per SM, threads a block) of the kernel a launch takes, from the
    CUDA occupancy calculator on the built kernel (asked once per kernel)."""
    key = (bool(any_hit), bool(cull), bool(near_to_far), C.CONE_LIST, torch.device(device))
    if key not in _occupancy:
        blocks, threads = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(key[-1]):
            rc = build.load().strelka_cone_occupancy(int(key[0]), int(key[1]), int(key[2]), C.CONE_LIST,
                                                     ctypes.byref(blocks), ctypes.byref(threads))
        build.check(rc, "strelka_cone_occupancy")
        _occupancy[key] = (blocks.value, threads.value)
    return _occupancy[key]


def _launch(entry: str, o, d, tmin, tmax, cones: PackedCones, cull: bool, near_to_far: bool,
            order: Optional[SweepOrder], outs, stats: Optional[ConeStats]) -> None:
    m, nb, nsb = cones.shape
    n = tmin.shape[0]
    dev = tmin.device
    any_hit = entry == "strelka_cone_any"
    blocks_per_sm, threads = occupancy(any_hit, cull, near_to_far, dev)
    if near_to_far:
        check_near_to_far(cones, C.CONE_LIST, threads)
    blocks = grid(n, blocks_per_sm, threads, torch.cuda.get_device_properties(dev).multi_processor_count)
    next_ray = torch.zeros(1, dtype=torch.int32, device=dev)
    order_args = (None, None, 0) if order is None else (order.order.data_ptr(), order.count.data_ptr(), order.tile)
    tnear = () if any_hit else (None if order is None else order.tnear.data_ptr(),)
    walk = () if any_hit else (int(near_to_far),)
    cap = () if any_hit else (C.CONE_LIST,)
    rc = getattr(build.load(), entry)(
        *(a.data_ptr() for a in (*o, *d, tmin, tmax)), cones.geom.data_ptr(), cones.bounds.data_ptr(),
        cones.sbounds.data_ptr(), m, nb, nb // nsb, int(bool(cull)), *walk, *order_args, *tnear, *cap, n, blocks,
        next_ray.data_ptr(), *(a.data_ptr() for a in outs), *((stats.per_ray.data_ptr(), stats.slots.data_ptr())
                                                               if stats is not None else (None, None)),
        build.stream_ptr(dev),
    )
    build.check(rc, entry)


def _new_stats(n: int, dev) -> ConeStats:
    return ConeStats(torch.empty((2, n), dtype=torch.int32, device=dev), torch.zeros(2, dtype=torch.int64, device=dev))


def launch_shape(n: int, cones: PackedCones, order: Optional[SweepOrder]) -> tuple:
    """A launch's shape: rays, cones, sub-blocks, superblocks, rays a tile of the sweep order (0: ascending)."""
    return (n, *cones.shape, 0 if order is None else order.tile)


def cone_closest(o, d, tmin, tmax, cones: PackedCones, cull: bool = True, stats: bool = False,
                 order: Optional[SweepOrder] = None, near_to_far: bool = True):
    """K7 -> (t, cone, y): t = 1e16, cone = -1, y = 0 on a miss; with
    stats=True (t, cone, y, ConeStats). near_to_far=False walks the boxes as
    K8 does (ascending, or in `order`'s list): the same result."""
    if tmin.device.type == "cpu":
        if stats:
            raise ValueError("cone_closest: stats come from the kernel; the plain version counts nothing")
        return closest_plain(o, d, tmin, tmax, cones)
    order = order if cull else None
    near_to_far = near_to_far and cull
    _check(o, d, tmin, tmax, cones, order, "cone_closest")
    n = tmin.shape[0]
    dev = tmin.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    cone = torch.empty(n, dtype=torch.int32, device=dev)
    y = torch.empty(n, dtype=torch.float32, device=dev)
    st = _new_stats(n, dev) if stats else None
    if n:
        _launch("strelka_cone_closest", o, d, tmin, tmax, cones, cull, near_to_far, order, (t, cone, y), st)
        K.count_launch("cone_closest", launch_shape(n, cones, order))
    return (t, cone, y, st) if stats else (t, cone, y)


def cone_any(o, d, tmin, tmax, cones: PackedCones, cull: bool = True, stats: bool = False,
             order: Optional[SweepOrder] = None):
    """K8 -> occluded [N] bool; with stats=True (occluded, ConeStats)."""
    if tmin.device.type == "cpu":
        if stats:
            raise ValueError("cone_any: stats come from the kernel; the plain version counts nothing")
        return any_plain(o, d, tmin, tmax, cones)
    order = order if cull else None
    _check(o, d, tmin, tmax, cones, order, "cone_any")
    n = tmin.shape[0]
    dev = tmin.device
    occ = torch.empty(n, dtype=torch.bool, device=dev)
    st = _new_stats(n, dev) if stats else None
    if n:
        _launch("strelka_cone_any", o, d, tmin, tmax, cones, cull, False, order, (occ,), st)
        K.count_launch("cone_any", launch_shape(n, cones, order))
    return (occ, st) if stats else occ
