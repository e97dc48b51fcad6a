"""Kernels K7 (closest hit) and K8 (any hit) over round cones (hair).

K7 `cone_closest` and K8 `cone_any` replace the three cone kernels of
strelka_tpu/ops/curves.py (pallas_intersect_cones, _fusedk, _wl: one
function, three TPU schedules); the CUDA source is csrc/cones.cu. Their
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
K9 (kernels/open_w.py:sweep_order), makes a culled sweep go through each ray
tile's superblocks nearest first in place of ascending; the result is the
same, and the plain version and `cull=False` ignore it. `stats=True` also
returns an int32 [2, N] tensor of sub-blocks swept and cones tested per ray.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import build
from strelka_tpu_torch.kernels.open_w import SweepOrder
from strelka_tpu_torch.ops import curves as C


class PackedCones(NamedTuple):
    geom: torch.Tensor  # [M_pad, 8] f32: (a.xyz, ra, b.xyz, rb)
    bounds: torch.Tensor  # [8, nb] f32
    sbounds: torch.Tensor  # [8, nb / super] f32

    @property
    def shape(self) -> tuple:
        """(cones, sub-blocks, superblocks): what defines a launch beside the rays."""
        return (self.geom.shape[0], self.bounds.shape[1], self.sbounds.shape[1])


def closest_plain(o, d, tmin, tmax, cones: PackedCones, block: int = C.CONE_TBLK):
    """Plain K7 -> (t, cone, y), each [N]."""
    return C.intersect_curves_closest_plain(cones.geom, o, d, tmin, tmax, block)


def any_plain(o, d, tmin, tmax, cones: PackedCones, block: int = C.CONE_TBLK):
    """Plain K8 -> occluded [N] bool."""
    return C.intersect_curves_any_plain(cones.geom, o, d, tmin, tmax, block)


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
    if order is not None:
        n_tiles = -(-n // order.tile)
        for a, shape in ((order.order, (n_tiles, nsb)), (order.count, (n_tiles,))):
            if a.dtype != torch.int32 or a.shape != shape or not a.is_contiguous() or a.device != dev:
                raise ValueError(f"{name}: the sweep order must be contiguous i32 [{n_tiles}, {nsb}] with counts "
                                 f"[{n_tiles}] on {dev}")


def _launch(entry: str, o, d, tmin, tmax, cones: PackedCones, cull: bool, order: Optional[SweepOrder], outs, stats):
    m, nb, nsb = cones.shape
    n = tmin.shape[0]
    order_args = (None, None, 0) if order is None else (order.order.data_ptr(), order.count.data_ptr(), order.tile)
    rc = getattr(build.load(), entry)(
        *(a.data_ptr() for a in (*o, *d, tmin, tmax)), cones.geom.data_ptr(), cones.bounds.data_ptr(),
        cones.sbounds.data_ptr(), m, nb, nb // nsb, int(bool(cull)), *order_args, n,
        *(a.data_ptr() for a in outs), stats.data_ptr() if stats is not None else None,
        build.stream_ptr(tmin.device),
    )
    build.check(rc, entry)


def launch_shape(n: int, cones: PackedCones, order: Optional[SweepOrder]) -> tuple:
    """A launch's shape: rays, cones, sub-blocks, superblocks, rays a tile of the sweep order (0: ascending)."""
    return (n, *cones.shape, 0 if order is None else order.tile)


def cone_closest(o, d, tmin, tmax, cones: PackedCones, cull: bool = True, stats: bool = False,
                 order: Optional[SweepOrder] = None):
    """K7 -> (t, cone, y): t = 1e16, cone = -1, y = 0 on a miss."""
    if tmin.device.type == "cpu":
        if stats:
            raise ValueError("cone_closest: stats come from the kernel; the plain version counts nothing")
        return closest_plain(o, d, tmin, tmax, cones)
    order = order if cull else None
    _check(o, d, tmin, tmax, cones, order, "cone_closest")
    n = tmin.shape[0]
    dev = tmin.device
    t = torch.empty(n, dtype=torch.float32, device=dev)
    cone = torch.empty(n, dtype=torch.int32, device=dev)
    y = torch.empty(n, dtype=torch.float32, device=dev)
    st = torch.empty((2, n), dtype=torch.int32, device=dev) if stats else None
    if n:
        _launch("strelka_cone_closest", o, d, tmin, tmax, cones, cull, order, (t, cone, y), st)
        K.count_launch("cone_closest", launch_shape(n, cones, order))
    return (t, cone, y, st) if stats else (t, cone, y)


def cone_any(o, d, tmin, tmax, cones: PackedCones, cull: bool = True, stats: bool = False,
             order: Optional[SweepOrder] = None):
    """K8 -> occluded [N] bool."""
    if tmin.device.type == "cpu":
        if stats:
            raise ValueError("cone_any: stats come from the kernel; the plain version counts nothing")
        return any_plain(o, d, tmin, tmax, cones)
    order = order if cull else None
    _check(o, d, tmin, tmax, cones, order, "cone_any")
    n = tmin.shape[0]
    occ = torch.empty(n, dtype=torch.bool, device=tmin.device)
    st = torch.empty((2, n), dtype=torch.int32, device=tmin.device) if stats else None
    if n:
        _launch("strelka_cone_any", o, d, tmin, tmax, cones, cull, order, (occ,), st)
        K.count_launch("cone_any", launch_shape(n, cones, order))
    return (occ, st) if stats else occ
