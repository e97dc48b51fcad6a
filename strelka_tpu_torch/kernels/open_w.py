"""Kernel K9 `open_w`: the per-tile slab pass over the superblock boxes.

Replaces strelka_tpu/ops/pallas_intersect.py:pallas_open_w; the CUDA source
is csrc/open_w.cu. Rays go in tiles of `tile` consecutive lanes, each ray
with the interval [tmin, bound]. Against every superblock box a ray passes
when the port's box test (`ops/slab.py:slab_tnear`, the reference's slab
test with a margin, the cone sweeps' own) enters the padded box, its
lowered tnear < bound, tmin < bound and the box is not inverted. Returns

  open   [N] bool              the ray passes a box its tile has not swept
                               yet (d2[tile, sb] >= r2t[tile]); all false
                               when d2 and r2t are None
  W      [n_tiles, nsb] bool   some ray of the tile passes the box
  min_tn [n_tiles, nsb] f32    the least tnear over the tile's passing rays,
                               1e16 where none passes

min_tn holds the test's lowered tnears: a superblock that holds a ray's
hit is never left out of its tile's row. The cone sweeps
(kernels/cones.py) take their near-to-far superblock order from W and
min_tn: `sweep_order`, each tile's passed boxes by (min_tn, index) with
-0.0 taken as +0.0, then the others by index. One launch of the kernel
computes W, min_tn, open and that order; `open_w` and `sweep_order` are two
wrappers over it. The plain version takes pallas_open_w's exact test, bit
for bit, when asked (`exact=True`); the kernel has no such mode.

Rays: o and d are (x, y, z) triples of [N] f32 tensors, tmin/bound [N] f32.
sbounds [8, nsb] f32 (lo.xyz, hi.xyz, two unused rows); d2 [n_tiles, nsb]
and r2t [n_tiles] f32 with n_tiles = ceil(N / tile).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import build
from strelka_tpu_torch.ops import slab

BIG = 1e16
MAX_TILE = 1024
MAX_SMEM = 232448  # the H100's shared memory a block (csrc/open_w.cu:kMaxSmem)
# f32 operations of one (ray, box) pair: 6 differences, 6 products, 6 minima
# and maxima of the pairs, 6 folds into tnear and tfar, 2 comparisons (the
# box's own lo <= hi is not the pair's)
SLAB_FLOPS = 26


class SweepOrder(NamedTuple):
    """A sweep order per ray tile for kernels K7/K8."""

    order: torch.Tensor  # [n_tiles, nsb] i32 superblocks, the passed ones first, nearest first
    count: torch.Tensor  # [n_tiles] i32 how many of a row's entries some ray of the tile passes
    tile: int  # rays a tile
    tnear: torch.Tensor  # [n_tiles, nsb] f32 the least tnear of the tile's rays at each entry of `order`


def open_w_plain(o, d, tmin, bound, sbounds, d2=None, r2t=None, tile: int = MAX_TILE, chunk: int = 64,
                 exact: bool = False):
    """Plain K9: the broadcast slab test of a tile's rays against a chunk of
    boxes, reduced over the rays (W, min_tn) and over the boxes (open).
    exact=True takes pallas_open_w's test in place of the port's."""
    K.note_plain("open_w", tmin.device)
    n, nsb = tmin.shape[0], sbounds.shape[1]
    pad = -n % tile

    def tiles(c):
        c = torch.cat([c, c.new_zeros(pad)]) if pad else c
        return c.reshape(-1, tile, 1)

    oc, dc = [tiles(c) for c in o], [tiles(c) for c in d]
    tmin_t, bound_t = tiles(tmin), tiles(bound)
    inv = [1.0 / torch.where(torch.abs(c) > 1e-20, c, 1e-20) for c in dc]
    n_tiles = tmin_t.shape[0]
    open_ = torch.zeros((n_tiles, tile), dtype=torch.bool, device=tmin.device)
    w_cols, tn_cols = [], []
    for c0 in range(0, nsb, chunk):
        box = sbounds[:, c0:c0 + chunk]
        valid = (box[0] <= box[3]) & (box[1] <= box[4]) & (box[2] <= box[5])
        if not exact:
            tnear = slab.slab_tnear([c.reshape(-1) for c in oc], [c.reshape(-1) for c in dc], tmin_t.reshape(-1),
                                    bound_t.reshape(-1), box).reshape(n_tiles, tile, -1)
            passes = (tnear < float("inf")) & (tnear < bound_t) & (tmin_t < bound_t) & valid[None, None, :]
        else:
            tnear, tfar = tmin_t, bound_t
            for c in range(3):
                t0 = (box[c][None, None, :] - oc[c]) * inv[c]
                t1 = (box[3 + c][None, None, :] - oc[c]) * inv[c]
                tnear = torch.maximum(tnear, torch.minimum(t0, t1))
                tfar = torch.minimum(tfar, torch.maximum(t0, t1))
            passes = (tnear <= tfar) & (tnear < bound_t) & valid[None, None, :]
        w_cols.append(passes.any(dim=1))
        tn_cols.append(torch.where(passes, tnear, BIG).amin(dim=1))
        if d2 is not None:
            unswept = d2[:, c0:c0 + chunk] >= r2t[:, None]
            open_ |= (passes & unswept[:, None, :]).any(dim=2)
    return open_.reshape(-1)[:n], torch.cat(w_cols, dim=1), torch.cat(tn_cols, dim=1)


def smem_bytes(nsb: int, tile: int) -> int:
    """Shared memory a block of the kernel takes (csrc/open_w.cu:smem_bytes):
    the tile's rays, 40 bytes each, 16 bytes a box (min_tn, the passed
    list's key and index, the box's place) and a count a warp."""
    return 40 * tile + 16 * nsb + 4 * (MAX_TILE // 32)


def check_shared(nsb: int, tile: int) -> None:
    """Raise where a block's shared memory does not hold the tile's rays and its row's sort."""
    if smem_bytes(nsb, tile) > MAX_SMEM:
        raise ValueError(f"open_w: {nsb} superblocks in tiles of {tile} need {smem_bytes(nsb, tile)} bytes of shared "
                         f"memory a block; the card has {MAX_SMEM}")


def _check(o, d, tmin, bound, sbounds, d2, r2t, tile: int) -> None:
    K.require_cuda(tmin, "open_w")
    n = tmin.shape[0]
    dev = tmin.device
    for a in (*o, *d, tmin, bound):
        if a.dtype != torch.float32 or a.shape != (n,) or not a.is_contiguous() or a.device != dev:
            raise ValueError(f"open_w: ray components must be contiguous [N] f32 on {dev}")
    if tile % 32 or not 32 <= tile <= MAX_TILE:
        raise ValueError(f"open_w: tile {tile} is not a multiple of 32 in [32, {MAX_TILE}]")
    if (sbounds.dtype != torch.float32 or sbounds.dim() != 2 or sbounds.shape[0] != 8 or sbounds.shape[1] < 1
            or not sbounds.is_contiguous() or sbounds.device != dev):
        raise ValueError(f"open_w: superblock boxes must be contiguous [8, nsb] f32 on {dev}")
    check_shared(sbounds.shape[1], tile)
    if (d2 is None) != (r2t is None):
        raise ValueError("open_w: d2 and r2t go together")
    if d2 is not None:
        n_tiles, nsb = -(-n // tile), sbounds.shape[1]
        for a, shape in ((d2, (n_tiles, nsb)), (r2t, (n_tiles,))):
            if a.dtype != torch.float32 or a.shape != shape or not a.is_contiguous() or a.device != dev:
                raise ValueError(f"open_w: d2 [{n_tiles}, {nsb}] and r2t [{n_tiles}] must be contiguous f32 on {dev}")


def _launch(o, d, tmin, bound, sbounds, d2, r2t, tile: int):
    """One launch of K9 -> (open, W, min_tn, SweepOrder)."""
    _check(o, d, tmin, bound, sbounds, d2, r2t, tile)
    n, nsb = tmin.shape[0], sbounds.shape[1]
    n_tiles = -(-n // tile)
    dev = tmin.device
    open_ = torch.empty(n, dtype=torch.bool, device=dev)
    w = torch.empty((n_tiles, nsb), dtype=torch.bool, device=dev)
    tn = torch.empty((n_tiles, nsb), dtype=torch.float32, device=dev)
    order = torch.empty((n_tiles, nsb), dtype=torch.int32, device=dev)
    tnear = torch.empty((n_tiles, nsb), dtype=torch.float32, device=dev)
    count = torch.empty(n_tiles, dtype=torch.int32, device=dev)
    if n:
        rc = build.load().strelka_open_w(
            *(a.data_ptr() for a in (*o, *d, tmin, bound)), sbounds.data_ptr(), nsb,
            d2.data_ptr() if d2 is not None else None, r2t.data_ptr() if r2t is not None else None, tile, n,
            *(a.data_ptr() for a in (open_, w, tn, order, tnear, count)), build.stream_ptr(dev),
        )
        build.check(rc, "strelka_open_w")
        K.count_launch("open_w", (n, nsb, tile, int(d2 is not None)))  # rays, boxes, tile, open flag
    return open_, w, tn, SweepOrder(order, count, tile, tnear)


def open_w(o, d, tmin, bound, sbounds, d2=None, r2t=None, tile: int = MAX_TILE):
    """K9 -> (open [N] bool, W [n_tiles, nsb] bool, min_tn [n_tiles, nsb] f32)."""
    if tmin.device.type == "cpu":
        return open_w_plain(o, d, tmin, bound, sbounds, d2, r2t, tile)
    return _launch(o, d, tmin, bound, sbounds, d2, r2t, tile)[:3]


def sweep_order_plain(o, d, tmin, tmax, sbounds, tile: int) -> SweepOrder:
    """Plain K9's sweep order: open_w_plain, then each tile's passed boxes by
    (min_tn, index), -0.0 taken as +0.0 (a radix sort on the card orders
    -0.0 before +0.0, a comparison sort takes them as equal), then the
    others by index; with the min_tn entries themselves in that order and
    the passed boxes' count."""
    _, w, tn = open_w_plain(o, d, tmin, tmax, sbounds, tile=tile)
    order = torch.sort(torch.where(w, tn + 0.0, float("inf")), dim=1, stable=True).indices
    return SweepOrder(order.to(torch.int32), w.sum(dim=1, dtype=torch.int32), tile, tn.gather(1, order))


def sweep_order(o, d, tmin, tmax, sbounds, tile: int) -> SweepOrder:
    """The cone sweeps' order per ray tile from K9: the superblocks some ray
    of the tile passes, by the least entry distance among the tile's rays
    (of equal distances the lower index first), then the others; with those
    distances in the same order. One launch on the card."""
    if tmin.device.type == "cpu":
        return sweep_order_plain(o, d, tmin, tmax, sbounds, tile)
    return _launch(o, d, tmin, tmax, sbounds, None, None, tile)[3]
