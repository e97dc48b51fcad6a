"""Kernel K9's sweep order, on the CPU.

K9 computes the slab pass of a ray tile against the superblock boxes and,
in the same launch, the tile's sweep order (`kernels/open_w.py:sweep_order`:
the passed boxes by (min_tn, index), -0.0 taken as +0.0, then the others by
index, with min_tn in that order and the count of boxes passed). The kernel
runs only on the card, where chip_smoke.py holds it against the plain twin
bit for bit; here the plain twin (`sweep_order_plain`) is held against a
loop over the tiles that sorts each row by (key, index) in Python:

- on random cones' superblocks (the rays of tests/test_torch_curves.py's
  K9 cases, a partial last tile, dead lanes, axis-parallel directions);
- on a case built for the sort's edges: 45 boxes (no multiple of 32), many
  of them copies (equal keys), rays that start inside boxes with tmin -0.0
  beside rays with tmin +0.0 in the same tile, dead lanes and a last
  partial tile.

`test_open_w_plain_matches_pallas_open_w` (tests/test_torch_curves.py)
holds the plain slab pass against the JAX package's `pallas_open_w`.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import open_w as KO
from strelka_tpu_torch.ops import curves as TC


def _rays(o, d, tmin, tmax):
    return (tuple(torch.tensor(o[:, k].copy()) for k in range(3)), tuple(torch.tensor(d[:, k].copy()) for k in range(3)),
            torch.tensor(tmin), torch.tensor(tmax))


def _cone_case(seed, n, tile):
    """Rays in tiles with nearby origins against the 8 superblock boxes of
    random cones (as tests/test_torch_curves.py:_open_w_inputs makes them)."""
    rng = np.random.default_rng(seed)
    m = 2048 - 100
    a = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.5, (m, 3)).astype(np.float32)
    r = rng.uniform(0.02, 0.2, (2, m)).astype(np.float32)
    cones = TC.FlatCones(a, b, r[0], r[1], np.arange(m, dtype=np.int32), np.zeros(m, np.float32), np.ones(m, np.float32))
    cones = TC.FlatCones(*[f[TC.morton_sort_cones(cones)] for f in cones])
    _, bounds = TC.pack_cones(cones, tblk=64, super_=2)
    sbounds = TC.cone_super_bounds(bounds, 2)
    centres = np.repeat(rng.uniform(-5, 5, (-(-n // tile), 3)), tile, axis=0)[:n]
    o = (centres + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::17, 1] = 0.0
    tmax = rng.uniform(0.5, 5.0, n).astype(np.float32)
    tmax[::7] = 0.0
    return _rays(o, d, np.zeros(n, np.float32), tmax) + (torch.tensor(sbounds),)


def _edge_case(tile=64, n=200):
    """45 boxes: 15 unit cubes along x, each three times over (ids j, j + 15,
    j + 30: equal keys), the last three above the others, and rays that
    start inside one of the first twelve each and run along +x (so they pass
    the cubes ahead too, and never the last three), tmin -0.0 on even lanes
    and +0.0 on odd ones, every ninth lane dead, n no multiple of the tile."""
    lo = np.stack([np.arange(15) * 2.0, np.where(np.arange(15) < 12, 0.0, 3.0), np.zeros(15)], axis=1)
    boxes = np.concatenate([lo, lo, lo])
    sbounds = np.zeros((8, 45), np.float32)
    sbounds[0:3] = boxes.T
    sbounds[3:6] = boxes.T + 1.0
    rng = np.random.default_rng(3)
    cube = rng.integers(0, 12, n)
    o = (lo[cube] + rng.uniform(0.2, 0.8, (n, 3))).astype(np.float32)
    d = np.tile(np.array([[1.0, 0.0, 0.0]], np.float32), (n, 1))
    d[1::3] = [1.0, 1e-3, -1e-3]
    tmin = np.where(np.arange(n) % 2 == 0, np.float32(-0.0), np.float32(0.0)).astype(np.float32)
    tmax = np.full(n, 9.0, np.float32)
    tmax[::9] = tmin[::9]
    return _rays(o, d, tmin, tmax) + (torch.tensor(sbounds),)


def _order_by_loop(w, tn, tile):
    """Each row's passed boxes sorted by (key, index) in Python, key = min_tn
    with -0.0 as +0.0, then the others by index."""
    orders = []
    for row, passed in zip(tn.tolist(), w.tolist()):
        orders.append(sorted(range(len(row)), key=lambda j: (not passed[j], row[j] + 0.0 if passed[j] else 0.0, j)))
    order = torch.tensor(orders, dtype=torch.int32)
    return KO.SweepOrder(order, w.sum(dim=1, dtype=torch.int32), tile, tn.gather(1, order.long()))


def _assert_same_order(a, b):
    assert a.tile == b.tile and a.order.dtype == b.order.dtype == torch.int32
    assert torch.equal(a.order, b.order) and torch.equal(a.count, b.count)
    assert torch.equal(a.tnear.view(torch.int32), b.tnear.view(torch.int32))  # signed zeros too


@pytest.mark.parametrize("seed,n,tile", [(13, 500, 128), (14, 333, 32), (15, 1000, 64)])
def test_plain_sweep_order_equals_a_loop_over_the_tiles(seed, n, tile):
    o, d, tmin, tmax, sbounds = _cone_case(seed, n, tile)
    K.reset_counts()
    got = KO.sweep_order(o, d, tmin, tmax, sbounds, tile)
    assert not any(K.launch_counts.values()) and not any(K.plain_cuda_calls.values())
    _, w, tn = KO.open_w_plain(o, d, tmin, tmax, sbounds, tile=tile)
    _assert_same_order(got, _order_by_loop(w, tn, tile))
    assert got.order.shape == (math.ceil(n / tile), sbounds.shape[1])
    assert 0 < int(got.count.sum()) < got.order.numel()


def test_plain_sweep_order_at_the_sorts_edges():
    tile = 64
    o, d, tmin, tmax, sbounds = _edge_case(tile)
    got = KO.sweep_order_plain(o, d, tmin, tmax, sbounds, tile)
    _, w, tn = KO.open_w_plain(o, d, tmin, tmax, sbounds, tile=tile)
    _assert_same_order(got, _order_by_loop(w, tn, tile))
    assert got.order.shape == (4, 45) and tn.shape == (4, 45)
    # the case makes what it is for: both zeros among a row's keys, copies at equal keys, unpassed boxes
    neg = (tn == 0) & (tn.view(torch.int32) < 0)
    pos = (tn == 0) & (tn.view(torch.int32) == 0)
    assert bool((neg.any(dim=1) & pos.any(dim=1)).any())
    assert torch.equal(tn[:, 0:15], tn[:, 15:30]) and torch.equal(tn[:, 0:15], tn[:, 30:45])
    assert bool((got.count <= 36).all()) and bool((got.count > 0).all())
    # a row's copies follow each other, the lower index first, whatever the sign of their zero
    for r in range(4):
        row = got.order[r].tolist()
        for j in range(15):
            assert row.index(j) < row.index(j + 15) < row.index(j + 30)
        head = got.tnear[r, :int(got.count[r])]
        assert bool((head[1:] >= head[:-1]).all())


def test_the_order_keeps_every_superblock_a_ray_of_the_tile_passes():
    o, d, tmin, tmax, sbounds = _cone_case(16, 700, 64)
    order = KO.sweep_order(o, d, tmin, tmax, sbounds, 64)
    _, w, _ = KO.open_w(o, d, tmin, tmax, sbounds, tile=64)
    for r in range(w.shape[0]):
        head = order.order[r, :int(order.count[r])].long()
        assert torch.equal(torch.sort(head).values, torch.nonzero(w[r])[:, 0])


def test_shared_memory_sets_the_largest_row():
    assert KO.smem_bytes(391, 64) == 40 * 64 + 16 * 391 + 128  # hair_long's superblocks in tiles of 64
    assert KO.smem_bytes(1, 32) == 40 * 32 + 16 + 128
    KO.check_shared(11960, KO.MAX_TILE)  # 40 KB of rays, 187 KB of boxes: the card's 227 KB
    with pytest.raises(ValueError, match="shared memory"):
        KO.check_shared(11961, KO.MAX_TILE)
    with pytest.raises(ValueError, match="shared memory"):
        KO.check_shared(20000, 64)
