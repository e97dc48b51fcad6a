"""Kernel K7's near-to-far walk and the persistent launch of K7/K8, on the CPU.

The kernels themselves run only on the card (chip_smoke.py holds them
against their plain versions there); here:

- `ops/curves.py:near_to_far_sweep`, the plain count of the sub-blocks K7's
  per-ray walk sweeps, equals a loop over the rays, one ray at a time, that
  walks the boxes nearest first and stops at tnear > best t, on fat random
  cones with ties (a sub-block and its cones twice) and grazing rays
  (axis-parallel directions, origins on box corners and inside boxes), in
  one round and in many (a list of 2 entries), over all superblocks and over
  each tile's list from kernel K9's plain version;
- its final t is the plain dense sweep's on every lane, and no cone in a box
  the walk skipped beats it;
- the wrappers' schedule checks raise where they should, and the CPU path
  is the plain dense sweep whatever the walk.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from strelka_tpu_torch.kernels import cones as KC
from strelka_tpu_torch.kernels import open_w as KO
from strelka_tpu_torch.ops import curves as TC
from strelka_tpu_torch.ops import slab
from strelka_tpu_torch.scene import grazing as G

TBLK, SUPER = 16, 8  # small sub-blocks, the main path's 8 a superblock
INF = float("inf")


def _scene(seed=21, m=1000, n=144):
    """Fat cones (radii up to 0.6 in a 6-unit cube) in their given order, the
    first sub-block's 16 cones repeated as the second (equal boxes, equal t);
    rays with dead lanes, axis-parallel directions, origins on box corners
    and inside boxes, some with tmin > 0."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-3, 3, (m, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.6, (m, 3)).astype(np.float32)
    ra = rng.uniform(0.2, 0.6, m).astype(np.float32)
    rb = rng.uniform(0.2, 0.6, m).astype(np.float32)
    for f in (a, b, ra, rb):
        f[TBLK:2 * TBLK] = f[:TBLK]
    cones = TC.FlatCones(a, b, ra, rb, np.arange(m, dtype=np.int32), np.zeros(m, np.float32), np.ones(m, np.float32))
    rows, bounds = TC.pack_cones(cones, tblk=TBLK, super_=SUPER)
    sbounds = TC.cone_super_bounds(bounds, SUPER)
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::6] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, len(d[::6]))] * rng.choice([-1, 1], (len(d[::6]), 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[1::8] = bounds[0:3, rng.integers(0, 32, len(o[1::8]))].T  # on a sub-block box's corner
    o[3::8] = a[rng.integers(0, m, len(o[3::8]))]  # inside a cone, and so inside its boxes
    tmin = np.where(np.arange(n) % 5 == 2, 1e-3, 0.0).astype(np.float32)
    tmax = np.full(n, 1e16, np.float32)
    tmax[::9] = 0.0  # dead lanes
    tmax[4::9] = 4.0
    t = lambda x: torch.tensor(np.ascontiguousarray(x))  # noqa: E731
    return (t(TC.cone_major_rows(rows)), t(bounds), t(sbounds), tuple(t(o[:, k]) for k in range(3)),
            tuple(t(d[:, k]) for k in range(3)), t(tmin), t(tmax))


def _walk_one_ray(geom, bounds, sbounds, o, d, tn, tx, cand, cap):
    """One ray's near-to-far walk, written out: rounds of up to `cap`
    entered candidates, nearest first, sub-blocks nearest first, a stop at
    the first box with tnear > best t -> (sub-blocks swept in order, best t)."""
    nsb, nb = sbounds.shape[1], bounds.shape[1]
    sup, tblk = nb // nsb, geom.shape[0] // nb
    best = 1e16
    swept = []
    if not tx > tn:
        return swept, np.float32(best)
    ray = ([c.reshape(1) for c in o], [c.reshape(1) for c in d], torch.tensor([tn], dtype=torch.float32))

    def tnear(table, j, bound):
        return float(TC.slab_tnear(*ray, torch.tensor([bound], dtype=torch.float32), table[:, j:j + 1])[0, 0])

    pos = 0
    while True:
        entries = []
        while pos < len(cand) and len(entries) < cap:
            v = tnear(sbounds, cand[pos], min(best, tx))
            if v < INF:
                entries.append((v, len(entries), cand[pos]))
            pos += 1
        while entries:
            v, at, sb = min(entries)  # of equal tnear the first kept
            if v > best:
                break
            entries.remove((v, at, sb))
            subs = [(tnear(bounds, sb * sup + k, min(best, tx)), k) for k in range(sup)]
            subs = [s for s in subs if s[0] < INF]
            while subs:
                sv, k = min(subs)  # of equal tnear the lowest
                if sv > best:
                    break
                subs.remove((sv, k))
                blk = sb * sup + k
                a, b, ra, rb = TC._geom_columns(geom[None, blk * tblk:(blk + 1) * tblk])
                t, _, hit = TC.ray_round_cone([c[:, None] for c in ray[0]], [c[:, None] for c in ray[1]], a, b, ra,
                                              rb, ray[2][:, None], torch.tensor([[tx]], dtype=torch.float32))
                t = torch.where(hit & (ra >= 0.0), t, TC.MISS_T)
                best = min(best, float(t.min()))
                swept.append(blk)
        if pos >= len(cand):
            return swept, np.float32(best)


def _candidates(scene, tile):
    """Per ray: its candidate superblocks and how many count (None: all)."""
    if tile is None:
        return None, None
    geom, bounds, sbounds, o, d, tmin, tmax = scene
    order = KO.sweep_order(o, d, tmin, tmax, sbounds, tile)
    tiles = torch.arange(tmin.shape[0]) // tile
    return order.order[tiles], order.count[tiles]


@pytest.mark.parametrize("cap,tile", [(64, None), (2, None), (64, 32), (2, 32)])
def test_near_to_far_count_equals_a_loop_over_the_rays(cap, tile):
    scene = _scene()
    geom, bounds, sbounds, o, d, tmin, tmax = scene
    cand, count = _candidates(scene, tile)
    swept, best = TC.near_to_far_sweep(geom, bounds, sbounds, o, d, tmin, tmax, cand, count, cap=cap, chunk=100)
    nsb = sbounds.shape[1]
    for i in range(tmin.shape[0]):
        row = list(range(nsb)) if cand is None else cand[i, :int(count[i])].tolist()
        want, want_t = _walk_one_ray(geom, bounds, sbounds, [c[i] for c in o], [c[i] for c in d], float(tmin[i]),
                                     float(tmax[i]), row, cap)
        assert int(swept[i]) == len(want) and len(set(want)) == len(want), i
        assert best[i].item() == want_t, i
    live = tmax > tmin
    assert (swept[~live] == 0).all() and int(swept[live].min()) >= 0 and int(swept.max()) > 2


@pytest.mark.parametrize("cap", [64, 2])
def test_near_to_far_skips_no_cone_that_beats_the_final_t(cap):
    """The walk's final t is the dense sweep's on every lane, and every cone
    of a sub-block it did not sweep misses, hits later, or hits at the same
    t with a higher index than the winner."""
    geom, bounds, sbounds, o, d, tmin, tmax = _scene(seed=22)
    swept, best = TC.near_to_far_sweep(geom, bounds, sbounds, o, d, tmin, tmax, cap=cap)
    t_p, c_p, _ = TC.intersect_curves_closest_plain(geom, o, d, tmin, tmax)
    assert torch.equal(best, t_p)
    assert int((c_p >= 0).sum()) > 60
    nb, nsb = bounds.shape[1], sbounds.shape[1]
    tblk = geom.shape[0] // nb
    skipped_total = 0
    for i in torch.nonzero(tmax > tmin)[:, 0].tolist():
        blocks, _ = _walk_one_ray(geom, bounds, sbounds, [c[i] for c in o], [c[i] for c in d], float(tmin[i]),
                                  float(tmax[i]), list(range(nsb)), cap)
        skipped = torch.ones(nb, dtype=torch.bool)
        skipped[blocks] = False
        cols = lambda c: [x[i].reshape(1, 1) for x in c]  # noqa: E731
        a, b, ra, rb = TC._geom_columns(geom[None])
        t, _, hit = TC.ray_round_cone(cols(o), cols(d), a, b, ra, rb, tmin[i].reshape(1, 1), tmax[i].reshape(1, 1))
        t = torch.where(hit & (ra >= 0.0), t, TC.MISS_T)[0]
        in_skipped = skipped.repeat_interleave(tblk)
        idx = torch.arange(geom.shape[0])
        beats = (t < t_p[i]) | ((t == t_p[i]) & (t < TC.MISS_T) & (idx < int(c_p[i])))
        assert not (beats & in_skipped).any(), i
        skipped_total += int(skipped.sum())
    assert skipped_total > 0


def test_ties_of_boxes_and_cones_go_to_the_lowest():
    """The scene's second sub-block repeats the first: equal tnears and equal
    t; the walk sweeps the first before the second, and the winner of such a
    tie is the lower cone index."""
    geom, bounds, sbounds, o, d, tmin, tmax = _scene()
    assert torch.equal(bounds[:, 0], bounds[:, 1]) and torch.equal(geom[:TBLK], geom[TBLK:2 * TBLK])
    t_p, c_p, _ = TC.intersect_curves_closest_plain(geom, o, d, tmin, tmax)
    tie = (c_p >= 0) & (c_p < TBLK)
    assert int(tie.sum()) > 0 and not ((c_p >= TBLK) & (c_p < 2 * TBLK)).any()
    i = int(torch.nonzero(tie)[0, 0])
    blocks, _ = _walk_one_ray(geom, bounds, sbounds, [c[i] for c in o], [c[i] for c in d], float(tmin[i]),
                              float(tmax[i]), list(range(sbounds.shape[1])), 64)
    assert 0 in blocks and (1 not in blocks or blocks.index(0) < blocks.index(1))


def test_slab_tnear_per_ray_boxes_equal_shared_boxes():
    geom, bounds, sbounds, o, d, tmin, tmax = _scene()
    shared = TC.slab_tnear(o, d, tmin, tmax, bounds)
    own = TC.slab_tnear(o, d, tmin, tmax, bounds[:, None, :].expand(8, tmin.shape[0], bounds.shape[1]))
    assert torch.equal(shared, own)
    assert torch.equal(TC.slab_enters(o, d, tmin, tmax, bounds), shared < INF)
    entered = shared < INF
    low = (tmin - torch.abs(tmin) * slab.SLACK)[:, None].expand_as(shared)  # the margin lowers tnear by its slack
    assert bool(entered.any()) and ((shared[entered] >= low[entered])).all()
    assert (shared[entered] <= tmax[:, None].expand_as(shared)[entered]).all()


def test_schedule_checks_raise():
    geom, bounds, sbounds, *_ = _scene()
    pc = KC.PackedCones(geom, bounds, sbounds)
    assert KC.grid(294912, 6, 128, 132) == 792 and KC.grid(100, 6, 128, 132) == 25 and KC.grid(0, 6, 128, 132) == 1
    with pytest.raises(ValueError, match="does not fit"):
        KC.grid(1000, 0, 128, 132)
    with pytest.raises(ValueError, match="counter"):
        KC.grid(2 ** 31 - 1000, 6, 128, 132)
    KC.check_near_to_far(pc, TC.CONE_LIST, 128)
    with pytest.raises(ValueError, match="shared memory"):
        KC.check_near_to_far(pc, 10000, 128)
    with pytest.raises(ValueError, match="shared memory"):
        KC.check_near_to_far(pc, 0, 128)
    four = KC.PackedCones(geom, bounds, torch.tensor(TC.cone_super_bounds(bounds.numpy(), 4)))
    with pytest.raises(ValueError, match="sub-blocks a superblock"):
        KC.check_near_to_far(four, TC.CONE_LIST, 128)


def test_cpu_wrappers_take_the_dense_sweep_whatever_the_walk():
    geom, bounds, sbounds, o, d, tmin, tmax = _scene(seed=23)
    pc = KC.PackedCones(geom, bounds, sbounds)
    plain = TC.intersect_curves_closest_plain(geom, o, d, tmin, tmax)
    for near_to_far in (True, False):
        out = KC.cone_closest(o, d, tmin, tmax, pc, near_to_far=near_to_far)
        assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert torch.equal(KC.cone_any(o, d, tmin, tmax, pc), plain[1] >= 0)
    with pytest.raises(ValueError, match="stats"):
        KC.cone_any(o, d, tmin, tmax, pc, stats=True)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        KC._check(o, d, tmin, tmax, pc, None, "cone_closest")


def test_sweep_order_tnears_bound_every_ray_of_the_tile():
    """K7 stops scanning its tile's list at the first entry whose least tnear
    over the tile's rays is above its best t; that needs the list's tnears
    ascending and no ray of the tile entering a listed superblock before it."""
    geom, bounds, sbounds, o, d, tmin, tmax = _scene(seed=24)
    tile = 32
    order = KO.sweep_order(o, d, tmin, tmax, sbounds, tile)
    _, w, tn = KO.open_w(o, d, tmin, tmax, sbounds, tile=tile)
    assert torch.equal(order.tnear, tn.gather(1, order.order.long()))
    assert (order.tnear[:, 1:] >= order.tnear[:, :-1]).all()
    own = TC.slab_tnear(o, d, tmin, tmax, sbounds)  # [N, nsb]
    for i in range(tmin.shape[0]):
        if not tmax[i] > tmin[i]:
            continue
        row, cnt = order.order[i // tile].long(), int(order.count[i // tile])
        entered = own[i, row] < INF
        assert not entered[cnt:].any()
        assert (own[i, row][entered] >= order.tnear[i // tile][entered]).all()


def _grazing_scene(seed, scale, shift):
    """scene/grazing.py:cone_face_case as tensors: cones along the axes,
    rays at their boxes' faces and corners."""
    geom, bounds, sbounds, o, d = (torch.tensor(np.ascontiguousarray(a)) for a in G.cone_face_case(seed, scale, shift))
    n = o.shape[0]
    return (geom, bounds, sbounds, tuple(o[:, i].contiguous() for i in range(3)),
            tuple(d[:, i].contiguous() for i in range(3)), torch.zeros(n), torch.full((n,), 1e16))


@pytest.mark.parametrize("seed,scale,shift", [(0, 1.0, 0.0), (1, 100.0, 0.0), (3, 0.01, 5.0), (2, 1.0, 300.0)])
def test_rays_at_cone_box_faces_lose_no_hit(seed, scale, shift):
    """ROADMAP C.2: the closed form can put a hit just outside its sub-block's
    or superblock's box. With the port's box test (ops/slab.py) the culled
    walks lose none: K7's near-to-far walk ends at the dense sweep's t on
    every lane, and every occluded lane's hit lies in a sub-block and a
    superblock its interval enters (K8's ascending culled sweep). The
    reference's exact test loses some of these hits."""
    geom, bounds, sbounds, o, d, tmin, tmax = _grazing_scene(seed, scale, shift)
    _, best = TC.near_to_far_sweep(geom, bounds, sbounds, o, d, tmin, tmax)
    t_p, c_p, _ = TC.intersect_curves_closest_plain(geom, o, d, tmin, tmax)
    assert torch.equal(best.view(torch.int32), t_p.view(torch.int32))
    a, b, ra, rb = TC._geom_columns(geom[None])
    _, _, hit = TC.ray_round_cone([c[:, None] for c in o], [c[:, None] for c in d], a, b, ra, rb, tmin[:, None],
                                  tmax[:, None])
    hit = hit & (ra >= 0.0)
    tblk = geom.shape[0] // bounds.shape[1]

    def seen(**margin):
        sub = slab.slab_tnear(o, d, tmin, tmax, bounds, **margin) < INF
        sup = slab.slab_tnear(o, d, tmin, tmax, sbounds, **margin) < INF
        boxes = (sub & sup.repeat_interleave(SUPER, dim=1)).repeat_interleave(tblk, dim=1)
        return (hit & boxes).any(dim=1)

    assert torch.equal(seen(), hit.any(dim=1)) and int((c_p >= 0).sum()) > 1900
    # the same rays against the exact boxes: the winner's box, at the final t
    exact = slab.slab_tnear(o, d, tmin, torch.minimum(t_p, tmax), bounds, pad=0.0, slack=0.0) < INF
    won = c_p >= 0
    lost = ~exact[won, (c_p[won] // tblk).long()]
    assert int(lost.sum()) > 0
