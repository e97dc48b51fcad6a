"""Kernels K7/K8's walk of the cone tree and their persistent launch, on the CPU.

The kernels themselves run only on the card (tests/test_torch_cones_card.py
and chip_smoke.py hold them against their plain versions there); here:

- `ops/curves.py:cone_tree`: every live cone's box lies in its leaf's box
  and in every ancestor's, padding is inverted at every level, and the
  depth follows the number of cones;
- `ops/curves.py:cone_tree_walk`, the plain count of the walk (boxes
  tested, leaves swept, cones tested, the final t), equals a loop over the
  rays, one ray at a time, that walks the tree nearest first and drops a box
  at tnear > best t (K7) or in child order up to the first hit (K8), tests
  a leaf's cones where their own box is entered, on fat random cones
  with ties (a leaf and its cones twice) and grazing rays (axis-parallel
  directions, origins on box corners and inside boxes), with the kernels'
  leaves and fan-out and with small ones that make a deep tree;
- its final t is the plain dense sweep's on every lane, and no cone in a
  leaf the walk skipped beats it; ties go to the lowest index;
- rays at the faces and corners of the leaf and node boxes lose no hit;
- the wrappers' checks raise where they should, and the CPU path is the
  plain dense sweep.
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

INF = float("inf")
# (cones a leaf, children a node): the kernels', and small ones that make a deep tree of few cones
SHAPES = {"kernel": (TC.CONE_LEAF, TC.CONE_WIDE), "deep": (8, 4)}


@pytest.fixture(autouse=True)
def one_thread():
    """The walks run many small tensor operations, which threads slow down
    where several test processes share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=sorted(SHAPES))
def tree_shape(request, monkeypatch):
    leaf, wide = SHAPES[request.param]
    monkeypatch.setattr(TC, "CONE_LEAF", leaf)
    monkeypatch.setattr(TC, "CONE_WIDE", wide)
    return leaf, wide


def _scene(seed=21, m=1100, n=144):
    """Fat cones (radii up to 0.6 in a 6-unit cube) in their given order, the
    first leaf's cones repeated as the second (equal boxes, equal t); rays
    with dead lanes, axis-parallel directions, origins on box corners and
    inside cones, some with tmin > 0 -> (geometry, tree, o, d, tmin, tmax)."""
    rng = np.random.default_rng(seed)
    leaf = TC.CONE_LEAF
    a = rng.uniform(-3, 3, (m, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.6, (m, 3)).astype(np.float32)
    ra = rng.uniform(0.2, 0.6, m).astype(np.float32)
    rb = rng.uniform(0.2, 0.6, m).astype(np.float32)
    for f in (a, b, ra, rb):
        f[leaf:2 * leaf] = f[:leaf]
    cones = TC.FlatCones(a, b, ra, rb, np.arange(m, dtype=np.int32), np.zeros(m, np.float32), np.ones(m, np.float32))
    geom = TC.cone_major_rows(TC.pack_cones(cones, tblk=leaf, super_=1)[0])
    tree = TC.cone_tree(geom).numpy()
    o = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::6] = np.eye(3, dtype=np.float32)[rng.integers(0, 3, len(d[::6]))] * rng.choice([-1, 1], (len(d[::6]), 1))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    live = tree[:, (tree[3:6] >= tree[0:3]).all(axis=0)]
    o[1::8] = live[0:3, rng.integers(0, live.shape[1], len(o[1::8]))].T  # on a box's corner
    o[3::8] = a[rng.integers(0, m, len(o[3::8]))]  # inside a cone, and so inside its boxes
    aim = 0.5 * (a + b)[rng.integers(0, leaf, len(o[5::8]))]  # at the first leaf's cones, which tie with the second's
    o[5::8] = aim + 8.0 * d[5::8]
    d[5::8] = -d[5::8]
    tmin = np.where(np.arange(n) % 5 == 2, 1e-3, 0.0).astype(np.float32)
    tmax = np.full(n, 1e16, np.float32)
    tmax[::9] = 0.0  # dead lanes
    tmax[4::9] = 4.0
    t = lambda x: torch.tensor(np.ascontiguousarray(x))  # noqa: E731
    return (t(geom), t(tree), tuple(t(o[:, k]) for k in range(3)), tuple(t(d[:, k]) for k in range(3)), t(tmin),
            t(tmax))


def _walk_one_ray(geom, tree, o, d, tn, tx, any_hit=False):
    """One ray's walk of the cone tree, written out: a stack of (tnear, box),
    the entered boxes pushed with the first to visit on top (closest hit:
    the nearest, of equal tnear the lower box; any hit: the lowest box), a
    popped box dropped at tnear > best t (closest hit), a leaf's cones
    tested where their own box is entered -> (inner boxes tested, leaves
    swept in order, the cones whose box was entered, leaves that ran the
    closed form, best t)."""
    levels = TC.cone_tree_levels(geom.shape[0])
    leaf0, leaf, wide = levels[-1][0], TC.CONE_LEAF, TC.CONE_WIDE
    best, boxes, leaves, cones, forms = 1e16, 0, [], [], 0
    if not tx > tn:
        return 0, leaves, cones, 0, np.float32(best)
    ray = ([c.reshape(1) for c in o], [c.reshape(1) for c in d], torch.tensor([tn], dtype=torch.float32))
    bound = lambda: torch.tensor([tx if any_hit else min(best, tx)], dtype=torch.float32)  # noqa: E731
    stack = []

    def push(first, count):
        v = TC.slab_tnear(*ray, bound(), tree[:, first:first + count])[0]
        entered = [(float(v[k]), first + k) for k in range(count) if v[k] < INF]
        stack.extend(reversed(entered if any_hit else sorted(entered)))
        return count

    boxes += push(0, levels[0][1])
    while stack:
        tnear, box = stack.pop()
        if not any_hit and tnear > best:
            continue
        if box >= leaf0:
            j = box - leaf0
            g = geom[j * leaf:(j + 1) * leaf]
            entered = TC.slab_tnear(*ray, bound(), TC.cone_boxes(g))[0] < INF
            leaves.append(j)
            cones += (j * leaf + torch.nonzero(entered)[:, 0]).tolist()
            forms += bool(entered.any())
            a, b, ra, rb = TC._geom_columns(g[None])
            t, _, hit = TC.ray_round_cone([c[:, None] for c in ray[0]], [c[:, None] for c in ray[1]], a, b, ra, rb,
                                          ray[2][:, None], torch.tensor([[tx]], dtype=torch.float32), any_hit)
            best = min(best, float(torch.where(hit & entered[None], t, TC.MISS_T).min()))
            if any_hit and best < TC.MISS_T:
                break
        else:
            lvl = max(k for k, (f, _) in enumerate(levels) if box >= f)
            boxes += push(levels[lvl + 1][0] + wide * (box - levels[lvl][0]), wide)
    return boxes, leaves, cones, forms, np.float32(best)


@pytest.mark.parametrize("m", [1, 3000, 10240, 800000])
def test_tree_boxes_hold_their_cones_and_padding_is_inverted(m, tree_shape):
    leaf, wide = tree_shape
    rng = np.random.default_rng(m)
    geom = np.zeros((-(-m // 2048) * 2048, 8), np.float32)
    geom[:m, 0:3] = rng.uniform(-3, 3, (m, 3))
    geom[:m, 4:7] = geom[:m, 0:3] + rng.normal(0, 0.3, (m, 3))
    geom[:m, 3], geom[:m, 7] = rng.uniform(0, 0.3, m), rng.uniform(0, 0.3, m)
    geom[m:, 3] = geom[m:, 7] = -1.0
    levels = TC.cone_tree_levels(geom.shape[0])
    # the depth follows the count: the top level at most `wide` boxes, each level below `wide` times the one above
    assert levels[0][1] <= wide and levels[-1][1] >= geom.shape[0] // leaf
    assert all(c == wide * pc and f == pf + pc for (pf, pc), (f, c) in zip(levels, levels[1:]))
    if m == 800000 and leaf == 32:
        assert levels == ((0, 25), (25, 800), (825, 25600))
    if m == 10240 and leaf == 32:
        assert levels == ((0, 10), (10, 320))
    if m <= 2048 and leaf == 32:
        assert levels == ((0, 2), (2, 64))
    assert len(TC.cone_tree_levels(leaf * wide)) == 1
    tree = TC.cone_tree(geom).numpy()
    own = TC.cone_boxes(geom).numpy()
    lo, hi = own[0:3].T, own[3:6].T
    live = geom[:, 3] >= 0
    box = np.arange(geom.shape[0]) // leaf  # each cone's leaf, then its ancestors
    for f, c in levels[::-1]:
        assert (tree[0:3, f + box[live]].T <= lo[live]).all() and (tree[3:6, f + box[live]].T >= hi[live]).all()
        held = np.zeros(c, bool)
        held[box[live]] = True
        inverted = (tree[0:3, f:f + c] > tree[3:6, f:f + c]).all(axis=0)
        assert np.array_equal(inverted, ~held)  # a box is inverted exactly where it holds no live cone
        box = box // wide
    np.testing.assert_array_equal(tree[6:8], 0.0)


@pytest.mark.parametrize("any_hit", [False, True])
def test_near_to_far_count_equals_a_loop_over_the_rays(any_hit, tree_shape):
    geom, tree, o, d, tmin, tmax = _scene()
    got = TC.cone_tree_walk(geom, tree, o, d, tmin, tmax, any_hit=any_hit, chunk=50)
    for i in range(tmin.shape[0]):
        boxes, leaves, cones, forms, best = _walk_one_ray(geom, tree, [c[i] for c in o], [c[i] for c in d],
                                                          float(tmin[i]), float(tmax[i]), any_hit)
        assert (int(got.boxes[i]), int(got.leaves[i]), int(got.cones[i]), int(got.forms[i])) == (
            boxes, len(leaves), len(cones), forms), i
        assert len(set(leaves)) == len(leaves) and got.t[i].item() == best, i
    live = tmax > tmin
    assert not got.leaves[~live].any() and int(got.leaves.max()) > 2 and int(got.boxes[live].min()) > 0
    assert (got.cones <= TC.CONE_LEAF * got.forms).all() and (got.forms <= got.leaves).all() and int(got.cones.sum())


def test_tree_walk_any_hit_is_the_dense_any_hit_sweep(tree_shape):
    geom, tree, o, d, tmin, tmax = _scene(seed=25)
    got = TC.cone_tree_walk(geom, tree, o, d, tmin, tmax, any_hit=True)
    occ = TC.intersect_curves_any_plain(geom, o, d, tmin, tmax)
    assert torch.equal(got.t < TC.MISS_T, occ) and int(occ.sum()) > 30
    closest = TC.cone_tree_walk(geom, tree, o, d, tmin, tmax)
    assert int((got.leaves <= closest.leaves).sum()) > tmin.shape[0] // 2  # the first hit ends the walk


def test_near_to_far_skips_no_cone_that_beats_the_final_t(tree_shape):
    """The walk's final t is the dense sweep's on every lane, and every cone
    it did not test (in a leaf it did not sweep, or whose own box the
    interval did not enter) misses, hits later, or hits at the same t with a
    higher index than the winner."""
    geom, tree, o, d, tmin, tmax = _scene(seed=22)
    walk = TC.cone_tree_walk(geom, tree, o, d, tmin, tmax)
    t_p, c_p, _ = TC.intersect_curves_closest_plain(geom, o, d, tmin, tmax)
    assert torch.equal(walk.t, t_p)
    assert int((c_p >= 0).sum()) > 60
    leaf = TC.CONE_LEAF
    nleaf = geom.shape[0] // leaf
    skipped_total = 0
    for i in torch.nonzero(tmax > tmin)[:, 0].tolist():
        _, leaves, tested, _, _ = _walk_one_ray(geom, tree, [c[i] for c in o], [c[i] for c in d], float(tmin[i]),
                                                float(tmax[i]))
        skipped = torch.ones(nleaf, dtype=torch.bool)
        skipped[leaves] = False
        untested = torch.ones(geom.shape[0], dtype=torch.bool)
        untested[tested] = False
        cols = lambda c: [x[i].reshape(1, 1) for x in c]  # noqa: E731
        a, b, ra, rb = TC._geom_columns(geom[None])
        t, _, hit = TC.ray_round_cone(cols(o), cols(d), a, b, ra, rb, tmin[i].reshape(1, 1), tmax[i].reshape(1, 1))
        t = torch.where(hit & (ra >= 0.0), t, TC.MISS_T)[0]
        idx = torch.arange(geom.shape[0])
        beats = (t < t_p[i]) | ((t == t_p[i]) & (t < TC.MISS_T) & (idx < int(c_p[i])))
        assert not (beats & untested).any(), i
        skipped_total += int(skipped.sum()) + int((untested & ~skipped.repeat_interleave(leaf)).sum())
    assert skipped_total > 0


def test_ties_of_boxes_and_cones_go_to_the_lowest(tree_shape):
    """The scene's second leaf repeats the first: equal boxes, equal tnears
    and equal t; the walk sweeps the first leaf before the second, and the
    winner of such a tie is the lower cone index."""
    geom, tree, o, d, tmin, tmax = _scene()
    leaf, leaf0 = TC.CONE_LEAF, TC.cone_tree_levels(geom.shape[0])[-1][0]
    assert torch.equal(tree[:, leaf0], tree[:, leaf0 + 1]) and torch.equal(geom[:leaf], geom[leaf:2 * leaf])
    t_p, c_p, _ = TC.intersect_curves_closest_plain(geom, o, d, tmin, tmax)
    tie = (c_p >= 0) & (c_p < leaf)
    assert int(tie.sum()) > 0 and not ((c_p >= leaf) & (c_p < 2 * leaf)).any()
    for i in torch.nonzero(tie)[:, 0].tolist():
        _, leaves, _, _, _ = _walk_one_ray(geom, tree, [c[i] for c in o], [c[i] for c in d], float(tmin[i]),
                                           float(tmax[i]))
        assert 0 in leaves and (1 not in leaves or leaves.index(0) < leaves.index(1)), i


def test_cones_entered_counts_the_cones_whose_box_the_interval_enters():
    geom, tree, o, d, tmin, tmax = _scene(seed=26)
    t_p, _, _ = TC.intersect_curves_closest_plain(geom, o, d, tmin, tmax)
    tfar = torch.minimum(t_p, tmax)
    got = TC.cones_entered(geom, o, d, tmin, tfar, chunk=7)
    lo, hi = geom[:, 0:3], geom[:, 4:7]  # the boxes written out: padding inverted, live cones by their radii
    ra, rb = geom[:, 3:4], geom[:, 7:8]
    pad = (ra < 0).T
    boxes = torch.cat([torch.minimum(lo - ra, hi - rb).T.masked_fill(pad, 1e30),
                       torch.maximum(lo + ra, hi + rb).T.masked_fill(pad, -1e30), torch.zeros((2, geom.shape[0]))])
    assert torch.equal(boxes, TC.cone_boxes(geom))
    want = (slab.slab_tnear(o, d, tmin, tfar, boxes) < INF).sum(dim=1)
    assert torch.equal(got, torch.where(tfar > tmin, want, 0))
    walk = TC.cone_tree_walk(geom, tree, o, d, tmin, tmax)
    assert (walk.cones >= got).all() and int(got.sum()) > 0  # the walk's intervals hold the final one


def test_slab_tnear_per_ray_boxes_equal_shared_boxes():
    geom, tree, o, d, tmin, tmax = _scene()
    shared = TC.slab_tnear(o, d, tmin, tmax, tree)
    own = TC.slab_tnear(o, d, tmin, tmax, tree[:, None, :].expand(8, tmin.shape[0], tree.shape[1]))
    assert torch.equal(shared, own)
    assert torch.equal(TC.slab_enters(o, d, tmin, tmax, tree), shared < INF)
    entered = shared < INF
    low = (tmin - torch.abs(tmin) * slab.SLACK)[:, None].expand_as(shared)  # the margin lowers tnear by its slack
    assert bool(entered.any()) and ((shared[entered] >= low[entered])).all()
    assert (shared[entered] <= tmax[:, None].expand_as(shared)[entered]).all()


def test_schedule_checks_raise():
    geom, tree, o, d, tmin, tmax = _scene()
    assert KC.grid(294912, 6, 128, 132) == 792 and KC.grid(100, 6, 128, 132) == 25 and KC.grid(0, 6, 128, 132) == 1
    with pytest.raises(ValueError, match="does not fit"):
        KC.grid(1000, 0, 128, 132)
    with pytest.raises(ValueError, match="counter"):
        KC.grid(2 ** 31 - 1000, 6, 128, 132)
    with pytest.raises(ValueError, match="whole leaves"):
        TC.cone_tree_levels(1000)
    assert len(TC.cone_tree_levels(TC.CONE_LEAF * TC.CONE_WIDE ** TC.CONE_MAX_LEVELS)) == TC.CONE_MAX_LEVELS
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        KC._check(o, d, tmin, tmax, KC.PackedCones(geom, tree), "cone_closest")
    assert KC.PackedCones(geom, tree).shape == (1120, tree.shape[1]) and KC.PackedCones(geom, tree).levels == (
        (0, 2), (2, 64))


def test_cpu_wrappers_take_the_dense_sweep_whatever_the_walk():
    geom, tree, o, d, tmin, tmax = _scene(seed=23)
    pc = KC.PackedCones(geom, tree)
    plain = TC.intersect_curves_closest_plain(geom, o, d, tmin, tmax)
    out = KC.cone_closest(o, d, tmin, tmax, pc)
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert torch.equal(KC.cone_any(o, d, tmin, tmax, pc), TC.intersect_curves_any_plain(geom, o, d, tmin, tmax))
    for fn in (KC.cone_closest, KC.cone_any):
        with pytest.raises(ValueError, match="stats"):
            fn(o, d, tmin, tmax, pc, stats=True)


def test_sweep_order_tnears_bound_every_ray_of_the_tile():
    """Kernel K9's sweep order (off the cone sweeps' path, kept with its
    plain twin): each tile's list of superblocks comes with tnears that are
    ascending and no greater than any ray of the tile enters them at, and
    no ray of the tile enters a superblock past the list's count."""
    rng = np.random.default_rng(24)
    m, n, tile = 1000, 144, 32
    a = rng.uniform(-3, 3, (m, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.6, (m, 3)).astype(np.float32)
    r = rng.uniform(0.2, 0.6, m).astype(np.float32)
    cones = TC.FlatCones(a, b, r, r.copy(), np.arange(m, dtype=np.int32), np.zeros(m, np.float32),
                         np.ones(m, np.float32))
    sbounds = torch.tensor(TC.cone_super_bounds(TC.pack_cones(cones, tblk=16, super_=8)[1], 8))
    o = tuple(torch.tensor(rng.uniform(-5, 5, n).astype(np.float32)) for _ in range(3))
    dv = rng.normal(size=(n, 3)).astype(np.float32)
    dv /= np.linalg.norm(dv, axis=1, keepdims=True)
    d = tuple(torch.tensor(np.ascontiguousarray(dv[:, k])) for k in range(3))
    tmin, tmax = torch.zeros(n), torch.where(torch.arange(n) % 9 == 0, 0.0, 1e16)
    order = KO.sweep_order(o, d, tmin, tmax, sbounds, tile)
    _, w, tn = KO.open_w(o, d, tmin, tmax, sbounds, tile=tile)
    assert torch.equal(order.tnear, tn.gather(1, order.order.long()))
    assert (order.tnear[:, 1:] >= order.tnear[:, :-1]).all()
    own = TC.slab_tnear(o, d, tmin, tmax, sbounds)  # [N, nsb]
    for i in range(n):
        if not tmax[i] > tmin[i]:
            continue
        row, cnt = order.order[i // tile].long(), int(order.count[i // tile])
        entered = own[i, row] < INF
        assert not entered[cnt:].any()
        assert (own[i, row][entered] >= order.tnear[i // tile][entered]).all()


def _grazing_scene(seed, scale, shift):
    """scene/grazing.py:cone_face_case as tensors: cones along the axes,
    rays at their leaf and node boxes' faces and corners."""
    geom, tree, o, d = (torch.tensor(np.ascontiguousarray(a)) for a in G.cone_face_case(seed, scale, shift))
    n = o.shape[0]
    return (geom, tree, tuple(o[:, i].contiguous() for i in range(3)), tuple(d[:, i].contiguous() for i in range(3)),
            torch.zeros(n), torch.full((n,), 1e16))


def _ancestors(geom, tree):
    """[L, boxes] bool: which boxes of the tree hold each leaf (the leaf's own and its ancestors')."""
    levels = TC.cone_tree_levels(geom.shape[0])
    nleaf = geom.shape[0] // TC.CONE_LEAF
    out = torch.zeros((nleaf, tree.shape[1]), dtype=torch.bool)
    box = torch.arange(nleaf)
    for f, _ in levels[::-1]:
        out[torch.arange(nleaf), f + box] = True
        box = box // TC.CONE_WIDE
    return out


@pytest.mark.parametrize("seed,scale,shift", [(0, 1.0, 0.0), (1, 100.0, 0.0), (3, 0.01, 5.0), (2, 1.0, 300.0)])
def test_rays_at_cone_box_faces_lose_no_hit(seed, scale, shift):
    """ROADMAP C.2 on the cone tree: the closed form can put a hit just
    outside its cone's own box, its leaf's or a node's box. With the port's
    box test (ops/slab.py) the walks lose none: K7's walk ends at the dense
    sweep's t on every lane, K8's finds every occluded lane, every occluded
    lane's hit lies in a leaf whose box and every ancestor's its interval
    enters, and every hit in its cone's own box.
    The reference's exact test loses some of these hits."""
    geom, tree, o, d, tmin, tmax = _grazing_scene(seed, scale, shift)
    assert len(TC.cone_tree_levels(geom.shape[0])) == 2
    walk = TC.cone_tree_walk(geom, tree, o, d, tmin, tmax)
    t_p, c_p, _ = TC.intersect_curves_closest_plain(geom, o, d, tmin, tmax)
    assert torch.equal(walk.t.view(torch.int32), t_p.view(torch.int32))
    occ = TC.cone_tree_walk(geom, tree, o, d, tmin, tmax, any_hit=True).t < TC.MISS_T
    assert torch.equal(occ, TC.intersect_curves_any_plain(geom, o, d, tmin, tmax))
    a, b, ra, rb = TC._geom_columns(geom[None])
    _, _, hit = TC.ray_round_cone([c[:, None] for c in o], [c[:, None] for c in d], a, b, ra, rb, tmin[:, None],
                                  tmax[:, None])
    hit = hit & (ra >= 0.0)
    holds = _ancestors(geom, tree)

    def seen(**margin):
        entered = slab.slab_tnear(o, d, tmin, tmax, tree, **margin) < INF  # [N, boxes]
        leaf_ok = (entered[:, None, :] | ~holds[None]).all(dim=2)  # [N, leaves]: the leaf and its ancestors entered
        return (hit & leaf_ok.repeat_interleave(TC.CONE_LEAF, dim=1)).any(dim=1)

    assert torch.equal(seen(), hit.any(dim=1)) and int((c_p >= 0).sum()) > 1900
    own = TC.cone_boxes(geom)
    assert not (hit & (slab.slab_tnear(o, d, tmin, tmax, own) == INF)).any()  # every hit in its cone's own box
    # the same rays against the exact boxes: the winner's leaf box, at the final t
    exact = slab.slab_tnear(o, d, tmin, torch.minimum(t_p, tmax), tree, pad=0.0, slack=0.0) < INF
    won = c_p >= 0
    leaf0 = TC.cone_tree_levels(geom.shape[0])[-1][0]
    lost = ~exact[won, leaf0 + (c_p[won] // TC.CONE_LEAF).long()]
    assert int(lost.sum()) > 0
