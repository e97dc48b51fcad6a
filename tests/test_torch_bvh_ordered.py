"""Kernel K5's near-to-far walk over the child table, on the CPU.

K5 itself runs only on the card (chip_smoke.py holds it there against this
file's subjects); here:

- the child table (`ops/bvh.py:child_rows`) is built from the packed
  threaded rows bit for bit, with the tree's depth, also for a one-leaf
  tree and a tree deeper than K5's stack (which the wrapper refuses);
- the plain walk (`intersect_bvh_ordered_plain`) equals a loop over the
  rays that walks one ray at a time (result and per-ray counters), and the
  dense plain sweep (K2 `cull=False`'s plain version) bit for bit in
  (t, prim, u, v) on box_field(grid=6), on the triangle soups of
  `scene/grazing.py` (duplicates, coplanar grids, overlaps, rays aimed at
  shared vertices and edges), and on coplanar grids turned and scaled at
  random (a property test, inside the box test's domain);
- on a tree that holds the triangles twice over in its two halves (every hit
  a tie, the higher ids met first) it still equals the dense sweep, and it
  equals the reference's DFS walk (`intersect_bvh_plain`, JAX's
  `intersect_bvh`) wherever that walk equals the dense sweep;
- it agrees with the JAX package's brute force on box_field(grid=6);
- CPU tensors take the plain walk, and the wrapper's checks raise.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, note, settings
from hypothesis import strategies as st

from strelka_tpu.ops import intersect as JX
from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import bvh as KB
from strelka_tpu_torch.kernels import intersect as KI
from strelka_tpu_torch.ops import bvh as TB
from strelka_tpu_torch.ops import slab
from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW, build_device_scene
from strelka_tpu_torch.scene import grazing as G
from strelka_tpu_torch.scene import testscenes as TTS

INF = float("inf")
MISS = float(np.float32(TB.MISS_T))


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


def _tree(tris):
    """A BVH over numpy triangles -> (DeviceBvh, the triangles in its leaf order as tensors)."""
    v0, e1, e2, mask = tris
    threaded, perm, _ = TB.build_threaded(v0, e1, e2)
    return TB.device_bvh(threaded, "cpu"), tuple(_t(a[perm]) for a in (v0, e1, e2, mask)), perm


def _rays(rays, perm=None):
    o, d, tmin, tmax, exclude = rays
    if perm is not None:  # exclude ids name triangles of the scene's order: map them to the leaf order
        inv = np.argsort(perm)
        exclude = np.where(exclude >= 0, inv[np.clip(exclude, 0, len(perm) - 1)], -1).astype(np.int32)
    return (tuple(_t(o[:, k]) for k in range(3)), tuple(_t(d[:, k]) for k in range(3)), _t(tmin), _t(tmax),
            _t(exclude))


def _box_field_case(seed=3, n=600, aimed=0.7):
    """box_field(grid=6) on its BVH and rays from above the field, a share
    `aimed` of them at its triangles' vertices and edge midpoints (shared by
    neighbours), with dead lanes, tmin > 0 and exclude ids."""
    scene = build_device_scene(TTS.box_field(grid=6), device="cpu")
    rng = np.random.default_rng(seed)
    ntri = scene.num_triangles
    v0, e1 = scene.v0[:ntri].numpy(), scene.e1[:ntri].numpy()
    pick = rng.integers(0, ntri, n)
    target = np.where(rng.random((n, 1)) < 0.5, v0[pick], v0[pick] + np.float32(0.5) * e1[pick])
    o = rng.uniform([-6, 0.5, -6], [6, 6, 6], (n, 3)).astype(np.float32)
    d = np.where(rng.random((n, 1)) < aimed, target - o, rng.normal(size=(n, 3)) - np.array([0.0, 0.6, 0.0]))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmin = np.where(np.arange(n) % 5 == 2, 1e-3, 0.0).astype(np.float32)
    tmax = rng.choice([1e16, 3.0, 9.0], n).astype(np.float32)
    tmax[::9] = 0.0
    exclude = np.where(rng.random(n) < 0.3, rng.integers(0, ntri, n), -1).astype(np.int32)
    rays = _rays((o, d, tmin, tmax, exclude))
    return rays + (scene.bvh, scene.v0, scene.e1, scene.e2, scene.geom_mask)


def _soup_case(kind, seed):
    tris, rays = G.soup_case(kind, seed)
    bvh, leaf_tris, perm = _tree(tris)
    return _rays(rays, perm) + (bvh,) + leaf_tris


def _case(name):
    if name == "box_field":
        return _box_field_case()
    kind, seed = name.split("-")
    return _soup_case(kind, int(seed))


def _dense(args, ray_mask):
    o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask = args
    return KI.closest_plain(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask)


CASES = ["box_field", "dups-1", "coplanar-2", "grazing-2", "random-3"]


def test_child_table_is_built_from_the_packed_rows():
    scene = build_device_scene(TTS.box_field(grid=6), device="cpu")
    rows = scene.bvh.nodes.numpy()
    table, depth = TB.child_rows(rows)
    assert torch.equal(scene.bvh.children, _t(table)) and scene.bvh.depth == depth
    count = rows[:, 7] & 7
    internal = np.nonzero(count == 0)[0]
    assert table.shape == (internal.shape[0], TB.CHILD_COLS) and table.shape[0] == (rows.shape[0] - 1) // 2
    row_of = {int(i): r for r, i in enumerate(internal)}
    want_depth = {0: 0}
    for r, i in enumerate(internal.tolist()):
        left, right = i + 1, int(rows[i + 1, 6])
        for col, child in ((0, left), (6, right)):
            assert (table[r, col:col + 6] == rows[child, 0:6]).all()
        for col, child in ((12, left), (13, right)):
            want = row_of[child] << 3 if count[child] == 0 else rows[child, 7]
            assert table[r, col] == want
            want_depth[child] = want_depth[i] + 1
        scales = table[r, 14:16].view(np.float32)
        assert scales[0] == np.abs(rows[left, 0:6].view(np.float32)).max()
        assert scales[1] == np.abs(rows[right, 0:6].view(np.float32)).max()
    assert depth == max(want_depth.values()) and 4 < depth <= TB.STACK
    # a tree that is one leaf: the leaf on the left, an inverted box on the right
    leaf = (rows[:1, 0:3].view(np.float32), rows[:1, 3:6].view(np.float32), np.array([1], np.int32),
            np.array([0], np.int32), np.array([2], np.int32))
    one = TB.device_bvh(leaf, "cpu")
    assert one.depth == 0 and one.children.shape == (1, TB.CHILD_COLS)
    assert one.children[0, 12] == (0 << 3 | 2) and one.children[0, 6] > one.children[0, 9]


def _deep_tree(levels):
    """A caterpillar: every internal node has a leaf on the left and the rest
    of the tree on the right -> ThreadedBvh arrays with `levels` internal nodes."""
    n = 2 * levels + 1
    bb_min = np.zeros((n, 3), np.float32)
    bb_max = np.ones((n, 3), np.float32)
    skip = np.zeros(n, np.int32)
    start = np.zeros(n, np.int32)
    count = np.zeros(n, np.int32)
    for k in range(levels):
        i = 2 * k  # internal node k; its leaf is i + 1, the next internal node i + 2
        skip[i] = n
        skip[i + 1] = i + 2
        start[i + 1], count[i + 1] = k, 1
    start[n - 1], count[n - 1], skip[n - 1] = levels, 1, n
    return bb_min, bb_max, skip, start, count


def test_a_tree_deeper_than_the_stack_is_refused():
    ok = TB.device_bvh(_deep_tree(TB.STACK), "cpu")
    deep = TB.device_bvh(_deep_tree(TB.STACK + 1), "cpu")
    assert ok.depth == TB.STACK and deep.depth == TB.STACK + 1
    KB.check_stack(ok)
    with pytest.raises(ValueError, match="deep"):
        KB.check_stack(deep)
    with pytest.raises(ValueError, match="deep"):
        KB._check_children(deep, torch.zeros((4, 3)), torch.device("cpu"))


def _walk_one_ray(args, ray_mask, i):
    """One ray's near-to-far walk, written out -> (t, prim, u, v, boxes tested, triangles tested)."""
    o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask = args
    tn, tx = tmin[i].reshape(1), tmax[i].reshape(1)
    if not float(tx) > float(tn):
        return MISS, -1, 0.0, 0.0, 0, 0
    ray_o, ray_d = [c[i].reshape(1) for c in o], [c[i].reshape(1) for c in d]
    table = bvh.children
    best_t, best_p, best_u, best_v = tx.clone(), -1, torch.zeros(1), torch.zeros(1)
    boxes = tris = 0
    stack, node = [], 0
    while True:
        if node & 7 == 0:
            row = table[node >> 3]
            f = row[0:12].view(torch.float32)
            box = torch.zeros((8, 1, 2))
            box[0:6, 0, 0], box[0:6, 0, 1] = f[0:6], f[6:12]
            tl, tr = (float(x) for x in slab.slab_tnear(ray_o, ray_d, tn, best_t, box)[0])
            boxes += 2
            refs = int(row[12]), int(row[13])
            if tl < INF and tr < INF:
                near, far = (0, 1) if tl <= tr else (1, 0)
                stack.append((refs[far], (tl, tr)[far]))
                node = refs[near]
                continue
            if tl < INF or tr < INF:
                node = refs[0] if tl < INF else refs[1]
                continue
        else:
            start, cnt = node >> 3, node & 7
            for prim in range(start, start + cnt):
                if not int(mask[prim]) & ray_mask or prim == int(exclude[i]):
                    continue
                tris += 1
                t, u, v, hit = TB._tri_test(ray_o, ray_d, v0[prim:prim + 1], e1[prim:prim + 1], e2[prim:prim + 1],
                                            tn, tx)
                if bool(hit[0]) and (float(t) < float(best_t) or (float(t) == float(best_t) and prim < best_p)):
                    best_t, best_p, best_u, best_v = t, prim, u, v
        while stack:
            ref, tnear = stack.pop()
            if not tnear > float(best_t):
                node = ref
                break
        else:
            break
    t_out = float(best_t) if best_p >= 0 else MISS
    return t_out, best_p, float(best_u), float(best_v), boxes, tris


@pytest.mark.parametrize("case", ["box_field", "dups-1", "grazing-2"])
def test_ordered_walk_equals_a_loop_over_the_rays(case):
    args = _case(case)
    t, p, u, v, cnt = TB.intersect_bvh_ordered_plain(*args, RAY_MASK_PRIMARY, counts=True)
    n = args[2].shape[0]
    pushed = 0
    for i in range(0, n, max(1, n // 120)):
        want = _walk_one_ray(args, RAY_MASK_PRIMARY, i)
        got = (float(t[i]), int(p[i]), float(u[i]), float(v[i]), int(cnt.nodes[i]), int(cnt.tris[i]))
        assert got == want, i
        pushed += want[4] > 2
    assert pushed > 10 and int(cnt.nodes.max()) > 6


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mask", ["primary", "shadow"])
def test_ordered_walk_equals_the_dense_sweep(case, mask):
    args = _case(case)
    ray_mask = RAY_MASK_PRIMARY if mask == "primary" else RAY_MASK_SHADOW
    walk = TB.intersect_bvh_ordered_plain(*args, ray_mask)
    dense = _dense(args, ray_mask)
    for a, b in zip(walk, dense):
        assert torch.equal(_bits(a), _bits(b))
    assert int((dense[1] >= 0).sum()) > 20


def test_twin_tree_ties_go_to_the_lowest_id():
    """The triangles twice over, the copies (higher ids) in the half the walk
    meets first: every hit is a tie, the walk equals the dense sweep (the
    lower id), and the reference's DFS walk, which keeps the first hit of
    equal t, differs from both on exactly the lanes that hit."""
    tris, rays = G.soup_case("dups", 1)
    threaded, perm, _ = TB.build_threaded(*tris[:3])
    ntri = perm.shape[0]
    twin = TB.device_bvh(G.twin_tree(threaded, ntri), "cpu")
    leaf = [np.concatenate([a[perm], a[perm]]) for a in tris]
    o, d, tmin, tmax, _ = _rays(rays)
    args = (o, d, tmin, tmax, None, twin) + tuple(_t(a) for a in leaf)
    assert twin.depth == TB.device_bvh(threaded, "cpu").depth + 1
    assert torch.equal(twin.children[0, 0:6], twin.children[0, 6:12])  # the root's two halves: equal boxes
    walk = TB.intersect_bvh_ordered_plain(*args, RAY_MASK_PRIMARY)
    dense = _dense(args, RAY_MASK_PRIMARY)
    for a, b in zip(walk, dense):
        assert torch.equal(_bits(a), _bits(b))
    hits = dense[1] >= 0
    assert int(hits.sum()) > 50 and (dense[1][hits] < ntri).all()
    ref = TB.intersect_bvh_plain(*args, RAY_MASK_PRIMARY)
    assert torch.equal(ref[1][hits], dense[1][hits] + ntri)  # the DFS walk keeps the copy it met first
    same = (ref[1] == dense[1]) & (_bits(ref[0]) == _bits(dense[0]))
    assert torch.equal(walk[1][same], ref[1][same]) and torch.equal(_bits(walk[0][same]), _bits(ref[0][same]))


@pytest.mark.parametrize("case", ["box_field", "grazing-2"])
def test_ordered_walk_differs_from_the_dfs_walk_only_where_that_walk_loses_the_dense_hit(case):
    args = _case(case)
    walk = TB.intersect_bvh_ordered_plain(*args, RAY_MASK_PRIMARY)
    ref = TB.intersect_bvh_plain(*args, RAY_MASK_PRIMARY)
    dense = _dense(args, RAY_MASK_PRIMARY)
    ref_off = (ref[1] != dense[1]) | (_bits(ref[0]) != _bits(dense[0]))
    walk_off = (walk[1] != ref[1]) | (_bits(walk[0]) != _bits(ref[0]))
    assert not (walk_off & ~ref_off).any()


def test_ordered_walk_agrees_with_the_jax_brute_force():
    """JAX's intersect_closest_bruteforce on the same rays (none aimed at an
    edge, where XLA's FMA contraction can flip Möller-Trumbore's edge test,
    ROADMAP C) and the BVH's leaf-ordered triangles: hit or miss equal on
    every lane, prims equal but for ties, t within that contraction."""
    import jax.numpy as jnp

    o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask = _box_field_case(seed=5, aimed=0.0)
    t, p, _, _ = KB.bvh_closest(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, RAY_MASK_PRIMARY)

    class Shim:
        pass

    shim = Shim()
    shim.v0, shim.e1, shim.e2, shim.geom_mask = (jnp.asarray(a.numpy()) for a in (v0, e1, e2, mask))
    shim.bvh = None
    ref = JX.intersect_closest_bruteforce(shim, jnp.asarray(torch.stack(o, 1).numpy()),
                                          jnp.asarray(torch.stack(d, 1).numpy()), jnp.asarray(tmin.numpy()),
                                          jnp.asarray(tmax.numpy()), RAY_MASK_PRIMARY,
                                          exclude=jnp.asarray(exclude.numpy()))
    p_r, t_r = np.asarray(ref.prim), np.asarray(ref.t)
    p, t = p.numpy(), t.numpy()
    np.testing.assert_array_equal(p >= 0, p_r >= 0)
    hits = p >= 0
    assert hits.sum() > 100
    # the contraction moves t by a few ulps of the products it fuses: relative to t, and absolute near t = 0
    np.testing.assert_allclose(t[hits], t_r[hits], rtol=1e-5, atol=1e-6)
    differ = hits & (p != p_r)
    assert not (differ & (np.abs(t - t_r) > 1e-5 * np.abs(t_r) + 1e-6)).any()


@settings(derandomize=True, max_examples=8, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 16), log_scale=st.floats(-2.0, 3.0), log_offset=st.floats(-1.0, 3.0),
       nx=st.integers(2, 10), nz=st.integers(2, 10), overlap=st.booleans(),
       sin_min=st.sampled_from([slab.NU_MIN, slab.NU_MIN / 4, 1e-3, 1e-5]))
def test_ordered_walk_on_coplanar_grids_at_any_pose(seed, log_scale, log_offset, nx, nz, overlap, sin_min):
    """scene/grazing.py:plane_case on its BVH: the walk equals the dense
    sweep on every lane whose dense hit lies inside the box test's domain
    (normalised determinant >= NU_MIN); lanes outside it are counted."""
    tris, rays = G.plane_case(seed, 10.0 ** log_scale, 10.0 ** log_offset, nx, nz, overlap, sin_min)
    bvh, leaf, perm = _tree(tris)
    args = _rays(rays) + (bvh,) + leaf
    walk = TB.intersect_bvh_ordered_plain(*args, RAY_MASK_PRIMARY)
    dense = _dense(args, RAY_MASK_PRIMARY)
    off = (walk[1] != dense[1]) | (_bits(walk[0]) != _bits(dense[0]))
    won = dense[1] >= 0
    nu = slab.normalised_det(args[1], leaf[1], leaf[2])
    nu_won = torch.where(won, nu.gather(1, dense[1].clamp(min=0).long()[:, None])[:, 0], 1.0)
    assert not (off & (nu_won >= slab.NU_MIN)).any()
    note(f"{int((won & (nu_won < slab.NU_MIN)).sum())} lanes hit outside the domain, {int(off.sum())} differ")


def test_cpu_wrapper_takes_the_ordered_plain_walk():
    args = _case("dups-1")
    K.reset_counts()
    out = KB.bvh_closest(*args, RAY_MASK_PRIMARY)
    walk = TB.intersect_bvh_ordered_plain(*args, RAY_MASK_PRIMARY)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(out, walk))
    assert K.launch_counts["bvh_closest"] == 0 and not any(K.plain_cuda_calls.values())
    with pytest.raises(ValueError, match="stats"):
        KB.bvh_closest(*args, RAY_MASK_PRIMARY, stats=True)
    with pytest.raises(ValueError, match="children"):
        KB._check_children(TB.DeviceBvh(nodes=args[5].nodes), args[6], torch.device("cpu"))
