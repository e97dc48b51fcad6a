"""Kernel K6's near-to-far any-hit walk over the child table, on the CPU.

K6 itself runs only on the card (chip_smoke.py holds it there against this
file's subject and against K3 `cull=False`); here its plain twin,
`ops/bvh.py:intersect_bvh_ordered_plain(any_hit=True)` (what
`kernels/bvh.py:bvh_any` takes on CPU tensors, `any_plain`), is held:

- against the reference's DFS walk with the margin
  (`intersect_bvh_plain(margin=True)`, K6's walk before and its bound's
  yardstick) and the dense any-hit (K3 `cull=False`'s plain version) on
  every lane of two grazing soups, under both ray masks;
- against the dense any-hit on coplanar grids turned, scaled and moved at
  random (a property test): equal on every lane with a hit inside the box
  test's domain;
- against the JAX package's `intersect_bvh(any_hit=True)` on a tree carried
  across from it, on ordinary rays;
- on a tree that is one leaf, and on a tree deeper than the stack, which the
  wrapper refuses;
- its per-ray counters (child boxes, two a row fetched, and triangles tested
  up to the first hit) against a loop over the rays that walks one at a time;
- the 48-byte triangle rows K6 reads, made by its wrapper from a scene's
  leaf-ordered triangles and kept while those are unchanged.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, note, settings
from hypothesis import strategies as st

import test_torch_bvh as TBV
import test_torch_bvh_any as TBA
import test_torch_bvh_ordered as TBO
from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import bvh as KB
from strelka_tpu_torch.kernels import intersect as KI
from strelka_tpu_torch.ops import bvh as TB
from strelka_tpu_torch.ops import slab
from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW
from strelka_tpu_torch.scene import grazing as G

INF = float("inf")


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("mask", sorted(TBA.MASKS))
def test_grazing_soup_occlusion_equals_the_dfs_walk_and_the_dense_any_hit(mask, seed):
    flat, tree = TBA._case(*G.soup_case("grazing", seed))
    ray_mask = TBA.MASKS[mask]
    K.reset_counts()
    occ = KB.bvh_any(*tree, ray_mask)
    assert K.launch_counts["bvh_any"] == 0 and not any(K.plain_cuda_calls.values())
    dfs = TB.intersect_bvh_plain(*tree, ray_mask, any_hit=True, margin=True)[1] >= 0
    dense = KI.intersect_any(*flat, ray_mask, cull=False)
    assert int(dense.sum()) > 200
    assert torch.equal(occ, dfs) and torch.equal(occ, dense)


@settings(derandomize=True, max_examples=8, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 16), log_scale=st.floats(-2.0, 3.0), log_offset=st.floats(-1.0, 3.0),
       nx=st.integers(2, 10), nz=st.integers(2, 10), overlap=st.booleans(),
       sin_min=st.sampled_from([slab.NU_MIN, slab.NU_MIN / 4, 1e-3, 1e-5]))
def test_any_walk_on_coplanar_grids_at_any_pose(seed, log_scale, log_offset, nx, nz, overlap, sin_min):
    """scene/grazing.py:plane_case on its BVH (the generators of
    tests/test_torch_bvh_any.py): the twin equals the dense any-hit on
    every lane with a hit inside the box test's domain, and makes no hit."""
    flat, tree = TBA._case(*G.plane_case(seed, 10.0 ** log_scale, 10.0 ** log_offset, nx, nz, overlap, sin_min))
    occ = KB.bvh_any(*tree, RAY_MASK_PRIMARY)
    dense = KI.intersect_any(*flat, RAY_MASK_PRIMARY, cull=False)
    outside = TBA._outside_domain(flat, RAY_MASK_PRIMARY)
    off = occ != dense
    assert not (off & ~outside).any()
    assert not (occ & ~dense).any()
    note(f"{int(outside.sum())} lanes outside the domain, {int(off.sum())} differ")


@pytest.mark.parametrize("kind,seed", [("random", 61), ("box_field", 62)])
def test_any_walk_matches_jax_intersect_bvh(kind, seed):
    """A tree carried across from the JAX package, rays that aim at no edge:
    the same occlusion as JAX's intersect_bvh(any_hit=True) on every lane."""
    case = TBV._Case(kind, seed, 400)
    occ_r = np.asarray(case.jax(RAY_MASK_SHADOW, any_hit=True)[1]) >= 0
    occ = KB.any_plain(*case.torch_args(RAY_MASK_SHADOW)).numpy()
    assert 0 < occ_r.sum() < 400
    np.testing.assert_array_equal(occ, occ_r)


def test_one_leaf_tree():
    """A tree that is one leaf: one child row, the leaf on the left and an
    inverted box on the right; the walk tests the leaf's triangles only."""
    rng = np.random.default_rng(3)
    v0 = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (3, 3)).astype(np.float32)
    lo, hi = np.minimum.reduce([v0, v0 + e1, v0 + e2]).min(0), np.maximum.reduce([v0, v0 + e1, v0 + e2]).max(0)
    leaf = (lo[None], hi[None], np.array([1], np.int32), np.array([0], np.int32), np.array([3], np.int32))
    bvh = TB.device_bvh(leaf, "cpu")
    assert bvh.depth == 0 and bvh.children.shape == (1, TB.CHILD_COLS)
    n = 300
    target = v0[rng.integers(0, 3, n)] + rng.uniform(0, 0.5, (n, 1)) * e1[rng.integers(0, 3, n)]
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = np.where(rng.random((n, 1)) < 0.6, target - o, rng.normal(size=(n, 3)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t = lambda a: torch.tensor(np.ascontiguousarray(a))  # noqa: E731
    mask = np.array([1, 4, 1], np.int32)
    args = (tuple(t(o[:, k]) for k in range(3)), tuple(t(d[:, k]) for k in range(3)), t(np.zeros(n, np.float32)),
            t(np.full(n, 1e16, np.float32)), t(np.full(n, -1, np.int32)), bvh, t(v0), t(e1), t(e2), t(mask))
    for ray_mask in (RAY_MASK_PRIMARY, RAY_MASK_SHADOW):
        occ, cnt = KB.any_plain(*args, ray_mask, counts=True)
        dense = KI.any_plain(*args[:5], *args[6:], ray_mask)
        assert torch.equal(occ, dense) and 0 < int(occ.sum()) < n
        assert (cnt.nodes == 2).all()  # the root's row, its two boxes
        assert int(cnt.tris.max()) <= int(((mask & ray_mask) != 0).sum())


def test_a_tree_deeper_than_the_stack_is_refused():
    deep = TB.device_bvh(TBO._deep_tree(TB.STACK + 1), "cpu")
    KB._check_children(TB.device_bvh(TBO._deep_tree(TB.STACK), "cpu"), torch.zeros((4, 3)), torch.device("cpu"),
                       "bvh_any")
    with pytest.raises(ValueError, match="bvh_any.*deep"):
        KB._check_children(deep, torch.zeros((4, 3)), torch.device("cpu"), "bvh_any")
    with pytest.raises(ValueError, match="stats"):
        KB.bvh_any(*TBO._case("dups-1"), RAY_MASK_PRIMARY, stats=True)


def _walk_one_ray(args, ray_mask, i):
    """One ray's any-hit walk, written out -> (occluded, boxes tested, triangles tested)."""
    o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask = args
    tn, tx = tmin[i].reshape(1), tmax[i].reshape(1)
    if not float(tx) > float(tn):
        return False, 0, 0
    ray_o, ray_d = [c[i].reshape(1) for c in o], [c[i].reshape(1) for c in d]
    boxes = tris = 0
    stack, node = [], 0
    while True:
        if node & 7 == 0:
            row = bvh.children[node >> 3]
            f = row[0:12].view(torch.float32)
            box = torch.zeros((8, 1, 2))
            box[0:6, 0, 0], box[0:6, 0, 1] = f[0:6], f[6:12]
            tl, tr = (float(x) for x in slab.slab_tnear(ray_o, ray_d, tn, tx, box)[0])
            boxes += 2
            refs = int(row[12]), int(row[13])
            if tl < INF and tr < INF:
                near, far = (0, 1) if tl <= tr else (1, 0)
                stack.append(refs[far])
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
                hit = TB._tri_test(ray_o, ray_d, v0[prim:prim + 1], e1[prim:prim + 1], e2[prim:prim + 1], tn, tx)[3]
                if bool(hit[0]):
                    return True, boxes, tris
        if not stack:
            return False, boxes, tris
        node = stack.pop()


@pytest.mark.parametrize("case,mask", [("box_field", "shadow"), ("dups-1", "primary"), ("grazing-2", "shadow")])
def test_any_walk_counters_equal_a_loop_over_the_rays(case, mask):
    args = TBO._case(case)
    ray_mask = TBA.MASKS[mask]
    occ, cnt = KB.any_plain(*args, ray_mask, counts=True)
    n = args[2].shape[0]
    pushed = 0
    for i in range(0, n, max(1, n // 120)):
        want = _walk_one_ray(args, ray_mask, i)
        assert (bool(occ[i]), int(cnt.nodes[i]), int(cnt.tris[i])) == want, i
        pushed += want[1] > 2
    assert pushed > 10 and int(occ.sum()) > 20


def test_triangle_rows_of_a_scene_tree():
    """K6 reads the leaf-ordered triangles as 48-byte rows (kernels/bvh.py:
    triangle_rows), made from the tensors its wrapper is given: v0, e1, e2
    bit for bit, the geometry mask's bits in the tenth word, zeros after;
    the same table while those tensors are unchanged, a new one after an
    in-place write or for other tensors."""
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.scene import testscenes as TTS

    scene = build_device_scene(TTS.box_field(grid=4), device="cpu")
    tris = [scene.v0.clone(), scene.e1, scene.e2, scene.geom_mask]
    rows = KB.triangle_rows(*tris)
    assert rows.shape == (scene.v0.shape[0], KB.TRI_ROW_COLS) and rows.dtype == torch.float32
    for col, a in ((0, scene.v0), (3, scene.e1), (6, scene.e2)):
        assert torch.equal(rows[:, col:col + 3].view(torch.int32), a.view(torch.int32))
    assert torch.equal(rows[:, 9].view(torch.int32), scene.geom_mask) and not rows[:, 10:].any()
    assert KB.triangle_rows(*tris) is rows
    tris[0][0, 0] += 1.0
    moved = KB.triangle_rows(*tris)
    assert moved is not rows and moved[0, 0] == rows[0, 0] + 1.0
    assert torch.equal(moved[1:], rows[1:]) and KB.triangle_rows(*tris) is moved
    other = KB.triangle_rows(scene.v0.clone(), *tris[1:])
    assert other is not rows and torch.equal(other.view(torch.int32), rows.view(torch.int32))
