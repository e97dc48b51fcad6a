"""The any-hit walks on the port's box test, on the CPU.

K6 itself runs only on the card (chip_smoke.py holds it there against its
plain twin and against K3 `cull=False`). Here the two walks of the port's
box test are held: K6's plain twin, the near-to-far walk
`ops/bvh.py:intersect_bvh_ordered_plain(any_hit=True)` (what
`kernels/bvh.py:bvh_any` takes on CPU tensors; tests/test_torch_bvh_any_walk.py
holds it further), and the reference's DFS walk with the margin,
`intersect_bvh_plain(margin=True)` (K6's former walk, and the yardstick
of its bound):

- against the dense any-hit (K3 `cull=False`'s plain version over the same
  triangles) on every lane of two grazing soups (`scene/grazing.py`: rays at
  the shared vertices and edges of a coplanar grid and at coplanar
  overlaps), under both ray masks;
- against the same on coplanar grids turned, scaled and moved at random (a
  property test): every lane whose hits include one inside the box test's
  domain (a normalised determinant of `ops/slab.py:NU_MIN` or more) is
  equal; the lanes outside it are counted;
- against the reference's exact walk (the default of `intersect_bvh_plain`,
  which tests/test_torch_bvh.py holds against JAX's `intersect_bvh`): the
  padded boxes hold the exact ones, so every lane that walk finds occluded
  is occluded here too; on one grazing soup the exact walk loses occluded
  lanes that the dense any-hit and the margin keep (the fault the port's box
  test repairs in K6).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from hypothesis import given, note, settings
from hypothesis import strategies as st

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import bvh as KB
from strelka_tpu_torch.kernels import intersect as KI
from strelka_tpu_torch.ops import bvh as TB
from strelka_tpu_torch.ops import slab
from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW, build_device_scene
from strelka_tpu_torch.scene import grazing as G
from strelka_tpu_torch.scene import testscenes as TTS

MASKS = {"primary": RAY_MASK_PRIMARY, "shadow": RAY_MASK_SHADOW}


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _rays(rays, perm=None):
    """numpy (o, d, tmin, tmax, exclude) -> tensors; exclude ids mapped to a BVH's leaf order by `perm`."""
    o, d, tmin, tmax, exclude = rays
    if perm is not None:
        inv = np.argsort(perm)
        exclude = np.where(exclude >= 0, inv[np.clip(exclude, 0, len(perm) - 1)], -1).astype(np.int32)
    return (tuple(_t(o[:, k]) for k in range(3)), tuple(_t(d[:, k]) for k in range(3)), _t(tmin), _t(tmax),
            _t(exclude))


def _case(tris, rays):
    """The same triangles and rays twice: K3's arguments over the scene's
    order and K6's over a BVH of them in its leaf order."""
    v0, e1, e2, mask = tris
    threaded, perm, _ = TB.build_threaded(v0, e1, e2)
    flat = _rays(rays) + tuple(_t(a) for a in tris)
    tree = _rays(rays, perm) + (TB.device_bvh(threaded, "cpu"),) + tuple(_t(a[perm]) for a in tris)
    return flat, tree


def _outside_domain(flat, ray_mask):
    """Lanes that have hits, every one of them at a normalised determinant below NU_MIN."""
    o, d, tmin, tmax, exclude, v0, e1, e2, mask = flat
    hit = KI._valid(KI.mt_block(o, d, v0, e1, e2, tmin, tmax)[3], mask, ray_mask, 0, exclude)
    inside = hit & (slab.normalised_det(d, e1, e2) >= slab.NU_MIN)
    return hit.any(dim=1) & ~inside.any(dim=1)


@pytest.mark.parametrize("seed", [2, 4])
@pytest.mark.parametrize("mask", sorted(MASKS))
def test_no_lane_of_the_grazing_soup_differs_from_the_dense_any_hit(mask, seed):
    flat, tree = _case(*G.soup_case("grazing", seed))
    ray_mask = MASKS[mask]
    K.reset_counts()
    occ = KB.bvh_any(*tree, ray_mask)
    assert K.launch_counts["bvh_any"] == 0 and not any(K.plain_cuda_calls.values())
    dense = KI.intersect_any(*flat, ray_mask, cull=False)
    assert int(dense.sum()) > 200
    assert torch.equal(occ, dense)
    assert torch.equal(TB.intersect_bvh_plain(*tree, ray_mask, any_hit=True, margin=True)[1] >= 0, dense)


def test_the_exact_walk_loses_grazing_occlusion_that_the_margin_keeps():
    """The fault the port's box test repairs in K6: on this soup the
    reference's exact slab test culls the leaf of a hit that Möller-Trumbore
    puts just outside its box, and the ray's only hits go with it."""
    flat, tree = _case(*G.soup_case("grazing", 4))
    dense = KI.intersect_any(*flat, RAY_MASK_PRIMARY, cull=False)
    exact = TB.intersect_bvh_plain(*tree, RAY_MASK_PRIMARY, any_hit=True)[1] >= 0
    margin = TB.intersect_bvh_plain(*tree, RAY_MASK_PRIMARY, any_hit=True, margin=True)[1] >= 0
    assert not (exact & ~dense).any() and torch.equal(margin, dense)
    assert int((dense & ~exact).sum()) >= 1


@settings(derandomize=True, max_examples=8, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 16), log_scale=st.floats(-2.0, 3.0), log_offset=st.floats(-1.0, 3.0),
       nx=st.integers(2, 10), nz=st.integers(2, 10), overlap=st.booleans(),
       sin_min=st.sampled_from([slab.NU_MIN, slab.NU_MIN / 4, 1e-3, 1e-5]))
def test_margin_walk_on_coplanar_grids_at_any_pose(seed, log_scale, log_offset, nx, nz, overlap, sin_min):
    """scene/grazing.py:plane_case on its BVH: K6's plain twin equals the
    dense any-hit on every lane with a hit inside the box test's domain;
    the lanes outside it are counted."""
    flat, tree = _case(*G.plane_case(seed, 10.0 ** log_scale, 10.0 ** log_offset, nx, nz, overlap, sin_min))
    dense = KI.intersect_any(*flat, RAY_MASK_PRIMARY, cull=False)
    outside = _outside_domain(flat, RAY_MASK_PRIMARY)
    for occ in (KB.bvh_any(*tree, RAY_MASK_PRIMARY),
                TB.intersect_bvh_plain(*tree, RAY_MASK_PRIMARY, any_hit=True, margin=True)[1] >= 0):
        off = occ != dense
        assert not (off & ~outside).any()
        assert not (occ & ~dense).any()  # a walk tests the same triangles: it can lose a hit, never make one
        note(f"{int(outside.sum())} lanes outside the domain, {int(off.sum())} differ")


@pytest.mark.parametrize("soup", ["grazing-2", "coplanar-2", "dups-1", "random-3", "box_field"])
def test_margin_walk_holds_every_lane_the_exact_walk_finds_occluded(soup):
    if soup == "box_field":
        scene = build_device_scene(TTS.box_field(grid=4), device="cpu")
        ntri = scene.num_triangles
        centroid = (scene.v0 + (scene.e1 + scene.e2) / 3.0)[:ntri].numpy()
        rays = G.aimed_rays(600, 8, centroid.astype(np.float32), ntri)
        o, d, tmin, tmax, exclude = _rays(rays)
        tree = (o, d, tmin, tmax, exclude, scene.bvh, scene.v0, scene.e1, scene.e2, scene.geom_mask)
    else:
        kind, seed = soup.split("-")
        tree = _case(*G.soup_case(kind, int(seed)))[1]
    for ray_mask in MASKS.values():
        exact = TB.intersect_bvh_plain(*tree, ray_mask, any_hit=True)[1] >= 0
        assert int(exact.sum()) > 20
        dfs = TB.intersect_bvh_plain(*tree, ray_mask, any_hit=True, margin=True)[1] >= 0
        for occ in (KB.bvh_any(*tree, ray_mask), dfs):
            assert not (exact & ~occ).any()
