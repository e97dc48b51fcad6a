"""The 32-triangle groups that kernels K2/K3 cull by, and their walks, on the CPU.

The kernels themselves run only on the card (chip_smoke.py holds them
against the dense plain versions, their cull=False mode and the plain
walks there); here:

- the port's group boxes (`kernels/intersect.py:tri_group_bounds`,
  `DeviceScene.tri_bounds`) equal the JAX package's `block_bounds(...,
  tblk=32, super_=1)` bit for bit, on Cornell's tables and on a random soup
  with padding and mask-0 triangles;
- the plain copies of the walks of one ray a warp (`closest_walk_plain`,
  `any_walk_plain`) give the dense plain versions' (t, prim, u, v) bit for
  bit and their occlusion, on random soups with duplicate and coplanar
  triangles (ties go to the lowest id) and on Cornell's 32x32 camera and
  bounce-1 rays, and on rays aimed exactly at the shared vertices and
  edges of a coplanar grid and at coplanar overlaps, where the reference's
  exact box test drops hits that Möller-Trumbore accepts just outside their
  group's box and the port's margin (ops/slab.py) keeps them; a property
  test turns, scales and moves such grids at random and aims rays down to
  the edge of the margin's domain: no lane inside it differs;
- their per-ray counts of groups tested equal a loop over the rays, and no
  group the closest walk skipped holds a triangle that beats its final hit;
- CPU tensors take the dense plain versions whatever the schedule or cull,
  and the wrappers' checks raise where they should.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch
from hypothesis import given, note, settings
from hypothesis import strategies as st

from strelka_tpu.ops.pallas_intersect import block_bounds
from strelka_tpu.render.device_scene import build_device_scene as jax_build
from strelka_tpu.scene import testscenes as JTS
from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import intersect as KI
from strelka_tpu_torch.ops import slab
from strelka_tpu_torch.ops.slab import slab_tnear
from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW, build_device_scene
from strelka_tpu_torch.scene import grazing as G
from strelka_tpu_torch.scene import testscenes as TTS

INF = float("inf")
MASKS = {"primary": RAY_MASK_PRIMARY, "shadow": RAY_MASK_SHADOW}


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def _soup(kind: str, seed: int):
    """A soup of 300 triangles (scene/grazing.py:soup) as numpy arrays."""
    return G.soup(kind, seed)


def _args(tris, rays):
    """numpy (v0, e1, e2, mask) and (o, d, tmin, tmax, exclude) -> the walks' arguments."""
    o, d, tmin, tmax, exclude = rays
    return (tuple(_t(o[:, k]) for k in range(3)), tuple(_t(d[:, k]) for k in range(3)), _t(tmin), _t(tmax),
            _t(exclude)) + tuple(_t(a) for a in tris)


def _soup_case(kind: str, seed: int):
    """A soup and 400 rays at its triangles' centroids ("grazing": the
    "overlap" soup and rays at its grid's vertices, edge midpoints and
    centroids), scene/grazing.py:soup_case."""
    tris, rays = G.soup_case(kind, seed)
    return _args(tris, rays), _t(KI.tri_group_bounds(*tris))


def _cornell_case(kind: str):
    """Cornell's 32x32 camera or bounce-1 rays at 1 spp, as the main path makes them."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as CS

    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # torch's first-call CPU sqrt fault (ROADMAP C) under several threads
    try:
        host = TTS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True)
        scene = build_device_scene(host, device="cpu")
        cfg = CS.Config("cornell", 32, 32, 1, 4, 1, ())
        _, camera, bounce1, *_ = CS.main_path_rays(scene, CS.launch_params(host, 32, 32, 0), torch.device("cpu"), cfg)
    finally:
        torch.set_num_threads(threads)
    rays = camera if kind == "camera" else bounce1
    o, d = (tuple(c.contiguous() for c in rays[k]) for k in ("o", "d"))
    args = (o, d, rays["tmin"].contiguous(), rays["tmax"].contiguous(), rays["exclude"].contiguous(), scene.v0,
            scene.e1, scene.e2, scene.geom_mask)
    return args, scene.tri_bounds


def _case(name: str):
    if name.startswith("cornell"):
        return _cornell_case(name.split("-")[1])
    kind, seed = name.split("-")
    return _soup_case(kind, int(seed))


CASES = ["dups-1", "coplanar-2", "random-3", "cornell-camera", "cornell-bounce1"]


def _bits(a):
    return a.view(torch.int32) if a.dtype == torch.float32 else a


@pytest.mark.parametrize("source", ["cornell", "soup"])
def test_tri_bounds_equal_block_bounds(source):
    if source == "cornell":
        host = JTS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True)
        jds = jax_build(host)
        arrays = [np.asarray(a) for a in (jds.v0, jds.e1, jds.e2, jds.geom_mask)]
        ds = build_device_scene(TTS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True),
                                device="cpu")
        assert ds.bvh is None and ds.tri_bounds.shape == (8, 20)
        np.testing.assert_array_equal(ds.tri_bounds.numpy().view(np.int32),
                                      KI.tri_group_bounds(*arrays).view(np.int32))
    else:
        v0, e1, e2, mask = _soup("random", 5)
        mask[64:96] = 0  # a group of mask-0 triangles
        arrays = [v0[:290], e1[:290], e2[:290], mask[:290]]  # 290: the last group is padded
    ours = KI.tri_group_bounds(*arrays)
    ref = np.asarray(block_bounds(*arrays, tblk=KI.GROUP, super_=1))
    np.testing.assert_array_equal(ours.view(np.int32), ref.view(np.int32))
    inverted = ours[0] > ours[3]
    assert inverted.any() and (ours[0:3, inverted] == np.float32(1e30)).all()


def test_bvh_scenes_have_no_group_boxes():
    assert build_device_scene(TTS.box_field(grid=3), device="cpu").tri_bounds is None
    assert build_device_scene(TTS.box_field(grid=3), device="cpu", use_bvh=False).tri_bounds.shape[0] == 8


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("mask", ["primary", "shadow"])
def test_walks_equal_the_dense_plain_versions(case, mask):
    args, bounds = _case(case)
    ray_mask = MASKS[mask]
    dense = KI.closest_plain(*args, ray_mask)
    walk = KI.closest_walk_plain(*args, ray_mask, bounds)
    for a, b in zip(walk[:4], dense):
        assert torch.equal(_bits(a), _bits(b))
    assert int((dense[1] >= 0).sum()) > 20
    occ, groups, tris, touched = KI.any_walk_plain(*args, ray_mask, bounds)
    assert torch.equal(occ, KI.any_plain(*args, ray_mask))
    live = args[3] > args[2]
    assert (walk[4][~live] == 0).all() and (groups[~live] == 0).all()
    assert (walk[4] <= bounds.shape[1]).all() and (groups <= bounds.shape[1]).all()
    assert bool(touched.any()) and (tris[groups == 0] == 0).all()


def test_ties_go_to_the_lowest_id():
    """The "dups" soup holds 24 triangles three times over, in three groups:
    a ray that hits one hits its copies at equal t, and the walk's winner is
    the lowest id of the triangles hit at its t, whichever group it took
    first."""
    args, bounds = _case("dups-1")
    o, d, tmin, tmax, exclude, v0, e1, e2, mask = args
    t_w, p_w, *_ = KI.closest_walk_plain(*args, RAY_MASK_PRIMARY, bounds)
    t, _, _, hit = KI.mt_block(o, d, v0, e1, e2, tmin, tmax)
    hit = KI._valid(hit, mask, RAY_MASK_PRIMARY, 0, exclude)
    tied = hit & (t == t_w[:, None])
    lanes = tied.sum(dim=1) > 1
    assert int(lanes.sum()) > 10
    assert torch.equal(p_w[lanes].long(), torch.argmax(tied.to(torch.int8), dim=1)[lanes])


@pytest.mark.parametrize("mask", ["primary", "shadow"])
def test_no_lane_of_the_grazing_soup_differs_from_the_dense_versions(mask):
    """Rays aimed exactly at the shared vertices and edges of a coplanar
    grid, and at coplanar triangles that overlap in other groups (equal t),
    find hits on the faces of zero-thickness group boxes that Möller-Trumbore
    accepts just outside the box, or at a t the box's exact slab test rounds
    below: the reference's exact test drops some of those groups (checked
    here). With the port's margin (ops/slab.py) both walks equal the dense
    versions on every lane: K2's (t, prim, u, v) bit for bit, K3's
    occlusion."""
    args, bounds = _case("grazing-2")
    o, d, tmin, tmax, exclude, v0, e1, e2, gmask = args
    ray_mask = MASKS[mask]
    dense = KI.closest_plain(*args, ray_mask)
    walk = KI.closest_walk_plain(*args, ray_mask, bounds)
    for a, b in zip(walk[:4], dense):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(KI.any_walk_plain(*args, ray_mask, bounds)[0], KI.any_plain(*args, ray_mask))
    t_d, p_d = dense[:2]
    exact = slab_tnear(o, d, tmin, torch.minimum(t_d, tmax), bounds, pad=0.0, slack=0.0) < INF
    winner_entered = exact.gather(1, (p_d.clamp(min=0).long() // KI.GROUP)[:, None])[:, 0]
    assert int(((p_d >= 0) & ~winner_entered).sum()) > 0


def _differ_outside_the_domain(args, bounds, ray_mask):
    """The walks against the dense versions on one case -> (lanes that
    differ whose hits lie outside the margin's domain, lanes whose dense
    hit lies outside it). Raises on a lane that differs with its hit inside:
    for K2 the dense winner's normalised determinant, for K3 the largest of
    the ray's hits'."""
    o, d, tmin, tmax, exclude, v0, e1, e2, mask = args
    dense = KI.closest_plain(*args, ray_mask)
    walk = KI.closest_walk_plain(*args, ray_mask, bounds)
    nu = slab.normalised_det(d, e1, e2)
    _, _, _, hit = KI.mt_block(o, d, v0, e1, e2, tmin, tmax)
    hit = KI._valid(hit, mask, ray_mask, 0, exclude)
    won = dense[1] >= 0
    nu_won = torch.where(won, nu.gather(1, dense[1].clamp(min=0).long()[:, None])[:, 0], 1.0)
    nu_any = torch.where(hit, nu, 0.0).max(dim=1).values
    off2 = (walk[1] != dense[1]) | (_bits(walk[0]) != _bits(dense[0]))
    off3 = KI.any_walk_plain(*args, ray_mask, bounds)[0] != KI.any_plain(*args, ray_mask)
    assert not (off2 & (nu_won >= slab.NU_MIN)).any()
    assert not (off3 & (nu_any >= slab.NU_MIN)).any()
    return int((off2 | off3).sum()), int((won & (nu_won < slab.NU_MIN)).sum())


@settings(derandomize=True, max_examples=10, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 16), log_scale=st.floats(-2.0, 3.0), log_offset=st.floats(-1.0, 3.0),
       nx=st.integers(2, 8), nz=st.integers(2, 8), overlap=st.booleans(),
       sin_min=st.sampled_from([slab.NU_MIN, slab.NU_MIN / 4, 1e-3, 1e-5]))
def test_coplanar_grids_at_any_pose_lose_no_hit_inside_the_margins_domain(seed, log_scale, log_offset, nx, nz,
                                                                          overlap, sin_min):
    """A coplanar grid (and coplanar overlaps) turned, scaled and moved at
    random, rays at its vertices, edge points and overlaps at angles down to
    the edge of the margin's domain (a normalised determinant of NU_MIN) and
    past it: the walks equal the dense versions on every lane whose hits lie
    inside the domain; lanes outside it are counted (note) and may differ."""
    tris, rays = G.plane_case(seed, 10.0 ** log_scale, 10.0 ** log_offset, nx, nz, overlap, sin_min)
    args = _args(tris, rays)
    bounds = _t(KI.tri_group_bounds(*tris))
    off, outside = _differ_outside_the_domain(args, bounds, RAY_MASK_PRIMARY)
    note(f"{outside} lanes hit outside the margin's domain, {off} of them differ")


def _walk_one_ray(args, ray_mask, bounds, i):
    """One ray's walks, written out: K2's over the group boxes 32 at a time,
    nearest first, with the strict stop, and K3's in ascending order up to
    its first hit -> (groups K2 tests, its prim, groups K3 tests)."""
    o, d, tmin, tmax, exclude, v0, e1, e2, mask = args
    tn, tx = float(tmin[i]), float(tmax[i])
    if not tx > tn:
        return 0, -1, 0
    ray = ([c[i].reshape(1) for c in o], [c[i].reshape(1) for c in d], tmin[i].reshape(1))
    ng = bounds.shape[1]

    def tnear(g, bound):
        return float(slab_tnear(*ray, torch.tensor([bound], dtype=torch.float32), bounds[:, g:g + 1])[0, 0])

    def hits(g):
        """(t, id) of the group's triangles that hit, in ascending id."""
        ids = [j for j in range(g * KI.GROUP, min((g + 1) * KI.GROUP, v0.shape[0]))
               if int(mask[j]) & ray_mask and j != int(exclude[i])]
        if not ids:
            return []
        t, _, _, hit = KI.mt_block(ray[0], ray[1], v0[ids], e1[ids], e2[ids], ray[2], tmax[i].reshape(1))
        return [(float(t[0, k]), j) for k, j in enumerate(ids) if bool(hit[0, k])]

    best, prim, tested = 1e16, -1, 0
    for base in range(0, ng, KI.GROUP):
        chunk = [(tnear(g, min(best, tx)), g) for g in range(base, min(ng, base + KI.GROUP))]
        chunk = [c for c in chunk if c[0] < INF]
        while chunk:
            v, g = min(chunk)  # of equal tnear the lowest group
            if v > best:
                break
            chunk.remove((v, g))
            tested += 1
            for t, j in hits(g):
                if t < best or (t == best and j < prim):
                    best, prim = t, j
    any_tested = 0
    for g in range(ng):
        if tnear(g, tx) < INF:
            any_tested += 1
            if hits(g):
                break
    return tested, prim, any_tested


@pytest.mark.parametrize("case", ["dups-1", "coplanar-2", "cornell-bounce1"])
def test_walk_counts_equal_a_loop_over_the_rays(case):
    args, bounds = _case(case)
    n = args[2].shape[0]
    lanes = range(0, n, max(1, n // 160))
    _, prim, _, _, groups = KI.closest_walk_plain(*args, RAY_MASK_PRIMARY, bounds)
    _, any_groups, _, _ = KI.any_walk_plain(*args, RAY_MASK_PRIMARY, bounds)
    more_than_one = 0
    for i in lanes:
        tested, p, any_tested = _walk_one_ray(args, RAY_MASK_PRIMARY, bounds, i)
        assert (int(groups[i]), int(prim[i]), int(any_groups[i])) == (tested, p, any_tested), i
        more_than_one += tested > 1
    assert more_than_one > 0


@pytest.mark.parametrize("case", ["dups-1", "coplanar-2", "cornell-camera", "cornell-bounce1"])
def test_closest_walk_skips_no_group_that_beats_the_final_hit(case):
    """Every group that holds a triangle beating the final hit (a smaller t,
    or the same t and a lower id) is entered by the final interval
    [tmin, min(t, tmax)], so the walk's strict stop never passes it by."""
    args, bounds = _case(case)
    o, d, tmin, tmax, exclude, v0, e1, e2, mask = args
    t_f, p_f, *_ = KI.closest_plain(*args, RAY_MASK_PRIMARY)
    t, _, _, hit = KI.mt_block(o, d, v0, e1, e2, tmin, tmax)
    hit = KI._valid(hit, mask, RAY_MASK_PRIMARY, 0, exclude)
    ids = torch.arange(v0.shape[0])
    beats = hit & ((t < t_f[:, None]) | ((t == t_f[:, None]) & (ids[None, :] <= p_f[:, None])))
    ng = bounds.shape[1]
    pad = ng * KI.GROUP - v0.shape[0]
    group_beats = torch.nn.functional.pad(beats, (0, pad)).reshape(-1, ng, KI.GROUP).any(dim=2)
    entered = slab_tnear(o, d, tmin, torch.minimum(t_f, tmax), bounds) < INF
    assert bool(group_beats.any())
    assert not (group_beats & ~entered).any()
    # and the walk takes fewer groups than it could: the cull works
    walk_groups = KI.closest_walk_plain(*args, RAY_MASK_PRIMARY, bounds)[4]
    live = tmax > tmin
    assert float(walk_groups[live].float().mean()) < ng


def test_cpu_tensors_take_the_dense_plain_versions():
    args, bounds = _case("random-3")
    K.reset_counts()
    dense = KI.closest_plain(*args, RAY_MASK_PRIMARY)
    dense_occ = KI.any_plain(*args, RAY_MASK_SHADOW)
    for kw in (dict(bounds=bounds), dict(bounds=bounds, schedule="thread"), dict(cull=False)):
        out = KI.intersect_closest(*args, RAY_MASK_PRIMARY, **kw)
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(out, dense))
        assert torch.equal(KI.intersect_any(*args, RAY_MASK_SHADOW, **kw), dense_occ)
    assert K.launch_counts["intersect_closest"] == K.launch_counts["intersect_any"] == 0
    assert not any(K.plain_cuda_calls.values())
    with pytest.raises(ValueError, match="stats"):
        KI.intersect_closest(*args, RAY_MASK_PRIMARY, bounds=bounds, stats=True)
    with pytest.raises(ValueError, match="stats"):
        KI.intersect_any(*args, RAY_MASK_SHADOW, bounds=bounds, stats=True)
    with pytest.raises(RuntimeError, match="CUDA tensors"):
        KI._launch("strelka_intersect_closest", *args, RAY_MASK_PRIMARY, bounds, True, "warp", False)


def test_launch_checks_raise():
    assert KI.pick_schedule(128, False) == KI.pick_schedule(KI.GROUP * KI.THREAD_MAX_GROUPS, False) == "thread"
    assert KI.pick_schedule(640, False) == "warp" and KI.pick_schedule(128, True) == "warp"
    args, bounds = _case("random-3")
    ntri, dev = args[5].shape[0], torch.device("cpu")
    assert KI._check_groups(bounds, ntri, True, "warp", True, 1000, dev, "k") == bounds.shape[1] == 10
    assert KI._check_groups(None, ntri, False, "thread", False, 1000, dev, "k") == 10
    with pytest.raises(ValueError, match="group boxes"):
        KI._check_groups(None, ntri, True, "warp", False, 1000, dev, "k")
    with pytest.raises(ValueError, match=r"\[8, 10\]"):
        KI._check_groups(bounds[:, :9].contiguous(), ntri, True, "warp", False, 1000, dev, "k")
    with pytest.raises(ValueError, match="one-ray-a-warp"):
        KI._check_groups(bounds, ntri, True, "thread", True, 1000, dev, "k")
    with pytest.raises(ValueError, match="schedule"):
        KI._check_groups(bounds, ntri, True, "block", False, 1000, dev, "k")
    with pytest.raises(ValueError, match="counter"):
        KI._check_groups(bounds, ntri, True, "warp", False, 2 ** 31 - 1000, dev, "k")
