"""The port's curve path (ops/curves.py, ops/curve_refine.py, the curve tables
of render/device_scene.py, the plain versions of kernels K7/K8) against the
JAX package.

Inputs come from numpy seeds and go through both packages. Tolerances:
  * host build (flatten, Morton sort, pack, boxes, the scene's curve
    tables): bit-equal, it is the same numpy arithmetic;
  * the plain dense sweep against `intersect_curves_closest`: hit set
    equal; segment equal except at ties (two cones giving t within 1e-5 t:
    consecutive cones of a strand share an end sphere); t rtol 1e-5, u atol
    1e-5 on every lane but a counted few, which are held to t rtol 2e-5 and
    u atol 1e-4. XLA contracts products and sums into FMAs where the port
    rounds each, and the body root's discriminant k1^2 - k0 k2 cancels: on
    the 300 random cones (t up to 8, axes under 1 long) at most 1 lane of 54
    differs by more than 1e-5 t (1.3e-5), and u = (m1 + t m2) / d2 carries
    t's difference: at most 7 lanes of 54 differ by 1e-5 to 5.1e-5
    (`LOOSE_T_LANES`, `LOOSE_U_LANES`);
  * against the Pallas kernel in interpret mode, the same for t, with u from
    `cone_hit_to_seg_u` at atol 2e-3 as tests/test_curves.py holds it;
  * kernel K9's plain version against `pallas_open_w` in interpret mode:
    open, W and min_tn equal (differences, products, minima and maxima: no
    FMA to contract); the per-tile box distances rtol 1e-5 (the square of a
    difference from a mean of 128 origins, summed in another order);
  * frames and refinement: rtol 1e-5 / atol 1e-6 on the lanes both refine
    the same way (converged on both sides), at least 99% of the lanes.
On the CPU the K7/K8/K9 wrappers run the plain versions and count no launch.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strelka_tpu.ops import curve_refine as JCR
from strelka_tpu.ops import curves as JC
from strelka_tpu.ops import pallas_intersect as JPI
from strelka_tpu.ops.vec import Vec3 as JVec3
from strelka_tpu.render import device_scene as JDS
from strelka_tpu.scene import testscenes as JTS
from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import cones as KC
from strelka_tpu_torch.kernels import open_w as KO
from strelka_tpu_torch.ops import curve_refine as TCR
from strelka_tpu_torch.ops import curves as TC
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.ops import intersect as TX
from strelka_tpu_torch.ops.vec import Vec3 as TVec3
from strelka_tpu_torch.render import device_scene as TDS
from strelka_tpu_torch.scene import testscenes as TTS


def _random_segments(s, seed):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-2, 2, (s, 1, 3))
    pts = (base + np.cumsum(rng.normal(0, 0.25, (s, 4, 3)), axis=1)).astype(np.float32)
    w = rng.uniform(0.004, 0.05, (s, 4)).astype(np.float32)
    return {f"p{j}": pts[:, j] for j in range(4)} | {f"w{j}": w[:, j] for j in range(4)}


def _jax_flatten(curves_np, subdiv):
    old = JC.CURVE_SUBDIV
    JC.CURVE_SUBDIV = subdiv
    try:
        return JC.flatten_curves_np(curves_np)
    finally:
        JC.CURVE_SUBDIV = old


def _assert_cones_equal(a, b):
    for name in TC.FlatCones._fields:
        np.testing.assert_array_equal(np.asarray(getattr(a, name)), np.asarray(getattr(b, name)), err_msg=name)


# ---------------------------------------------------------------------------
# (a) host build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("subdiv", [4, 8, 64])
def test_flatten_curves_np_bit_equal(subdiv):
    curves = _random_segments(37, seed=5)
    _assert_cones_equal(TC.flatten_curves_np(curves, subdiv=subdiv), _jax_flatten(curves, subdiv))


def test_flatten_without_refinement_keeps_the_spline_radii():
    curves = _random_segments(9, seed=6)
    plain = TC.flatten_curves_np(curves, refine=False)
    inflated = TC.flatten_curves_np(curves, refine=True)
    us = np.linspace(0.0, 1.0, TC.CURVE_SUBDIV + 1, dtype=np.float32)
    b = TC.bspline_basis(us)
    rads = sum(b[j][:, None] * curves[f"w{j}"][None] for j in range(4))
    np.testing.assert_array_equal(plain.ra, rads[:-1].reshape(-1))
    np.testing.assert_array_equal(plain.rb, rads[1:].reshape(-1))
    assert (inflated.ra >= plain.ra).all() and (inflated.ra > plain.ra).any()
    np.testing.assert_array_equal(inflated.a, plain.a)


def test_bspline_evaluators_match_jax():
    """Basis, position, radius and tangent on torch tensors against the JAX
    evaluators (rtol 1e-6: the same few f32 operations)."""
    curves = _random_segments(64, seed=7)
    u = np.random.default_rng(7).random(64).astype(np.float32)
    p = [curves[f"p{j}"] for j in range(4)]
    w = [curves[f"w{j}"] for j in range(4)]
    tp, tw, tu = [torch.tensor(a) for a in p], [torch.tensor(a) for a in w], torch.tensor(u)
    jp, jw, ju = [jnp.asarray(a) for a in p], [jnp.asarray(a) for a in w], jnp.asarray(u)
    for ours, theirs in ((TC.eval_bspline(*tp, tu), JC.eval_bspline(*jp, ju)),
                         (TC.eval_bspline_scalar(*tw, tu), JC.eval_bspline_scalar(*jw, ju)),
                         (TC.eval_bspline_tangent(*tp, tu), JC.eval_bspline_tangent(*jp, ju))):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(sum(b.numpy() for b in TC.bspline_basis(tu)), 1.0, rtol=1e-6)
    np.testing.assert_allclose(sum(d.numpy() for d in TC.bspline_basis_deriv(tu)), 0.0, atol=1e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_morton_sort_cones_bit_equal(seed):
    cones = TC.flatten_curves_np(_random_segments(50, seed=seed))
    np.testing.assert_array_equal(TC.morton_sort_cones(cones), JC.morton_sort_cones(cones))


@pytest.mark.parametrize("tblk,super_", [(256, 8), (128, 2)])
def test_pack_cones_bit_equal(tblk, super_):
    cones = TC.flatten_curves_np(_random_segments(50, seed=3))
    cones = TC.FlatCones(*[f[TC.morton_sort_cones(cones)] for f in cones])
    rows, bounds = TC.pack_cones(cones, tblk=tblk, super_=super_)
    jrows, jbounds = JC.pack_cones(cones, tblk=tblk, super_=super_)
    np.testing.assert_array_equal(rows, np.asarray(jrows))
    np.testing.assert_array_equal(bounds, np.asarray(jbounds))
    assert rows.shape[1] % (tblk * super_) == 0 and (rows[TC.ROW_RA, 400:] == -1.0).all()
    np.testing.assert_array_equal(TC.cone_super_bounds(bounds, super_),
                                  np.asarray(JC._cone_super_bounds(jnp.asarray(bounds), super_)))


def test_flatten_scene_curves_bit_equal():
    ours = TDS.flatten_scene_curves(TTS.hair_patch(n_curves=16))
    theirs = JDS.flatten_scene_curves(JTS.hair_patch(n_curves=16))
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
        assert ours[k].dtype == theirs[k].dtype, k
    assert TDS.flatten_scene_curves(TTS.cornell_box()) is None


@pytest.fixture(scope="module")
def hair_scenes():
    """hair_patch(n_curves=16): the JAX CPU build, its cones sorted and packed
    by the JAX functions, and the port's build."""
    jds = JDS.build_device_scene(JTS.hair_patch(n_curves=16))
    assert jds.cones_packed is None  # the CPU build keeps the cones unsorted and unpacked
    perm = JC.morton_sort_cones(jds.cones)
    sorted_cones = JC.FlatCones(*[np.asarray(f)[perm] for f in jds.cones])
    rows, bounds = JC.pack_cones(sorted_cones)
    tds = TDS.build_device_scene(TTS.hair_patch(n_curves=16), device="cpu")
    return jds, sorted_cones, np.asarray(rows), np.asarray(bounds), tds


@pytest.mark.parametrize("field", TDS.CURVE_FIELDS)
def test_scene_curve_table_bit_equal(hair_scenes, field):
    jds, _, _, _, tds = hair_scenes
    np.testing.assert_array_equal(getattr(tds.curves, field).numpy(), np.asarray(getattr(jds.curves, field)))


def test_scene_cone_tables_bit_equal(hair_scenes):
    jds, sorted_cones, rows, bounds, tds = hair_scenes
    # the device's one cone table: the packed rows of the sorted cones, cone-major
    np.testing.assert_array_equal(tds.cone_geom.numpy().T, rows[[0, 1, 2, 6, 3, 4, 5, 7]])
    np.testing.assert_array_equal(tds.cone_attr.numpy(), rows[8:11])
    np.testing.assert_array_equal(tds.cone_attr.numpy()[2, :tds.num_cones], sorted_cones.seg_id)
    np.testing.assert_array_equal(tds.cone_geom.numpy()[:tds.num_cones, 4:7], sorted_cones.b)
    np.testing.assert_array_equal(tds.cone_bounds.numpy(), bounds)
    np.testing.assert_array_equal(tds.cone_sbounds.numpy(), TC.cone_super_bounds(bounds))
    assert torch.equal(tds.cone_tree, TC.cone_tree(tds.cone_geom.numpy()))
    leaf0, live = TC.cone_tree_levels(tds.cone_geom.shape[0])[-1][0], tds.num_cones // TC.CONE_LEAF
    lo = np.minimum(rows[0:3] - rows[6], rows[3:6] - rows[7])[:, :live * TC.CONE_LEAF]  # pack_cones' box arithmetic
    np.testing.assert_array_equal(tds.cone_tree.numpy()[0:3, leaf0:leaf0 + live],
                                  lo.reshape(3, live, TC.CONE_LEAF).min(axis=2))
    assert tds.packed_cones.tree is tds.cone_tree and tds.packed_cones.geom is tds.cone_geom
    assert tds.cone_geom.is_contiguous() and tds.cone_geom.shape == (rows.shape[1], 8)
    assert tds.num_cones == sorted_cones.a.shape[0] and tds.has_curves
    assert tds.curves.material_id.dtype == torch.int32
    assert tds.has_hair == jds.has_hair is True and tds.curve_refine
    assert tds.num_curve_segments == jds.num_curve_segments == 128
    for table in TDS.TABLES:  # the triangle tables of a scene with curves, too
        np.testing.assert_array_equal(getattr(tds, table).numpy(), np.asarray(getattr(jds, table)), err_msg=table)


def _arrays_of(jds):
    arrays = {f.name: np.asarray(getattr(jds, f.name)) for f in dataclasses.fields(jds)
              if not isinstance(getattr(jds, f.name), tuple)}
    arrays["curves"] = tuple(np.asarray(x) for x in jds.curves)
    arrays["cones"] = tuple(np.asarray(x) for x in jds.cones)
    return arrays


@pytest.mark.parametrize("packed", [False, True])
def test_device_scene_from_arrays_carries_curves(hair_scenes, packed):
    """A JAX DeviceScene carried across: from its CPU build (unsorted cones,
    nothing packed) the port sorts and packs; from a TPU-style build (sorted
    cones with rows and boxes) it takes them as they are."""
    jds, sorted_cones, rows, bounds, tds = hair_scenes
    arrays = _arrays_of(jds)
    if packed:
        arrays.update(cones=sorted_cones._asdict(), cones_packed=rows, cone_bounds=bounds)
    carried = TDS.device_scene_from_arrays(arrays, "cpu")
    assert torch.equal(carried.cone_geom, tds.cone_geom) and torch.equal(carried.cone_attr, tds.cone_attr)
    assert torch.equal(carried.cone_bounds, tds.cone_bounds) and carried.num_cones == tds.num_cones
    assert torch.equal(carried.cone_sbounds, tds.cone_sbounds) and carried.has_hair
    assert torch.equal(carried.cone_tree, tds.cone_tree)
    for field in TDS.CURVE_FIELDS:
        assert torch.equal(getattr(carried.curves, field), getattr(tds.curves, field)), field


def test_scene_without_curves_has_no_cone_tables():
    tds = TDS.build_device_scene(TTS.cornell_box(), device="cpu")
    assert tds.curves is None and tds.cone_geom is None and tds.cone_attr is None and tds.num_cones == 0
    assert tds.cone_tree is None
    assert not tds.has_curves and not tds.has_hair


def test_build_arguments_change_the_cones():
    base = TDS.build_device_scene(TTS.hair_patch(n_curves=4), device="cpu")
    coarse = TDS.build_device_scene(TTS.hair_patch(n_curves=4), device="cpu", curve_subdiv=4)
    exact = TDS.build_device_scene(TTS.hair_patch(n_curves=4), device="cpu", curve_refine=False)
    assert base.num_cones == 2 * coarse.num_cones == 4 * 5 * 8
    radii = lambda ds: float(ds.cone_geom[:ds.num_cones, TC.GEOM_RA].sum())  # noqa: E731
    assert not exact.curve_refine and radii(exact) < radii(base)


# ---------------------------------------------------------------------------
# (b) the plain dense sweep (kernels K7/K8 on the CPU)
# ---------------------------------------------------------------------------


def _cones_and_rays(seed=11, m=300, n=400):
    """The cones and rays of tests/test_curves.py:164-184, sorted and packed
    at tblk=128, super_=2."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.5, (m, 3)).astype(np.float32)
    ra = rng.uniform(0.02, 0.2, m).astype(np.float32)
    rb = rng.uniform(0.02, 0.2, m).astype(np.float32)
    cones = TC.FlatCones(a, b, ra, rb, np.arange(m, dtype=np.int32), np.zeros(m, np.float32), np.ones(m, np.float32))
    cones = TC.FlatCones(*[f[TC.morton_sort_cones(cones)] for f in cones])
    rows, bounds = TC.pack_cones(cones, tblk=128, super_=2)
    o = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return cones, rows, bounds, o, d


def _geom(rows):
    return torch.tensor(TC.cone_major_rows(rows))


def _attr(rows):
    return torch.tensor(TC.cone_attr_rows(rows))


def _packed(rows):
    return KC.PackedCones(_geom(rows), TC.cone_tree(TC.cone_major_rows(rows)))


def _torch_rays(o, d):
    return tuple(torch.tensor(o[:, k].copy()) for k in range(3)), tuple(torch.tensor(d[:, k].copy()) for k in range(3))


LOOSE_T_LANES = 1  # lanes allowed between t rtol 1e-5 and 2e-5 (module docstring)
LOOSE_U_LANES = 7  # lanes allowed between u atol 1e-5 and 1e-4


def _assert_hits_agree(hit, ref, u_atol=1e-5, loose_u_atol=1e-4):
    """hit (port CurveHit) against ref (JAX CurveHit): the tie rule and the
    counted loose lanes of the docstring."""
    seg, rseg = hit.seg.numpy(), np.asarray(ref.seg)
    t, rt = hit.t.numpy(), np.asarray(ref.t)
    np.testing.assert_array_equal(seg >= 0, rseg >= 0)
    hits = rseg >= 0
    rel = np.abs(t - rt)[hits] / np.abs(rt)[hits]
    assert (rel <= 2e-5).all() and int((rel > 1e-5).sum()) <= LOOSE_T_LANES
    differ = hits & (seg != rseg)
    assert (np.abs(t - rt)[differ] <= 1e-5 * np.abs(rt)[differ]).all()  # other segments only at ties
    same = hits & ~differ
    du = np.abs(hit.u.numpy() - np.asarray(ref.u))[same]
    assert (du <= loose_u_atol).all() and int((du > u_atol).sum()) <= LOOSE_U_LANES
    assert same.sum() >= 0.99 * hits.sum()
    np.testing.assert_array_equal(t[~hits], np.float32(1e16))


@pytest.mark.parametrize("tmax_value", [1e16, 8.0])
def test_plain_sweep_matches_jax_sweep(tmax_value):
    cones, rows, bounds, o, d = _cones_and_rays()
    n = o.shape[0]
    tmin, tmax = np.zeros(n, np.float32), np.full(n, tmax_value, np.float32)
    jcones = JC.FlatCones(*[jnp.asarray(f) for f in cones])
    ref = JC.intersect_curves_closest(jcones, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
    to, td = _torch_rays(o, d)
    geom = _geom(rows)
    t, cone, y = TC.intersect_curves_closest_plain(geom, to, td, torch.tensor(tmin), torch.tensor(tmax))
    assert int((cone >= 0).sum()) > 50
    _assert_hits_agree(TC.cone_hit(_attr(rows), t, cone, y), ref)
    occ = TC.intersect_curves_any_plain(geom, to, td, torch.tensor(tmin), torch.tensor(tmax))
    ref_occ = JC.intersect_curves_any(jcones, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref_occ))


def test_plain_sweep_matches_pallas_kernel_in_interpret_mode():
    cones, rows, bounds, o, d = _cones_and_rays()
    n = o.shape[0]
    tmin, tmax = np.zeros(n, np.float32), np.full(n, 1e16, np.float32)
    jcones = JC.FlatCones(*[jnp.asarray(f) for f in cones])
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    kw = dict(tile=256, tblk=128, super_=2, interpret=True)
    jt, jcone = JC.pallas_intersect_cones(jnp.asarray(rows), jnp.asarray(bounds), jo, jd, jnp.asarray(tmin),
                                          jnp.asarray(tmax), **kw)
    ref = JC.cone_hit_to_seg_u(jcones, jo, jd, jt, jcone)
    to, td = _torch_rays(o, d)
    geom = _geom(rows)
    t, cone, y = TC.intersect_curves_closest_plain(geom, to, td, torch.tensor(tmin), torch.tensor(tmax))
    _assert_hits_agree(TC.cone_hit(_attr(rows), t, cone, y), ref, u_atol=2e-3, loose_u_atol=2e-3)
    # the cone index itself: equal but at ties
    differ = (cone.numpy() != np.asarray(jcone)) & (cone.numpy() >= 0)
    assert (np.abs(t.numpy() - np.asarray(jt))[differ] <= 1e-5 * np.abs(np.asarray(jt))[differ]).all()
    # any hit, tmax = 8 as the reference's test
    tmax8 = np.full(n, 8.0, np.float32)
    jocc = JC.pallas_intersect_cones(jnp.asarray(rows), jnp.asarray(bounds), jo, jd, jnp.asarray(tmin),
                                     jnp.asarray(tmax8), any_hit=True, **kw)
    occ = TC.intersect_curves_any_plain(geom, to, td, torch.tensor(tmin), torch.tensor(tmax8))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(jocc))


def test_cone_hit_to_seg_u_matches_jax():
    cones, rows, bounds, o, d = _cones_and_rays(seed=12)
    n = o.shape[0]
    to, td = _torch_rays(o, d)
    tmin, tmax = torch.zeros(n), torch.full((n,), 1e16)
    t, cone, y = TC.intersect_curves_closest_plain(_geom(rows), to, td, tmin, tmax)
    tcones = TC.FlatCones(*[torch.tensor(f) for f in cones])
    ours = TC.cone_hit_to_seg_u(tcones, TVec3(*to), TVec3(*td), t, cone)
    jcones = JC.FlatCones(*[jnp.asarray(f) for f in cones])
    theirs = JC.cone_hit_to_seg_u(jcones, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t.numpy()),
                                  jnp.asarray(cone.numpy()))
    np.testing.assert_array_equal(ours.seg.numpy(), np.asarray(theirs.seg))
    np.testing.assert_array_equal(ours.t.numpy(), np.asarray(theirs.t))
    np.testing.assert_allclose(ours.u.numpy(), np.asarray(theirs.u), rtol=1e-5, atol=1e-6)
    # and on the cone's body the axial root of the sweep gives the same u as
    # the hit point does (on a cap the sweep says 0 or 1, the projection need not)
    hits = (cone.numpy() >= 0) & (y.numpy() > 0.0) & (y.numpy() < 1.0)
    assert hits.sum() > 20
    np.testing.assert_allclose(TC.cone_hit(_attr(rows), t, cone, y).u.numpy()[hits], ours.u.numpy()[hits],
                               atol=2e-3)


def test_lowest_cone_index_wins_ties_whatever_the_block():
    cones, rows, _, o, d = _cones_and_rays(seed=13, m=200, n=256)
    rows = rows.copy()
    rows[:, 100:200] = rows[:, 0:100]  # every cone twice: each hit is a tie of two indices
    to, td = _torch_rays(o, d)
    tmin, tmax = torch.zeros(256), torch.full((256,), 1e16)
    out = [TC.intersect_curves_closest_plain(_geom(rows), to, td, tmin, tmax, block=b) for b in (64, 256, 4096)]
    assert int((out[0][1] >= 0).sum()) > 10
    assert (out[0][1][out[0][1] >= 0] < 100).all()
    for other in out[1:]:
        for a, b in zip(out[0], other):
            assert torch.equal(a, b)


def test_dead_lanes_and_padding_never_hit():
    cones, rows, bounds, o, d = _cones_and_rays(seed=14)
    to, td = _torch_rays(o, d)
    n = o.shape[0]
    tmin = torch.zeros(n)
    tmax = torch.full((n,), 1e16)
    t_all, c_all, _ = TC.intersect_curves_closest_plain(_geom(rows), to, td, tmin, tmax)
    dead = torch.arange(n) % 2 == 0
    t, c, y = TC.intersect_curves_closest_plain(_geom(rows), to, td, tmin, torch.where(dead, 0.0, tmax))
    assert (c[dead] == -1).all() and (t[dead] == 1e16).all() and (y[dead] == 0).all()
    assert torch.equal(c[~dead], c_all[~dead])
    assert int(c_all.max()) < 300  # rows 300..511 are padding (ra = -1)


def test_wrappers_take_the_plain_sweep_on_cpu_tensors():
    cones, rows, bounds, o, d = _cones_and_rays(seed=15)
    pc = _packed(rows)
    to, td = _torch_rays(o, d)
    n = o.shape[0]
    tmin, tmax = torch.zeros(n), torch.full((n,), 6.0)
    K.reset_counts()
    t, c, y = KC.cone_closest(to, td, tmin, tmax, pc)
    occ = KC.cone_any(to, td, tmin, tmax, pc)
    tp, cp, yp = TC.intersect_curves_closest_plain(pc.geom, to, td, tmin, tmax)
    assert torch.equal(t, tp) and torch.equal(c, cp) and torch.equal(y, yp) and torch.equal(occ, cp >= 0)
    assert not any(K.launch_counts.values()) and not any(K.plain_cuda_calls.values())
    with pytest.raises(ValueError, match="stats"):
        KC.cone_closest(to, td, tmin, tmax, pc, stats=True)
    assert pc.shape == (512, 16) and pc.levels == ((0, 16),)


def test_cull_boxes_hold_every_hit():
    """The slab test of K7/K8 (ops/curves.py:slab_enters) on these rays: the
    leaf of the cone tree that holds every ray's winning cone is among the
    boxes its final interval enters, and so are the winner's sub-block and
    superblock (kernel K9's boxes)."""
    cones, rows, bounds, o, d = _cones_and_rays(seed=16)
    to, td = _torch_rays(o, d)
    n = o.shape[0]
    tmin, tmax = torch.zeros(n), torch.full((n,), 1e16)
    geom = _geom(rows)
    t, c, _ = TC.intersect_curves_closest_plain(geom, to, td, tmin, tmax)
    hits = c >= 0
    leaves = TC.slab_enters(to, td, tmin, torch.minimum(t, tmax), TC.cone_tree(geom))
    assert leaves[hits, (c[hits] // TC.CONE_LEAF).long()].all() and int(hits.sum()) > 10
    tb = torch.tensor(bounds)
    enters = TC.slab_enters(to, td, tmin, torch.minimum(t, tmax), tb)
    assert enters[hits, (c[hits] // 128).long()].all()
    sup = TC.slab_enters(to, td, tmin, torch.minimum(t, tmax), torch.tensor(TC.cone_super_bounds(bounds, 2)))
    assert sup[hits, (c[hits] // 256).long()].all()
    per_ray, cones_needed, touched = TC.sub_blocks_entered(geom, tb, to, td, tmin, torch.minimum(t, tmax), chunk=100)
    assert torch.equal(per_ray, enters.sum(dim=1, dtype=torch.int32)) and torch.equal(touched, enters.any(dim=0))
    live = torch.tensor([128, 128, 300 - 256, 0])  # cones with ra >= 0 in each box: padding is not counted
    assert torch.equal(cones_needed, (enters.long() * live[None, :]).sum(dim=1))
    assert not enters[:, 3].any()  # 300 cones: the fourth box of 128 is empty, inverted, rejected


def test_any_hit_need_counts_the_ascending_culled_sweep():
    """`any_hit_need` against a loop over rays, boxes and cones in numpy-free
    Python: the boxes a ray's interval enters in ascending order, their
    cones with ra >= 0 in ascending order, up to and including the first
    occluder (found by the dense sweep's own test, one cone at a time)."""
    cones, rows, bounds, o, d = _cones_and_rays(seed=17, n=256)
    to, td = _torch_rays(o, d)
    n = o.shape[0]
    tmin = torch.zeros(n)
    tmax = torch.where(torch.arange(n) % 5 == 0, 0.0, torch.full((n,), 12.0))  # every fifth lane dead
    geom, tb = _geom(rows), torch.tensor(bounds)
    blocks, tested, touched = TC.any_hit_need(geom, tb, to, td, tmin, tmax, chunk=40)
    enters = TC.slab_enters(to, td, tmin, tmax, tb) & (tmax > tmin)[:, None]
    want_blocks, want_tested, want_touched = np.zeros(n, int), np.zeros(n, int), np.zeros(4, bool)
    for r in range(n):
        ray = ([c[r:r + 1, None] for c in to], [c[r:r + 1, None] for c in td], tmin[r:r + 1, None], tmax[r:r + 1, None])
        for blk in torch.nonzero(enters[r])[:, 0].tolist():
            a, b, ra, rb = TC._geom_columns(geom[None, blk * 128:(blk + 1) * 128])
            hit = (TC.ray_round_cone(ray[0], ray[1], a, b, ra, rb, ray[2], ray[3])[2] & (ra >= 0.0))[0]
            valid = (ra >= 0.0)[0]
            want_blocks[r] += 1
            want_touched[blk] = True
            if hit.any():
                want_tested[r] += int(valid[:int(torch.nonzero(hit)[0, 0]) + 1].sum())
                break
            want_tested[r] += int(valid.sum())
    np.testing.assert_array_equal(blocks.numpy(), want_blocks)
    np.testing.assert_array_equal(tested.numpy(), want_tested)
    np.testing.assert_array_equal(touched.numpy(), want_touched)
    occ = TC.intersect_curves_any_plain(geom, to, td, tmin, tmax)
    assert int(occ.sum()) > 5 and (blocks[tmax == 0] == 0).all()
    # an occluded ray tested fewer cones than its boxes hold, an open one all of them
    _, all_cones, _ = TC.sub_blocks_entered(geom, tb, to, td, tmin, tmax)
    assert (tested[~occ] == all_cones[~occ]).all() and (tested[occ] <= all_cones[occ]).all()


# ---------------------------------------------------------------------------
# kernel K9 (open_w) on the CPU: its plain version, and the order it gives
# ---------------------------------------------------------------------------


def _open_w_inputs(seed=13, n=500, tile=128, k=3):
    """Rays with per-ray bounds against the 8 superblock boxes of 2048 random
    cones (tblk=128, super_=2), as tests/test_pallas_intersect.py holds
    pallas_open_w; each tile's origins lie close together, so a tile passes
    some boxes and not others; n is no multiple of the tile."""
    rng = np.random.default_rng(seed)
    m = 2048 - 100  # the last box is part padding
    a = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    b = a + rng.normal(0, 0.5, (m, 3)).astype(np.float32)
    r = rng.uniform(0.02, 0.2, (2, m)).astype(np.float32)
    cones = TC.FlatCones(a, b, r[0], r[1], np.arange(m, dtype=np.int32), np.zeros(m, np.float32), np.ones(m, np.float32))
    cones = TC.FlatCones(*[f[TC.morton_sort_cones(cones)] for f in cones])
    rows, bounds = TC.pack_cones(cones, tblk=128, super_=2)
    sbounds = TC.cone_super_bounds(bounds, 2)
    centres = np.repeat(rng.uniform(-5, 5, (-(-n // tile), 3)), tile, axis=0)[:n]
    o = (centres + rng.normal(0, 0.3, (n, 3))).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[::17, 1] = 0.0  # axis-parallel components: the guarded reciprocal
    bound = rng.uniform(0.5, 5.0, n).astype(np.float32)
    bound[::7] = 0.0  # dead lanes
    return rows, bounds, sbounds, o, d, np.zeros(n, np.float32), bound, tile, k


def test_tile_box_d2_and_order_k_match_jax():
    _, _, sbounds, o, _, _, _, tile, k = _open_w_inputs()
    to, _ = _torch_rays(o, o)
    jo = JVec3(*(jnp.asarray(o[:, c]) for c in range(3)))
    order, r2t, d2 = TC.tile_sweep_order_k(to, torch.tensor(sbounds), tile, k)
    jorder, jr2t, jd2 = JPI.tile_sweep_order_k(jo, jnp.asarray(sbounds), tile, k)
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(r2t.numpy(), np.asarray(jr2t), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    assert d2.shape == (4, 8) and order.dtype == torch.int32


@pytest.mark.parametrize("with_open", [True, False])
def test_open_w_plain_matches_pallas_open_w(with_open):
    _, _, sbounds, o, d, tmin, bound, tile, k = _open_w_inputs()
    jo, jd = (JVec3(*(jnp.asarray(a[:, c]) for c in range(3))) for a in (o, d))
    _, jr2t, jd2 = JPI.tile_sweep_order_k(jo, jnp.asarray(sbounds), tile, k)
    if not with_open:
        jr2t = jnp.full(jd2.shape[0], jnp.inf, jnp.float32)  # the reference's W / min_tn-only use
    jopen, jw, jtn = JPI.pallas_open_w(jo, jd, jnp.asarray(tmin), jnp.asarray(bound), jnp.asarray(sbounds), jd2, jr2t,
                                       tile=tile, interpret=True)
    to, td = _torch_rays(o, d)
    K.reset_counts()
    extra = (torch.tensor(np.asarray(jd2)), torch.tensor(np.asarray(jr2t))) if with_open else ()
    open_, w, tn = KO.open_w_plain(to, td, torch.tensor(tmin), torch.tensor(bound), torch.tensor(sbounds), *extra,
                                   tile=tile, exact=True)
    np.testing.assert_array_equal(open_.numpy(), np.asarray(jopen))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jtn))
    assert w.shape == (4, 8) and 0 < int(w.sum()) < 32 and bool(open_.any()) == with_open
    assert not (open_.numpy() & (bound == 0)).any()
    assert not any(K.launch_counts.values()) and not any(K.plain_cuda_calls.values())


def test_sweep_order_lists_the_passed_superblocks_nearest_first():
    rows, bounds, sbounds, o, d, tmin, bound, tile, _ = _open_w_inputs(seed=14)
    to, td = _torch_rays(o, d)
    args = (to, td, torch.tensor(tmin), torch.tensor(bound), torch.tensor(sbounds))
    _, w, tn = KO.open_w(*args, tile=tile)
    order = KO.sweep_order(*args, tile=tile)
    assert order.tile == tile and order.order.dtype == order.count.dtype == torch.int32
    assert torch.equal(order.count, w.sum(dim=1, dtype=torch.int32))
    for r in range(w.shape[0]):
        head = order.order[r, :int(order.count[r])].long()
        assert w[r, head].all() and sorted(order.order[r].tolist()) == list(range(8))
        assert (tn[r, head][1:] >= tn[r, head][:-1]).all()
    # every superblock a ray of the tile enters by the cone kernels' own test is in the tile's list
    enters = TC.slab_enters(to, td, args[2], args[3], args[4]) & (args[3] > args[2])[:, None]
    pad = -o.shape[0] % tile
    by_tile = torch.cat([enters, enters.new_zeros((pad, 8))]).reshape(-1, tile, 8).any(dim=1)
    assert not (by_tile & ~w).any()
    with pytest.raises(RuntimeError, match="CUDA tensors"):  # the kernel's own checks take no CPU tensor
        KO._check(to, td, args[2], args[3], args[4], None, None, tile)


def test_scene_dispatch_asks_for_no_order_on_cpu_tensors(monkeypatch):
    """ops/intersect.py: the scene's cone sweeps take no sweep order
    anywhere (K7/K8 walk the cone tree, so kernel K9 is off their path): on
    CPU tensors they are the dense plain sweeps, and neither K9 nor its
    plain version runs."""
    rows, bounds, sbounds, o, d, tmin, bound, _, _ = _open_w_inputs(seed=15)
    pc = _packed(rows)
    scene = dataclasses.make_dataclass("Scene", ["packed_cones", "cone_attr"])(pc, _attr(rows))
    to, td = _torch_rays(o, d)
    for name in ("open_w", "open_w_plain", "sweep_order", "sweep_order_plain"):
        monkeypatch.setattr(KO, name, lambda *a, **k: pytest.fail("kernel K9 is off the cone sweeps' path"))
    K.reset_counts()
    tmin, bound = torch.tensor(tmin), torch.tensor(bound)
    hit = TX.intersect_curves_closest(scene, TVec3(*to), TVec3(*td), tmin, bound)
    occ = TX.intersect_curves_any(scene, TVec3(*to), TVec3(*td), tmin, bound)
    want = TC.cone_hit(_attr(rows), *TC.intersect_curves_closest_plain(pc.geom, to, td, tmin, bound))
    assert all(torch.equal(a, b) for a, b in zip(hit, want)) and int((hit.seg >= 0).sum()) > 5
    assert torch.equal(occ, TC.intersect_curves_any_plain(pc.geom, to, td, tmin, bound))
    assert not any(K.launch_counts.values()) and not any(K.plain_cuda_calls.values())


# ---------------------------------------------------------------------------
# (c) frames and refinement
# ---------------------------------------------------------------------------


class _Curves:
    def __init__(self, curves_np, conv):
        for k, v in curves_np.items():
            setattr(self, k, conv(v))


def _hits_on_segments(seed, s=24, n=600):
    """Random segments, rays aimed at them, and the plain sweep's hits."""
    curves = _random_segments(s, seed)
    cones = TC.flatten_curves_np(curves)
    rows, _ = TC.pack_cones(cones)
    rng = np.random.default_rng(seed + 100)
    target = cones.a[rng.integers(0, cones.a.shape[0], n)] + rng.normal(0, 0.03, (n, 3)).astype(np.float32)
    o = (target + rng.normal(0, 1.0, (n, 3)) * 3.0).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    to, td = _torch_rays(o, d)
    t, c, y = TC.intersect_curves_closest_plain(_geom(rows), to, td, torch.zeros(n), torch.full((n,), 1e16))
    hit = TC.cone_hit(_attr(rows), t, c, y)
    assert int((hit.seg >= 0).sum()) > 0.5 * n
    return curves, o, d, hit


def test_curve_shading_frame_matches_jax():
    curves, o, d, hit = _hits_on_segments(seed=21)
    to, td = _torch_rays(o, d)
    pos = TVec3(*to) + TVec3(*td) * hit.t
    ours = TC.curve_shading_frame_vec(_Curves(curves, torch.tensor), hit.seg, hit.u, pos)
    jo, jd = (JVec3(*(jnp.asarray(a[:, k]) for k in range(3))) for a in (o, d))
    jpos = jo + jd * jnp.asarray(hit.t.numpy())
    theirs = JC.curve_shading_frame_vec(_Curves(curves, jnp.asarray), jnp.asarray(hit.seg.numpy()),
                                        jnp.asarray(hit.u.numpy()), jpos)
    hits = hit.seg.numpy() >= 0
    for a, b in zip(ours, theirs):
        for k in range(3):
            # unit vectors from differences of nearby points (hit - spine): atol 2e-4
            np.testing.assert_allclose(a[k].numpy()[hits], np.asarray(b[k])[hits], atol=2e-4)
    n_, t_, b_ = ours
    assert np.abs((n_.x * t_.x + n_.y * t_.y + n_.z * t_.z).numpy()[hits]).max() < 1e-4


def test_refine_scene_curve_hit_matches_jax():
    curves, o, d, hit = _hits_on_segments(seed=22)
    to, td = _torch_rays(o, d)
    rt, ru, keep = TCR.refine_scene_curve_hit(_Curves(curves, torch.tensor), TVec3(*to), TVec3(*td), hit.t, hit.seg,
                                              hit.u)
    jo, jd = (JVec3(*(jnp.asarray(a[:, k]) for k in range(3))) for a in (o, d))
    jt, ju, jkeep = JCR.refine_scene_curve_hit(_Curves(curves, jnp.asarray), jo, jd, jnp.asarray(hit.t.numpy()),
                                               jnp.asarray(hit.seg.numpy()), jnp.asarray(hit.u.numpy()))
    agree = keep.numpy() == np.asarray(jkeep)
    assert agree.mean() >= 0.99
    ok = agree & keep.numpy()
    close = np.isclose(rt.numpy(), np.asarray(jt), rtol=1e-5, atol=1e-6) & np.isclose(ru.numpy(), np.asarray(ju),
                                                                                      rtol=1e-5, atol=1e-5)
    assert close[ok].mean() >= 0.99  # a lane at the convergence threshold may fall back on one side only
    miss = hit.seg.numpy() < 0
    np.testing.assert_array_equal(rt.numpy()[miss], hit.t.numpy()[miss])
    assert keep.numpy()[miss].all()


def test_closest_curve_hit_refines_and_drops_ghosts():
    tds = TDS.build_device_scene(TTS.hair_patch(n_curves=16), device="cpu")
    rng = np.random.default_rng(23)
    n = 512
    o = np.tile(np.array([2.4, 1.6, 2.4], np.float32), (n, 1))
    target = np.stack([rng.uniform(-1, 1, n), rng.uniform(0, 1.2, n), rng.uniform(-1, 1, n)], 1).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    to, td = _torch_rays(o, d)
    tmin, tmax = torch.zeros(n), torch.full((n,), 1e16)
    raw = TX.intersect_curves_closest(tds, TVec3(*to), TVec3(*td), tmin, tmax)
    fine = TI.closest_curve_hit(tds, TVec3(*to), TVec3(*td), tmin, tmax, None)
    assert int((raw.seg >= 0).sum()) > 10
    assert ((fine.seg >= 0) <= (raw.seg >= 0)).all()  # refinement only turns ghosts into misses
    kept = fine.seg >= 0
    assert torch.equal(fine.seg[kept], raw.seg[kept])
    assert (torch.abs(fine.t - raw.t)[kept] < 0.05).all() and (fine.t[(raw.seg >= 0) & ~kept] == 1e30).all()
    occ = TX.intersect_curves_any(tds, TVec3(*to), TVec3(*td), tmin, tmax)
    assert torch.equal(occ, raw.seg >= 0)


# ---- the cases of tests/test_curve_refine.py, on the port


_P = np.array([[-1.0, -0.3, 0.0], [-0.3, 0.4, 0.2], [0.3, -0.4, -0.2], [1.0, 0.3, 0.0]], np.float32)
_W = np.array([0.12, 0.2, 0.16, 0.1], np.float32)
_ONE = {f"p{j}": _P[j][None] for j in range(4)} | {f"w{j}": _W[j][None] for j in range(4)}


def _sweep_at(subdiv, o, d):
    rows, _ = TC.pack_cones(TC.flatten_curves_np(_ONE, subdiv=subdiv))
    n = o[0].shape[0]
    return TC.cone_hit(_attr(rows), *TC.intersect_curves_closest_plain(_geom(rows), o, d, torch.zeros(n),
                                                                       torch.full((n,), 1e9)))


def _rays_toward_curve(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.2 + np.array([0, 0, -4], np.float32)
    target = rng.uniform(-0.4, 0.4, size=(n, 3)).astype(np.float32)
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return _torch_rays(o, d)


def test_refinement_beats_coarse_cones():
    o, d = _rays_toward_curve(512)
    coarse, oracle = _sweep_at(8, o, d), _sweep_at(64, o, d)
    hit = (coarse.seg >= 0) & (oracle.seg >= 0)
    assert int(hit.sum()) > 100
    t_ref, _, keep = TCR.refine_scene_curve_hit(_Curves(_ONE, torch.tensor), TVec3(*o), TVec3(*d), coarse.t,
                                                coarse.seg, coarse.u)
    hit = (hit & keep).numpy()
    err_coarse = np.abs(coarse.t.numpy() - oracle.t.numpy())[hit]
    err_ref = np.abs(t_ref.numpy() - oracle.t.numpy())[hit]
    assert np.median(err_ref) < 0.2 * max(np.median(err_coarse), 1e-9)
    assert np.mean(err_ref) < np.mean(err_coarse)


def test_refinement_residual_on_envelope():
    n = 512
    o, d = _rays_toward_curve(n, seed=3)
    coarse = _sweep_at(8, o, d)
    valid = (coarse.seg >= 0).numpy()
    ctrl = tuple(TVec3(*(torch.full((n,), float(_P[j][i])) for i in range(3))) for j in range(4))
    weights = tuple(torch.full((n,), float(_W[j])) for j in range(4))
    res = TCR.refine_curve_hit(ctrl, weights, TVec3(*o), TVec3(*d), coarse.t, coarse.u)
    conv = res.converged.numpy() & valid
    assert conv.sum() > 0.8 * valid.sum()
    u, t = res.u.numpy(), res.t.numpy()
    b = TC.bspline_basis(u)
    cu = sum(b[j][:, None] * _P[j][None] for j in range(4))
    r = sum(b[j] * _W[j] for j in range(4))
    p = np.stack([o[k].numpy() + t * d[k].numpy() for k in range(3)], 1)
    rel = np.abs(np.linalg.norm(p - cu, axis=1) - r)[conv] / np.maximum(r[conv], 1e-9)
    assert np.quantile(rel, 0.9) < 1e-3


def test_refinement_passthrough_on_miss():
    n = 8
    o = TVec3(torch.zeros(n), torch.zeros(n), torch.full((n,), -4.0))
    d = TVec3(torch.zeros(n), torch.ones(n), torch.zeros(n))
    t = torch.full((n,), 1e16)
    t2, _, keep = TCR.refine_scene_curve_hit(_Curves(_ONE, torch.tensor), o, d, t,
                                             torch.full((n,), -1, dtype=torch.int32), torch.zeros(n))
    assert torch.equal(t2, t) and keep.all()


def test_coarse_subdiv_with_refinement_matches_oracle():
    o, d = _rays_toward_curve(512, seed=7)
    coarse4, coarse8, oracle = _sweep_at(4, o, d), _sweep_at(8, o, d), _sweep_at(64, o, d)
    hit = (coarse4.seg >= 0) & (oracle.seg >= 0)
    t4r, _, keep4 = TCR.refine_scene_curve_hit(_Curves(_ONE, torch.tensor), TVec3(*o), TVec3(*d), coarse4.t,
                                               coarse4.seg, coarse4.u)
    hit = (hit & keep4).numpy()
    err4_refined = np.abs(t4r.numpy() - oracle.t.numpy())[hit]
    err8_plain = np.abs(coarse8.t.numpy() - oracle.t.numpy())[hit]
    assert np.median(err4_refined) < 0.5 * max(np.median(err8_plain), 1e-9)
