"""The round-cone closed form rounded as the JAX package's CPU render rounds it.

The goldens are f32 CPU renders of the JAX package, whose scan body of
strelka_tpu/ops/curves.py:intersect_curves_closest XLA compiles into loops
that LLVM contracts into FMAs (a product with one use, into the sum or
difference it feeds) and whose `x - y > 0` tests it folds into `x > y`.
The port's plain sweep (ops/curves.py:ray_round_cone, each fma rounded once
by ops/vec.py:fma) and kernels K7/K8 (csrc/cones.cu:ray_cone) follow that
pattern. Held here on the CPU against the jitted JAX sweeps:

(a) ops/vec.py:fma against exact rational arithmetic;
(b) grazing rays at fibre silhouettes against hair-scale cones (radius
    0.002-0.006, ray origins 2.2 away, the aim off the silhouette by 1e-7 to
    1e-1 of the radius): the closest sweep's segment on every lane, t and u
    bit-equal on every hit, and the any-hit sweep's occlusion on every lane
    (its caps are tested on the contracted discriminant, the closest
    sweep's on the two rounded products: the two hit sets differ on some
    lanes of this set, in both packages);
(c) ROADMAP C.5's lane: pixel (row 6, column 9) of hair_long's 16x16 camera
    at subframe 0 against segment 21669's cones: the broad phase's t and u
    bit-equal to JAX's, and the refinement's keep verdict equal to JAX's
    (both reject the hit as a ghost of the inflated radii).
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strelka_tpu.ops import curve_refine as JR
from strelka_tpu.ops import curves as JC
from strelka_tpu.ops.vec import Vec3 as JVec3
from strelka_tpu.render.device_scene import DeviceCurves
from strelka_tpu_torch.ops import curves as TC
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.ops import sampler as TS
from strelka_tpu_torch.ops.curve_refine import refine_scene_curve_hit
from strelka_tpu_torch.ops.vec import Vec3, fma
from strelka_tpu_torch.render.device_scene import build_device_scene
from strelka_tpu_torch.scene import testscenes as TTS


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the plain sweep's many small passes gain nothing
    from more beside the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fma_rounds_once():
    rng = np.random.default_rng(0)
    n = 4000
    a = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    b = (rng.standard_normal(n) * 2.0 ** rng.integers(-20, 20, n)).astype(np.float32)
    c = -(a.astype(np.float64) * b * (1 + rng.standard_normal(n) * 1e-7)).astype(np.float32)  # cancelling
    c[::4] = -(a[::4] * b[::4])  # the product's rounding error alone
    c[1::4] = rng.standard_normal(len(c[1::4])).astype(np.float32)
    out = fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for x, y, z, got in zip(a, b, c, out):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        near = np.float32(float(exact))
        cands = [np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf))]
        want = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact), int(np.float32(v).view(np.int32)) & 1))
        assert got == want, (x, y, z)


def grazing_set(seed, n_rays, n_cones):
    """Hair-scale cones in a 0.1 cube and rays aimed at their silhouettes."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-0.05, 0.05, (n_cones, 3)).astype(np.float32)
    axis = rng.standard_normal((n_cones, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    b = (a + axis * rng.uniform(0.01, 0.04, n_cones)[:, None]).astype(np.float32)
    ra = rng.uniform(0.002, 0.006, n_cones).astype(np.float32)
    rb = (ra * rng.uniform(0.8, 1.0, n_cones)).astype(np.float32)
    ci = rng.integers(0, n_cones, n_rays)
    s = rng.uniform(-0.1, 1.1, n_rays)
    ax = (b[ci] - a[ci]).astype(np.float64)
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    perp = rng.standard_normal((n_rays, 3))
    perp -= (perp * ax).sum(1, keepdims=True) * ax
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    rad = ra[ci] + (rb[ci] - ra[ci]) * np.clip(s, 0, 1)
    off = rng.choice([-1.0, 1.0], n_rays) * 10.0 ** rng.uniform(-7, -1, n_rays)
    target = a[ci] + (b[ci] - a[ci]) * s[:, None] + perp * (rad * (1 + off))[:, None]
    view = np.cross(ax, perp) + rng.standard_normal((n_rays, 3)) * 0.05
    view /= np.linalg.norm(view, axis=1, keepdims=True)
    o = (target - view * 2.2).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d, a, b, ra, rb


def _jax_sweeps(a, b, ra, rb, u0, u1, o, d, tmin, tmax):
    cones = JC.FlatCones(a=jnp.asarray(a), b=jnp.asarray(b), ra=jnp.asarray(ra), rb=jnp.asarray(rb),
                         seg_id=jnp.arange(a.shape[0], dtype=jnp.int32), u0=jnp.asarray(u0), u1=jnp.asarray(u1))
    args = (cones, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
    hit = jax.jit(JC.intersect_curves_closest)(*args)
    occluded = jax.jit(JC.intersect_curves_any)(*args)
    return np.asarray(hit.t), np.asarray(hit.seg), np.asarray(hit.u), np.asarray(occluded)


def _port_sweeps(a, b, ra, rb, u0, u1, o, d, tmin, tmax):
    geom = torch.from_numpy(np.concatenate([a, ra[:, None], b, rb[:, None]], axis=1))
    attr = torch.from_numpy(np.stack([u0, u1, np.arange(a.shape[0], dtype=np.float32)]))
    cols = lambda x: tuple(torch.from_numpy(np.ascontiguousarray(x[:, k])) for k in range(3))  # noqa: E731
    oo, dd, tn, tx = cols(o), cols(d), torch.from_numpy(tmin), torch.from_numpy(tmax)
    hit = TC.cone_hit(attr, *TC.intersect_curves_closest_plain(geom, oo, dd, tn, tx))
    occluded = TC.intersect_curves_any_plain(geom, oo, dd, tn, tx)
    return hit.t.numpy(), hit.seg.numpy(), hit.u.numpy(), occluded.numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_grazing_rays_match_jax_bit_for_bit(seed):
    n_rays, n_cones = 2048, 384
    o, d, a, b, ra, rb = grazing_set(seed, n_rays, n_cones)
    u0 = np.linspace(0.0, 1.0, n_cones, dtype=np.float32)
    u1 = (u0 + np.float32(0.25)).astype(np.float32)
    tmin = np.zeros(n_rays, np.float32)
    tmax = np.full(n_rays, 1e16, np.float32)
    tmax[::16] = 2.2  # the far end cuts some hits
    jt, jseg, ju, jocc = _jax_sweeps(a, b, ra, rb, u0, u1, o, d, tmin, tmax)
    pt, pseg, pu, pocc = _port_sweeps(a, b, ra, rb, u0, u1, o, d, tmin, tmax)
    hits = jseg >= 0
    assert hits.mean() > 0.9
    np.testing.assert_array_equal(pseg, jseg)
    np.testing.assert_array_equal(pt[hits], jt[hits])
    np.testing.assert_array_equal(pu[hits], ju[hits])
    np.testing.assert_array_equal(pocc, jocc)


_C5_PIXEL = (6, 9)  # (row, column) of hair_long's 16x16 camera
_C5_SEGMENT = 21669


def test_c5_lane_keep_verdict_matches_jax():
    scene = build_device_scene(TTS.hair_patch(n_curves=20000), device="cpu")
    cam = TTS.hair_patch(n_curves=1).get_camera(0)  # the camera does not depend on the fibres
    cam.update_aspect_ratio(1.0)
    params = TI.LaunchParams(0, np.asarray(cam.clip_to_view(), np.float32), np.asarray(cam.view_to_world(), np.float32),
                             np.full(3, 6.25e-4, np.float32), np.zeros(3, np.float32))
    row, col = _C5_PIXEL
    px, py = torch.tensor([col]), torch.tensor([row])
    dims0 = TS.random_dims(TS.make_sample_index(px, py, torch.zeros(1, dtype=torch.int64), 100000), 0, (0, 1, 2, 3, 4))
    o, d = TI.generate_camera_rays(params, px, py, dims0[0], dims0[1], 16, 16)
    sel = torch.nonzero(scene.cone_attr[TC.ATTR_SEG] == _C5_SEGMENT)[:, 0]
    g = scene.cone_geom[sel].numpy()
    attr = scene.cone_attr[:, sel].numpy()
    a, ra, b, rb = g[:, 0:3], g[:, 3], g[:, 4:7], g[:, 7]
    on, dn = np.stack([c.numpy() for c in o], 1), np.stack([c.numpy() for c in d], 1)
    tmin, tmax = np.zeros(1, np.float32), np.full(1, 1e16, np.float32)
    jt, _, ju, _ = _jax_sweeps(a, b, ra, rb, attr[0], attr[1], on, dn, tmin, tmax)
    pt, pc, pu, _ = _port_sweeps(a, b, ra, rb, attr[0], attr[1], on, dn, tmin, tmax)
    assert pc[0] >= 0 and pt[0] == jt[0] and pu[0] == ju[0]
    assert abs(float(pt[0]) - 2.228976) < 1e-6  # JAX's t at this lane (ROADMAP C.5)

    seg = torch.tensor([_C5_SEGMENT], dtype=torch.int32)
    _, _, keep = refine_scene_curve_hit(scene.curves, Vec3(*o), Vec3(*d), torch.from_numpy(pt), seg,
                                        torch.from_numpy(pu))
    jcurves = DeviceCurves(*(jnp.asarray(getattr(scene.curves, f).numpy()) for f in DeviceCurves._fields))
    refine = jax.jit(lambda o, d, t, s, u: JR.refine_scene_curve_hit(jcurves, JVec3(*o), JVec3(*d), t, s, u))
    J = lambda x: jnp.asarray(x.numpy())  # noqa: E731
    _, _, jkeep = refine(tuple(J(c) for c in o), tuple(J(c) for c in d), jnp.asarray(jt), J(seg), jnp.asarray(ju))
    assert bool(keep[0]) == bool(jkeep[0]) is False
