"""Port BVH (builders, threading, plain traversal of kernels K5/K6) against the JAX package.

Builders are host code and must be BIT-EQUAL: the numpy builder to
`_build_bvh_numpy`, the C++ builder to `native_build_bvh` compiled on the
same host with the same flags, `thread_bvh` to `thread_bvh`.

Every traversal test runs on a tree carried across from the JAX package
(`device_bvh` of its ThreadedBvh), so none depends on builder equality.
Tolerances: against `intersect_bvh` (the same walk in the same order) prims
equal, t within 2e-6 relative, u, v within 1e-6 relative plus 2e-5 absolute
(XLA may contract a product and a sum into an FMA, the port rounds each:
that moves t by up to 1.1e-6 relative on these rays, and u, v, dots with
cancellation, by ~1e-5 absolute);
against brute force the bar of tests/test_bvh.py (hit/miss equal, t within
1e-4 relative, > 99% of hit prims equal); against the Pallas superblock
kernels in interpret mode the tie rule of tests/test_torch_intersect.py
(prims equal unless |dt| <= 1e-5 t) and the t tolerance the Pallas tests
use against brute force, 2e-4 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strelka_tpu.native import native_build_bvh as jax_native_build
from strelka_tpu.ops import bvh as JB
from strelka_tpu.ops import intersect as JX
from strelka_tpu.ops.pallas_intersect import block_bounds, pack_tris, pallas_intersect_any, pallas_intersect_closest
from strelka_tpu.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW
from strelka_tpu.render.device_scene import flatten_scene_geometry as jax_flatten
from strelka_tpu.scene import testscenes as JTS
from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import bvh as KB
from strelka_tpu_torch.native import native_build_bvh
from strelka_tpu_torch.ops import bvh as TB
from strelka_tpu_torch.utils import profiling as P


def _random_tris(n, rng, spread=10.0):
    v0 = rng.uniform(-spread, spread, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    return v0, e1, e2


def _box_field_tris(grid=4):
    """box_field's soup: axis-aligned quads and boxes (zero-thickness leaf boxes) and spheres."""
    p = jax_flatten(JTS.box_field(grid=grid))["p"]
    return p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]


def _tris(kind, rng):
    return _box_field_tris() if kind == "box_field" else _random_tris(1500, rng)


def _assert_trees_equal(a, b):
    assert a._fields == b._fields
    for name in a._fields:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8), err_msg=name)


@pytest.mark.parametrize("kind", ["random", "box_field"])
def test_numpy_builder_bit_equal(kind):
    v0, e1, e2 = _tris(kind, np.random.default_rng(0))
    ref_nodes, ref_perm = JB._build_bvh_numpy(v0, e1, e2, JB.MAX_LEAF)
    nodes, perm = TB._build_bvh_numpy(v0, e1, e2, TB.MAX_LEAF)
    _assert_trees_equal(nodes, ref_nodes)
    np.testing.assert_array_equal(perm, ref_perm)
    assert sorted(perm.tolist()) == list(range(v0.shape[0]))
    assert nodes.count.max() <= TB.MAX_LEAF


@pytest.mark.parametrize("kind", ["random", "box_field"])
def test_native_builder_bit_equal(kind):
    v0, e1, e2 = _tris(kind, np.random.default_rng(1))
    ref = jax_native_build(v0, e1, e2, JB.MAX_LEAF)
    out = native_build_bvh(v0, e1, e2, TB.MAX_LEAF)
    if ref is None or out is None:
        pytest.skip("no C++ toolchain on this host: both packages take the numpy builder")
    _assert_trees_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[1], ref[1])


def test_build_reports_its_builder():
    v0, e1, e2 = _random_tris(300, np.random.default_rng(2))
    nodes, perm = TB.build_bvh_sah(v0, e1, e2)
    threaded, perm2, builder = TB.build_threaded(v0, e1, e2)
    span = P.setup_spans()[-1]  # the build's set-up span
    assert builder in ("native", "numpy") and span["name"] == "bvh.build" and span["end_ns"] > span["start_ns"]
    np.testing.assert_array_equal(perm2, perm)
    _assert_trees_equal(threaded, TB.thread_bvh(nodes))
    covered = np.zeros(300, bool)
    for s, c in zip(nodes.start, nodes.count):
        covered[s : s + c] = True
    assert covered.all() and sorted(perm.tolist()) == list(range(300))


@pytest.mark.parametrize("kind", ["random", "box_field"])
def test_thread_bvh_bit_equal(kind):
    v0, e1, e2 = _tris(kind, np.random.default_rng(3))
    nodes, _ = JB.build_bvh_sah(v0, e1, e2)
    ref = JB.thread_bvh(nodes)
    out = TB.thread_bvh(TB.BvhNodes(*(np.asarray(x) for x in nodes)))
    _assert_trees_equal(out, ref)
    # the layout the kernels rely on: left child at i + 1, right child at skip[i + 1]
    internal = np.nonzero(out.count[:-1] == 0)[0]
    assert (out.skip[internal + 1] > internal + 1).all() and out.skip[-1] == len(out.count)


def test_pack_nodes_round_trip():
    v0, e1, e2 = _random_tris(700, np.random.default_rng(4))
    threaded = TB.thread_bvh(TB._build_bvh_numpy(v0, e1, e2, TB.MAX_LEAF)[0])
    rows = TB.pack_nodes(threaded)
    assert rows.dtype == np.int32 and rows.shape == (len(threaded.count), 8)
    np.testing.assert_array_equal(rows[:, 0:3].view(np.float32), threaded.bb_min)
    np.testing.assert_array_equal(rows[:, 3:6].view(np.float32), threaded.bb_max)
    np.testing.assert_array_equal(rows[:, 6], threaded.skip)
    np.testing.assert_array_equal(rows[:, 7] >> 3, threaded.start)
    np.testing.assert_array_equal(rows[:, 7] & 7, threaded.count)


# ---------------------------------------------------------------------------
# traversal on a tree carried across from the JAX package
# ---------------------------------------------------------------------------


class _Case:
    """Triangles in the JAX builder's leaf order, its threaded tree, and rays."""

    def __init__(self, kind, seed, nray):
        rng = np.random.default_rng(seed)
        v0, e1, e2 = _tris(kind, rng)
        ntri = v0.shape[0]
        mask = np.ones(ntri, np.int32)
        mask[rng.random(ntri) < 0.3] = 4  # light proxies: hit by PRIMARY rays only
        nodes, perm = JB.build_bvh_sah(v0, e1, e2)
        self.tris = tuple(a[perm] for a in (v0, e1, e2, mask))
        self.threaded = JB.thread_bvh(nodes)
        self.jbvh = JB.ThreadedBvh(*(jnp.asarray(x) for x in self.threaded))
        self.tbvh = TB.device_bvh(tuple(np.asarray(x) for x in self.threaded), "cpu")
        if kind == "box_field":  # from above the field, looking down and across
            o = rng.uniform([-4, 0.5, -4], [4, 5, 4], (nray, 3))
            d = rng.normal(size=(nray, 3)) - np.array([0.0, 0.7, 0.0])
        else:
            o = rng.uniform(-12, 12, (nray, 3))
            d = rng.normal(size=(nray, 3))
        self.o = o.astype(np.float32)
        self.d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        self.tmin = rng.uniform(0.0, 0.3, nray).astype(np.float32)
        self.tmax = rng.choice([1e16, 4.0, 12.0], nray).astype(np.float32)
        self.active = rng.random(nray) > 0.1
        self.exclude = np.where(rng.random(nray) < 0.3, rng.integers(0, ntri, nray), -1).astype(np.int32)

    def jax(self, ray_mask, any_hit=False, exclude=True):
        v0, e1, e2, mask = (jnp.asarray(a) for a in self.tris)
        return JB.intersect_bvh(
            self.jbvh, v0, e1, e2, mask, jnp.asarray(self.o), jnp.asarray(self.d), jnp.asarray(self.tmin),
            jnp.asarray(self.tmax), ray_mask, active=jnp.asarray(self.active), any_hit=any_hit,
            exclude=jnp.asarray(self.exclude) if exclude else None,
        )

    def torch_args(self, ray_mask, exclude=True):
        tv = lambda a: torch.tensor(np.ascontiguousarray(a))  # noqa: E731
        o = tuple(tv(self.o[:, k]) for k in range(3))
        d = tuple(tv(self.d[:, k]) for k in range(3))
        tmax = tv(np.where(self.active, self.tmax, 0.0).astype(np.float32))  # as ops/intersect.py passes `active`
        return (o, d, tv(self.tmin), tmax, tv(self.exclude) if exclude else None, self.tbvh,
                *(tv(a) for a in self.tris), ray_mask)

    def shim(self):
        class Shim:
            pass

        s = Shim()
        s.v0, s.e1, s.e2, s.geom_mask = (jnp.asarray(a) for a in self.tris)
        s.bvh = None
        return s


_CASES = [("random", 11, 400), ("box_field", 12, 400)]


@pytest.mark.parametrize("kind,seed,nray", _CASES)
@pytest.mark.parametrize("exclude", [True, False])
def test_plain_closest_matches_intersect_bvh(kind, seed, nray, exclude):
    case = _Case(kind, seed, nray)
    t_r, p_r, u_r, v_r = (np.asarray(x) for x in case.jax(RAY_MASK_PRIMARY, exclude=exclude))
    K.reset_counts()
    t, p, u, v = (x.numpy() for x in KB.bvh_closest(*case.torch_args(RAY_MASK_PRIMARY, exclude=exclude)))
    assert K.launch_counts["bvh_closest"] == 0 and not any(K.plain_cuda_calls.values())
    assert (p_r >= 0).sum() > nray // 10  # the case exercises hits
    np.testing.assert_array_equal(p, p_r)
    np.testing.assert_allclose(t, t_r, rtol=2e-6)
    np.testing.assert_allclose(u, u_r, rtol=1e-6, atol=2e-5)
    np.testing.assert_allclose(v, v_r, rtol=1e-6, atol=2e-5)
    assert (p[~case.active] == -1).all() and (t[p < 0] == np.float32(1e16)).all()
    hit = p >= 0
    assert (t[hit] > case.tmin[hit]).all() and (t[hit] < case.tmax[hit]).all()
    if exclude:
        assert (p[hit] != case.exclude[hit]).all()


@pytest.mark.parametrize("kind,seed,nray", _CASES)
def test_plain_any_matches_intersect_bvh(kind, seed, nray):
    case = _Case(kind, 100 + seed, nray)
    occ_r = np.asarray(case.jax(RAY_MASK_SHADOW, any_hit=True)[1]) >= 0
    occ = KB.bvh_any(*case.torch_args(RAY_MASK_SHADOW)).numpy()
    assert 0 < occ_r.sum() < nray
    np.testing.assert_array_equal(occ, occ_r)
    # the shadow mask leaves out the light proxies: fewer rays are occluded than under the primary mask
    occ_primary = KB.bvh_any(*case.torch_args(RAY_MASK_PRIMARY)).numpy()
    assert (occ_primary | ~occ).all() and occ_primary.sum() > occ.sum()


@pytest.mark.parametrize("kind,seed,nray", _CASES)
def test_plain_traversal_matches_bruteforce(kind, seed, nray):
    case = _Case(kind, 200 + seed, nray)
    jargs = (jnp.asarray(case.o), jnp.asarray(case.d), jnp.asarray(case.tmin), jnp.asarray(case.tmax))
    ref = JX.intersect_closest_bruteforce(case.shim(), *jargs, RAY_MASK_PRIMARY, active=jnp.asarray(case.active),
                                          exclude=jnp.asarray(case.exclude))
    t, p, _, _ = (x.numpy() for x in KB.bvh_closest(*case.torch_args(RAY_MASK_PRIMARY)))
    p_r, t_r = np.asarray(ref.prim), np.asarray(ref.t)
    np.testing.assert_array_equal(p >= 0, p_r >= 0)
    hits = p >= 0
    np.testing.assert_allclose(t[hits], t_r[hits], rtol=1e-4)
    assert (p == p_r)[hits].mean() > 0.99
    occ_r = JX.intersect_any_bruteforce(case.shim(), *jargs, RAY_MASK_SHADOW, active=jnp.asarray(case.active),
                                        exclude=jnp.asarray(case.exclude))
    occ = KB.bvh_any(*case.torch_args(RAY_MASK_SHADOW)).numpy()
    np.testing.assert_array_equal(occ, np.asarray(occ_r))


def test_plain_traversal_matches_pallas_superblock_kernels():
    """pallas_intersect_closest / _any (the superblock sweep K5/K6 replace), in interpret mode."""
    case = _Case("random", 31, 300)
    v0, e1, e2, mask = case.tris
    tmax = np.where(case.active, case.tmax, 0.0).astype(np.float32)
    packed = pack_tris(v0, e1, e2, mask, tblk=128)
    bounds = block_bounds(v0, e1, e2, mask, tblk=128)
    jrays = (jnp.asarray(case.o), jnp.asarray(case.d), jnp.asarray(case.tmin), jnp.asarray(tmax))
    t_r, p_r = pallas_intersect_closest(packed, bounds, *jrays, RAY_MASK_PRIMARY, exclude=jnp.asarray(case.exclude),
                                        tile=256, tblk=128, interpret=True)
    occ_r = pallas_intersect_any(packed, bounds, *jrays, RAY_MASK_SHADOW, exclude=jnp.asarray(case.exclude),
                                 tile=256, tblk=128, interpret=True)
    t, p, _, _ = (x.numpy() for x in KB.bvh_closest(*case.torch_args(RAY_MASK_PRIMARY)))
    occ = KB.bvh_any(*case.torch_args(RAY_MASK_SHADOW)).numpy()
    t_r, p_r = np.asarray(t_r), np.asarray(p_r)
    differ = p != p_r
    both = (p >= 0) & (p_r >= 0)
    assert both.sum() > 30
    assert not (differ & ~(both & (np.abs(t - t_r) <= 1e-5 * np.abs(t_r)))).any()
    np.testing.assert_allclose(t[both], t_r[both], rtol=2e-4)
    np.testing.assert_array_equal(occ, np.asarray(occ_r))


def test_dead_lanes_and_tmax_limits():
    case = _Case("random", 41, 200)
    args = list(case.torch_args(RAY_MASK_PRIMARY))
    t_full, p_full, _, _ = KB.bvh_closest(*args)
    # tmax = 0 everywhere: no lane walks, every lane misses
    args[3] = torch.zeros_like(args[3])
    t, p, u, v = KB.bvh_closest(*args)
    assert (p == -1).all() and (t == 1e16).all() and (u == 0).all() and (v == 0).all()
    assert not KB.bvh_any(*args).any()
    # tmax just short of each hit drops it; just beyond keeps it
    hit = p_full >= 0
    args[3] = torch.where(hit, t_full * (1 - 1e-4), 0.0)
    assert (KB.bvh_closest(*args)[0][hit] != t_full[hit]).all()
    args[3] = torch.where(hit, t_full * (1 + 1e-4), 0.0)
    t2, p2, _, _ = KB.bvh_closest(*args)
    assert torch.equal(p2[hit], p_full[hit]) and torch.equal(t2[hit], t_full[hit])
    assert KB.bvh_any(*args)[hit].all()


def test_traversal_counts_and_priming():
    """counts=True reports the walk; primed with the final t a ray visits no more nodes and finds nothing closer."""
    case = _Case("box_field", 51, 300)
    args = case.torch_args(RAY_MASK_PRIMARY)
    t, p, _, _, walk = TB.intersect_bvh_plain(*args, counts=True)
    live = int((args[3] > args[2]).sum())
    assert walk.nodes_visited >= walk.nodes_overlapped >= live and walk.tri_tests > 0 and walk.steps > 1
    _, p2, _, _, ideal = TB.intersect_bvh_plain(*args, prime_t=t, counts=True)
    assert (p2 == -1).all()  # strict t < best t: the final hit is not found again
    assert ideal.nodes_visited <= walk.nodes_visited and ideal.nodes_overlapped <= walk.nodes_overlapped
    assert ideal.tri_tests <= walk.tri_tests
    # distinct nodes and triangles touched: at most the tree, at most the visits
    assert 0 < walk.nodes_touched <= min(case.tbvh.num_nodes, walk.nodes_overlapped)
    assert 0 < walk.tris_touched <= min(args[6].shape[0], walk.tri_tests)
    assert ideal.nodes_touched <= walk.nodes_touched and ideal.tris_touched <= walk.tris_touched


def test_dispatch_takes_the_bvh_when_the_scene_has_one():
    """ops.intersect on a built scene: the BVH walk and the flat sweep of the same triangles agree."""
    import dataclasses

    from strelka_tpu_torch.ops import intersect as TX
    from strelka_tpu_torch.ops.vec import Vec3
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.scene import testscenes as TTS

    scene = build_device_scene(TTS.box_field(grid=3), device="cpu")
    assert scene.bvh is not None
    flat = dataclasses.replace(scene, bvh=None)
    rng = np.random.default_rng(71)
    n = 300
    o = rng.uniform([-3, 0.2, -3], [3, 4, 3], (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)) - np.array([0.0, 0.5, 0.0])
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    vec = lambda a: Vec3(*(torch.tensor(np.ascontiguousarray(a[:, k])) for k in range(3)))  # noqa: E731
    tmin, tmax = torch.zeros(n), torch.full((n,), 1e16)
    active = torch.tensor(rng.random(n) > 0.1)
    calls = []
    walk = KB.bvh_closest
    KB.bvh_closest = lambda *a: calls.append("bvh") or walk(*a)
    try:
        hit = TX.intersect_closest(scene, vec(o), vec(d), tmin, tmax, RAY_MASK_PRIMARY, active=active)
        ref = TX.intersect_closest(flat, vec(o), vec(d), tmin, tmax, RAY_MASK_PRIMARY, active=active)
    finally:
        KB.bvh_closest = walk
    assert calls == ["bvh"]
    assert (hit.prim >= 0).sum() > n // 4 and (hit.prim[~active] == -1).all()
    assert torch.equal(hit.prim >= 0, ref.prim >= 0)
    differ = hit.prim != ref.prim
    assert not (differ & (torch.abs(hit.t - ref.t) > 1e-5 * torch.abs(ref.t))).any()  # the tie rule
    same = ~differ
    assert torch.equal(hit.t[same], ref.t[same]) and torch.equal(hit.u[same], ref.u[same])
    occ = TX.intersect_any(scene, vec(o), vec(d), tmin, torch.full((n,), 3.0), RAY_MASK_SHADOW, exclude=hit.prim)
    occ_ref = TX.intersect_any(flat, vec(o), vec(d), tmin, torch.full((n,), 3.0), RAY_MASK_SHADOW, exclude=hit.prim)
    assert torch.equal(occ, occ_ref) and 0 < int(occ.sum()) < n


def test_cuda_wrapper_takes_no_cpu_tree_on_cuda_tensors():
    """On a CUDA tensor the wrapper launches its kernel or raises; without a card it can only raise."""
    case = _Case("random", 61, 16)
    args = list(case.torch_args(RAY_MASK_PRIMARY))
    meta = [torch.empty(16, device="meta") for _ in range(3)]
    with pytest.raises((RuntimeError, ValueError)):
        KB.bvh_closest(tuple(meta), tuple(meta), meta[0], meta[0], None, *args[5:])
