"""The accelerator path's wavefront order (ops/integrator.py: Z-order pixels,
the bounce sort, the packed permute through K4) against the JAX package.

(a) the Z-order tables (pixel_zorder, built by device ops) bit-equal to
    the reference's _pixel_zorder at square, odd and the showcase's sizes;
(b) vec.octant, and DeviceScene.world_lo / world_hi, equal to the JAX
    build's on Cornell, a small box_field and a small hair_patch (the hair
    scene's bounds are its ground quad's: curves clip, as in the reference);
(c) _ray_sort_key bit-equal and _sort_wavefront's stable permutation (and
    the columns it permutes) equal on seeded rays with dead lanes and
    origins outside the world box;
(d) _permute_packed bit-equal to table[perm].T on int values under 2^23
    (f32 subnormals when their bits are read as floats), NaN patterns and
    bools;
(e) trace_paths(sort_rays=True) against JAX's trace_paths(sort_rays=True)
    at 16x16, 1 spp, depth 4 on the Cornell box built on a BVH (its 548
    triangles) and on a textured Cornell box (flat), on the same rays, at tests/test_torch_render.py's bar (99%
    of pixels within rtol 1e-3, means within 1e-3 relative, AOV event types
    equal on 99% of lanes);
(f) the ordered render_launch, forced on the CPU by monkeypatching
    integrator.accelerated (the reference's use_pallas), against a helper
    that builds JAX's Z-order wavefront as its render_launch does
    (:1044-1067) and calls JAX's trace_paths: on the textured Cornell box
    at 10x6, 2 spp (a size that is no power of 2), where the stochastic texel
    uniforms are keyed by Z-rank and must be bit-equal lane for lane;
(g) the port sorted, Z-ordered and both against the port unsorted on an
    untextured scene: bit-equal. This holds on the CPU at this size under
    one torch thread; on the card chip_smoke.py holds it on the main paths.

The JAX functions run eagerly, as in tests/test_torch_textured_render.py:
no whole-launch compile (under jax.disable_jit but for the BVH walk, whose
while loop runs compiled).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import strelka_tpu.textures as JT
import strelka_tpu_torch.textures as TT
from strelka_tpu.ops import integrator as JI
from strelka_tpu.ops import sampler as JS
from strelka_tpu.ops import vec as JV
from strelka_tpu.render.device_scene import build_device_scene as jax_build
from strelka_tpu.scene import testscenes as JTS
from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.ops import sampler as TS_
from strelka_tpu_torch.ops import vec as TV
from strelka_tpu_torch.render.device_scene import build_device_scene, device_scene_from_arrays
from strelka_tpu_torch.scene import testscenes as TTS
from strelka_tpu_torch.scene.kitchen import kitchen_dir
from strelka_tpu_torch.utils import profiling as P

WOOD = os.path.join(kitchen_dir(), "textures", "wood.png")
_CORNELL = dict(light_intensity=5000.0, metal_box=True, glass_sphere=True)
EXPOSURE = np.full(3, 6.25e-4, np.float32)
MAX_SPP = 100000


@pytest.fixture
def one_thread():
    # torch 2.13's CPU sqrt can be wrong on its first call in a fresh worker
    # thread when several run (ROADMAP.md section C)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _carried_across(jds, bounds: bool = True):
    """The JAX DeviceScene as the port's, field by field through numpy, its
    atlas included, and its world bounds where `bounds`."""
    arrays = {f.name: np.asarray(getattr(jds, f.name)) for f in dataclasses.fields(jds)
              if not isinstance(getattr(jds, f.name), tuple)}
    for name in ("bvh", "curves", "cones"):
        if getattr(jds, name) is not None:
            arrays[name] = tuple(np.asarray(x) for x in getattr(jds, name))
    if bounds:
        arrays["world_lo"], arrays["world_hi"] = jds.world_lo, jds.world_hi
    if jds.textures is not None:
        atlas = jds.textures
        arrays["textures"] = {"data": np.asarray(atlas.data), "rects": np.asarray(atlas.rects),
                              "size": atlas.size, "meta": np.asarray(atlas.meta)}
    return device_scene_from_arrays(arrays, "cpu")


def _textured_cornell():
    host = JTS.cornell_box(**_CORNELL)
    white = host.materials[0]
    assert white.name == "white"
    white.params = dict(white.params, diffuse_texture=WOOD, uv_scale=np.array([2.0, 2.0], np.float32))
    return host


# ---- (a)-(d) the tables, keys and permutes


@pytest.mark.parametrize("size", [(1, 1), (37, 23), (64, 64), (1024, 768)])
def test_pixel_zorder_matches_jax(size):
    w, h = size
    jz, jinv = JI._pixel_zorder(w, h)
    tz, tinv = TI.pixel_zorder(w, h, "cpu")
    assert tz.dtype == torch.int64 and tinv.dtype == torch.int32
    assert np.array_equal(tz.numpy(), jz) and np.array_equal(tinv.numpy(), jinv)
    assert np.array_equal(np.sort(jz), np.arange(w * h))
    assert TI.pixel_zorder(w, h, "cpu")[0] is tz  # cached


@pytest.mark.parametrize("name", ["cornell", "box_field", "hair_patch"])
def test_world_bounds_and_octant_match_jax(name):
    make = {"cornell": lambda m: m.cornell_box(**_CORNELL), "box_field": lambda m: m.box_field(grid=6),
            "hair_patch": lambda m: m.hair_patch(n_curves=16)}[name]
    jds = jax_build(make(JTS))
    tds = build_device_scene(make(TTS), device="cpu")
    assert tds.world_lo == jds.world_lo and tds.world_hi == jds.world_hi
    assert all(isinstance(x, float) for x in tds.world_lo + tds.world_hi)
    assert _carried_across(jds).world_lo == jds.world_lo
    d = np.random.default_rng(1).normal(size=(3, 4096)).astype(np.float32)
    d[:, :8] = [[0.0, -0.0, 1.0, -1.0, 0.0, 2.0, -3.0, 0.0]] * 3  # zeros of both signs are not positive
    j = np.asarray(JV.octant(JV.Vec3(*(jnp.asarray(c) for c in d))))
    t = TV.octant(TV.Vec3(*(torch.tensor(c) for c in d)))
    assert t.dtype == torch.int32 and np.array_equal(t.numpy(), j)


def test_world_bounds_without_triangles():
    """A scene without triangles takes the unit box in both builds, and a
    scene carried across without bounds takes it too."""
    from strelka_tpu.scene.scene import Scene as JaxScene
    from strelka_tpu_torch.scene.scene import Scene

    jds, tds = jax_build(JaxScene()), build_device_scene(Scene(), device="cpu")
    assert tds.num_triangles == 0 and (tds.world_lo, tds.world_hi) == (jds.world_lo, jds.world_hi)
    assert (tds.world_lo, tds.world_hi) == ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))
    carried = _carried_across(jax_build(JTS.cornell_box(**_CORNELL)), bounds=False)
    assert (carried.world_lo, carried.world_hi) == ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0))


def _rays(n: int, seed: int, lo, hi):
    """Seeded rays: origins over the world box grown by half its extent on
    each side (a fifth of them outside it), directions of any octant (some
    components zero), a third of the lanes dead."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(lo), np.asarray(hi)
    ext = hi - lo
    o = (lo + rng.uniform(-0.5, 1.5, (n, 3)) * ext).astype(np.float32).T
    d = rng.normal(size=(3, n)).astype(np.float32)
    d[:, rng.random(n) < 0.05] = 0.0
    alive = rng.random(n) >= 1 / 3
    return o, d, alive


@pytest.fixture(scope="module")
def box_scene():
    jds = jax_build(JTS.box_field(grid=6))
    return jds, _carried_across(jds)


def test_ray_sort_key_matches_jax(box_scene):
    jds, tds = box_scene
    o, d, alive = _rays(8192, 2, jds.world_lo, jds.world_hi)
    jkey = np.asarray(JI._ray_sort_key(jds, JV.Vec3(*(jnp.asarray(c) for c in o)),
                                       JV.Vec3(*(jnp.asarray(c) for c in d))))
    tkey = TI._ray_sort_key(tds, TV.Vec3(*(torch.tensor(c) for c in o)), TV.Vec3(*(torch.tensor(c) for c in d)))
    assert tkey.dtype == torch.int32 and np.array_equal(tkey.numpy().astype(np.uint32), jkey)
    assert len(np.unique(jkey)) > 1000  # the key spreads the rays
    # the stable permutation: dead lanes last, equal keys in lane order
    jperm = np.asarray(jnp.argsort(jnp.where(jnp.asarray(alive), jnp.asarray(jkey), jnp.uint32(0xFFFFFFFF))))
    tperm = torch.sort(torch.where(torch.tensor(alive), tkey, TI.DEAD_KEY), stable=True).indices.numpy()
    assert np.array_equal(tperm, jperm)


def test_sort_wavefront_matches_jax(box_scene):
    jds, tds = box_scene
    o, d, alive = _rays(4096, 3, jds.world_lo, jds.world_hi)
    rng = np.random.default_rng(4)
    f32 = [rng.normal(size=4096).astype(np.float32) for _ in range(2)]
    u32 = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)  # sample indices
    i32 = rng.integers(-1, 5000, 4096).astype(np.int32)
    flag = rng.random(4096) < 0.5
    jf, jb = JI._sort_wavefront(jds, JV.Vec3(*(jnp.asarray(c) for c in o)), JV.Vec3(*(jnp.asarray(c) for c in d)),
                                jnp.asarray(alive), [jnp.asarray(c) for c in (*o, *f32)],
                                [jnp.asarray(u32), jnp.asarray(i32), jnp.asarray(flag), jnp.asarray(alive)])
    tf, tb = TI._sort_wavefront(tds, TV.Vec3(*(torch.tensor(c) for c in o)), TV.Vec3(*(torch.tensor(c) for c in d)),
                                torch.tensor(alive), [torch.tensor(c) for c in (*o, *f32)],
                                [torch.tensor(u32.astype(np.int64)), torch.tensor(i32), torch.tensor(flag),
                                 torch.tensor(alive)])
    for j, t in zip(jf, tf):
        assert t.dtype == torch.float32 and np.array_equal(t.numpy().view(np.int32), np.asarray(j).view(np.int32))
    assert tb[0].dtype == torch.int64 and np.array_equal(tb[0].numpy(), np.asarray(jb[0]).astype(np.int64))
    assert tb[1].dtype == torch.int32 and np.array_equal(tb[1].numpy(), np.asarray(jb[1]))
    for k in (2, 3):
        assert tb[k].dtype == torch.bool and np.array_equal(tb[k].numpy(), np.asarray(jb[k]))
    assert not tb[3][int(alive.sum()):].any()  # the dead lanes went to the tail


@pytest.mark.parametrize("n", [1, 300, 4099])
def test_permute_packed_bit_equal(n):
    rng = np.random.default_rng(n)
    perm = rng.permutation(n).astype(np.int32)
    small = rng.integers(-(2**23), 2**23, n).astype(np.int32)  # f32 subnormals when read as floats
    nan_bits = rng.integers(0x7F800001, 0x7FFFFFFF, n).astype(np.int32)  # NaNs, signalling and quiet
    nan_bits[::2] |= np.int32(-(2**31))  # negative NaNs
    nans = nan_bits.view(np.float32)
    u32 = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.int64)
    flags = rng.random(n) < 0.5
    fcols = [torch.tensor(small.view(np.float32)), torch.tensor(nans)]
    bcols = [torch.tensor(small), torch.tensor(u32), torch.tensor(flags)]
    K.reset_counts()
    f, b = TI._permute_packed(torch.tensor(perm), fcols, bcols)
    assert not any(K.launch_counts.values())  # CPU tensors take the plain gather
    assert np.array_equal(f[0].numpy().view(np.int32), small[perm])
    assert np.array_equal(f[1].numpy().view(np.int32), nan_bits[perm])
    assert b[0].dtype == torch.int32 and np.array_equal(b[0].numpy(), small[perm])
    assert b[1].dtype == torch.int64 and np.array_equal(b[1].numpy(), u32[perm])
    assert b[2].dtype == torch.bool and np.array_equal(b[2].numpy(), flags[perm])
    # the same table gathered as table[perm].T
    table = np.stack([small, nan_bits, small, u32.astype(np.uint32).view(np.int32), flags.astype(np.int32)], 1)
    words = np.stack([c.numpy().view(np.int32) if c.dtype == torch.float32 else c.numpy().astype(np.int32)
                      for c in (*f, *b[:1])] + [b[1].numpy().astype(np.uint32).view(np.int32),
                                                b[2].numpy().astype(np.int32)])
    assert np.array_equal(words, table[perm].T)


# ---- (e)-(g) the sorted trace and the ordered launch


def _params(jhost, w, h):
    cam = jhost.get_camera(0)
    cam.update_aspect_ratio(w / h)
    return np.asarray(cam.clip_to_view(), np.float32), np.asarray(cam.view_to_world(), np.float32)


def _jax_wavefront(jds, c2v, v2w, w, h, spl, zorder: bool):
    """JAX's wavefront of one launch as its render_launch builds it
    (:1044-1058): pixels in Z-order or row-major, sample indices, the camera
    rays. Returns (px, py, sample_idx, origin, direction, z_inv or None)."""
    n = w * h
    if zorder:
        z, z_inv = JI._pixel_zorder(w, h)
        px = jnp.tile(jnp.asarray(z % w, jnp.uint32), spl)
        py = jnp.tile(jnp.asarray(z // w, jnp.uint32), spl)
    else:
        idx = jnp.arange(n, dtype=jnp.uint32)
        px, py, z_inv = jnp.tile(idx % jnp.uint32(w), spl), jnp.tile(idx // jnp.uint32(w), spl), None
    s_of_ray = jnp.repeat(jnp.arange(spl, dtype=jnp.uint32), n)
    sample_idx = JS.make_sample_index(px, py, s_of_ray, MAX_SPP)
    jxy = JS.random_dims(sample_idx, 0, (JS.SampleDimension.ePixelX, JS.SampleDimension.ePixelY))
    jp = JI.LaunchParams(jnp.int32(0), jnp.asarray(c2v), jnp.asarray(v2w), jnp.asarray(EXPOSURE), jnp.zeros(3))
    origin, direction = JI.generate_camera_rays(jp, px, py, jxy[0], jxy[1], w, h)
    return jp, sample_idx, origin, direction, z_inv


def _jax_trace(jds, jp, sample_idx, origin, direction, h, sort_rays):
    return JI.trace_paths(jds, jp, sample_idx, origin, direction, max_depth=4, rect_light_sampling_method=0,
                          shadow_ray_tmin=0.0, material_ray_tmin=0.0, debug=0, sort_rays=sort_rays,
                          cone_spread=2.0 * jnp.abs(jp.clip_to_view[1, 1]) / h)


def _close(out, ref, fe_out, fe_ref):
    assert out.shape == ref.shape and np.isfinite(out).all()
    lane_ok = np.isclose(out, ref, rtol=1e-3, atol=0.0).all(axis=0)
    assert lane_ok.mean() >= 0.99, f"{lane_ok.mean():.4f} of lanes within rtol 1e-3"
    assert abs(out.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())
    assert (fe_out == fe_ref).mean() >= 0.99


@pytest.mark.parametrize("name", ["cornell_bvh", "textured_cornell"])
def test_sorted_trace_paths_matches_jax(name, one_thread):
    bvh = name == "cornell_bvh"
    jhost = JTS.cornell_box(**_CORNELL) if bvh else _textured_cornell()
    jds = jax_build(jhost, use_bvh=bvh)
    tds = _carried_across(jds)
    assert (tds.bvh is not None) == bvh and (tds.textures is not None) == (not bvh)
    w = h = 16
    c2v, v2w = _params(jhost, w, h)
    # the BVH walk's while loop runs compiled when jit is on (16 s here,
    # against 47 s under disable_jit, 34 s for a whole-trace jit)
    with jax.disable_jit(not bvh):
        jp, sample_idx, origin, direction, _ = _jax_wavefront(jds, c2v, v2w, w, h, 1, zorder=False)
        jrad, jfe, _ = _jax_trace(jds, jp, sample_idx, origin, direction, h, sort_rays=True)
    # the port traces the same rays (JAX's, as numpy)
    t_idx = torch.tensor(np.asarray(sample_idx).astype(np.int64))
    dims0 = TS_.random_dims(t_idx, 0, (0, 1, 2, 3, 4))
    tp = TI.LaunchParams(0, c2v, v2w, EXPOSURE, np.zeros(3, np.float32))
    K.reset_counts()
    trad, tfe, _ = TI.trace_paths(
        tds, tp, t_idx, TV.Vec3(*(torch.tensor(np.asarray(c)) for c in origin)),
        TV.Vec3(*(torch.tensor(np.asarray(c)) for c in direction)), max_depth=4, rect_light_sampling_method=0,
        shadow_ray_tmin=0.0, material_ray_tmin=0.0, debug=0, depth0_dims=dims0,
        cone_spread=TI.ray_cone_spread(tp, h), sort_rays=True)
    assert not any(K.launch_counts.values())
    out = np.stack([c.numpy() for c in trad])
    _close(out, np.stack([np.asarray(c) for c in jrad]), tfe.numpy(), np.asarray(jfe))
    assert out.max() > 0.0


def _recorder(module, calls):
    real = module.sample_trilinear_stochastic

    def record(atlas, tex_id, uv, lod_uv, rnd3):
        calls.append(tuple(np.asarray(a) for a in rnd3))
        return real(atlas, tex_id, uv, lod_uv, rnd3)

    return record


def test_ordered_launch_matches_jax_zorder_wavefront(monkeypatch, one_thread):
    """Forced on the CPU, render_launch takes the card's order: Z-order
    pixels (no sort: the scene is small), the texel uniforms keyed by the
    Z-rank slot, equal lane for lane to JAX's Z-ordered wavefront; the
    per-pixel means back in row-major order match the helper's."""
    jax_calls, port_calls = [], []
    monkeypatch.setattr(JT, "sample_trilinear_stochastic", _recorder(JT, jax_calls))
    monkeypatch.setattr(TT, "sample_trilinear_stochastic", _recorder(TT, port_calls))
    monkeypatch.delenv("STRELKA_TEX_STOCHASTIC", raising=False)
    monkeypatch.delenv("STRELKA_NO_ZORDER", raising=False)
    jhost = _textured_cornell()
    jds = jax_build(jhost)
    tds = _carried_across(jds)
    w, h, spl = 10, 6, 2
    c2v, v2w = _params(jhost, w, h)
    with jax.disable_jit():
        jp, sample_idx, origin, direction, z_inv = _jax_wavefront(jds, c2v, v2w, w, h, spl, zorder=True)
        jrad, jfe, _ = _jax_trace(jds, jp, sample_idx, origin, direction, h, sort_rays=False)
    n = w * h
    rad = np.stack([np.asarray(c).reshape(spl, n) for c in jrad]).sum(1) / spl  # [3, n] in Z-order
    ref = rad[:, z_inv].reshape(3, h, w)
    fe = np.asarray(jfe).reshape(spl, n)[:, z_inv]

    monkeypatch.setattr(TI, "accelerated", lambda scene: True)
    tp = TI.LaunchParams(0, c2v, v2w, EXPOSURE, np.zeros(3, np.float32))
    K.reset_counts()
    state, img = TI.render_launch(tds, tp, TI.make_frame_state(h, w, "cpu"), width=w, height=h,
                                  samples_per_launch=spl, max_sample_count=MAX_SPP, max_depth=4,
                                  enable_accumulation=False)
    assert not any(K.launch_counts.values())
    # every lookup's uniforms bit-equal: both wavefronts key them by Z-rank
    assert len(port_calls) == 4 and len(jax_calls) == 16
    for depth, (j, t) in enumerate(zip(jax_calls[0::4], port_calls)):
        for k in range(3):
            assert np.array_equal(j[k], t[k]), f"bounce {depth}: uniform {k} differs"
    out = img.numpy()
    pixel_ok = np.isclose(out, ref, rtol=1e-3, atol=0.0).all(axis=0)
    assert pixel_ok.mean() >= 0.99 and abs(out.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())
    d_count = (fe == JI.EventType.eDiffuse).sum(0).reshape(h, w)
    assert (state.diffuse_counter.numpy() == d_count).mean() >= 0.99
    # the row-major launch keys its texels by the linear index: another draw
    port_calls.clear()
    monkeypatch.setattr(TI, "accelerated", lambda scene: False)
    TI.render_launch(tds, tp, TI.make_frame_state(h, w, "cpu"), width=w, height=h, samples_per_launch=spl,
                     max_sample_count=MAX_SPP, max_depth=4, enable_accumulation=False)
    assert not np.array_equal(port_calls[0][0], jax_calls[0][0])


def test_ordered_equals_unordered_untextured(monkeypatch, one_thread):
    """box_field(grid=6), 16x12, 2 spp, depth 4: sorted, Z-ordered, and both
    (the card's path, forced), bit-equal to the row-major unsorted launch in
    image, accum, AOVs and counters, and the recorder's lane counts equal."""
    monkeypatch.delenv("STRELKA_NO_ZORDER", raising=False)
    host = TTS.box_field(grid=6)
    tds = build_device_scene(host, device="cpu")
    w, h = 16, 12
    c2v, v2w = _params(host, w, h)
    tp = TI.LaunchParams(0, c2v, v2w, EXPOSURE, np.zeros(3, np.float32))

    def launch(sort_rays, forced):
        monkeypatch.setattr(TI, "accelerated", lambda scene: forced)
        P.reset()
        P.enable()
        try:
            st, img = TI.render_launch(tds, tp, TI.make_frame_state(h, w, "cpu"), width=w, height=h,
                                       samples_per_launch=2, max_sample_count=MAX_SPP, max_depth=4,
                                       enable_accumulation=True, sort_rays=sort_rays)
        finally:
            P.disable()
        return [img, *st], P.collect()["lanes"]

    base, base_stats = launch(False, False)
    assert float(base[0].mean()) > 0.0 and base_stats["swept"] == [2 * w * h] * 4
    for sort_rays, forced in ((True, False), (False, True), (True, True), (None, True)):
        out, stats = launch(sort_rays, forced)
        for a, b in zip(out, base):
            assert a.dtype == b.dtype and torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                                                      b.view(torch.int32) if b.dtype == torch.float32 else b)
        assert stats == base_stats


def test_default_order_rule(monkeypatch):
    """sort_rays=None sorts on the accelerator path from 16,384 triangles or
    2,048 curve segments, never on the CPU."""
    small = build_device_scene(TTS.cornell_box(**_CORNELL), device="cpu")
    assert not TI.accelerated(small) and not TI.sort_by_default(small)
    monkeypatch.setattr(TI, "accelerated", lambda scene: True)
    assert not TI.sort_by_default(small)
    big = dataclasses.replace(small, num_triangles=16384)
    assert TI.sort_by_default(big)
    assert not TI.sort_by_default(dataclasses.replace(small, num_triangles=16383))
