"""The port's texture system (strelka_tpu_torch/textures.py) against the JAX
package's (strelka_tpu/textures.py), on the CPU.

(a) `build_atlas` is bit-equal to the JAX one (`data`, `rects`, `meta`,
    `size`; the mip levels are rects and texels of the sheet): `add_array`
    images (RGB and RGBA, wrap and clamp, HDR values for the u8 scale, one
    wider than the sheet), a volume, a cubemap, and kitchen's four PNGs
    through `load` (sRGB and linear). u8 and f32 sheets, with and without
    mips. PNGs that are grey, grey+alpha, RGB and RGBA load as PIL loads
    them; an image over the manager's `max_dim` on an edge is shrunk as the
    JAX manager shrinks it (the same atlas), and `resize_rgba_bilinear` is
    bit-equal to PIL's RGBA resize(..., BILINEAR) on hypothesis-drawn
    sizes, shrink factors and alpha (0 and 255 among them).
(b) Each sampling function (bilinear, trilinear, stochastic trilinear, 3D,
    cube, normal map) against its JAX counterpart on 4096 seeded lanes
    (negative and out-of-range uv, tex ids -1..n, lod from -14 to 3):
    the same texel addressing (base texel, fractions and the stochastic
    texel's sheet coordinates, read through a sheet whose texels hold their
    own coordinates), and values within 1e-6 relative (XLA's and torch's
    pow may differ by an ulp). Once without and once with the smootherstep
    warp.
(c) The stochastic lookups' uniforms (`integrator.tex_uniforms`) are
    bit-equal to the JAX integrator's expression, at depths 0-3, slots 0-3.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

import strelka_tpu.textures as JT
import strelka_tpu_torch.textures as TT
from strelka_tpu.ops import sampler as JS
from strelka_tpu.ops.vec import gather_rows_t as jax_rows_t
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.scene.kitchen import KITCHEN_TEXTURES, kitchen_dir

N = 4096
RTOL = 1e-6


def _images(rng):
    hdr = rng.random((16, 32, 4)).astype(np.float32) * 4.0  # u8 sheets store it with a scale
    return [
        (rng.random((64, 64, 3)).astype(np.float32), JT.ADDRESS_WRAP),
        (hdr, JT.ADDRESS_CLAMP),
        (rng.random((20, 300, 3)).astype(np.float32), JT.ADDRESS_WRAP),  # wider than a 256 sheet
        (rng.random((1, 1, 3)).astype(np.float32), JT.ADDRESS_CLAMP),
    ]


def _managers(atlas_size=256):
    """A JAX and a port TextureManager, given the same textures in the same order."""
    rng = np.random.default_rng(11)
    images = _images(rng)
    vol = rng.random((4, 8, 8, 4)).astype(np.float32)
    cube = rng.random((6, 8, 8, 3)).astype(np.float32)
    managers = []
    for mod in (JT, TT):
        tm = mod.TextureManager(atlas_size=atlas_size, search_path=kitchen_dir())
        ids = [tm.add_array(im, address_mode=mode) for im, mode in images]
        ids.append(tm.add_volume(vol))
        ids.append(tm.add_cubemap(cube))
        ids += [tm.load(os.path.join("textures", t), srgb=True) for t in KITCHEN_TEXTURES]
        ids.append(tm.load(os.path.join("textures", KITCHEN_TEXTURES[0]), srgb=False))
        managers.append((tm, ids))
    return managers


def _assert_atlas_equal(ja, ta):
    assert ta.size == ja.size
    for name in ("data", "rects", "meta"):
        j, t = np.asarray(getattr(ja, name)), np.asarray(getattr(ta, name))
        assert j.dtype == t.dtype and j.shape == t.shape, name
        assert np.array_equal(j, t), name


@pytest.mark.parametrize("dtype,mipmaps", [("u8", True), ("u8", False), ("f32", True)])
def test_build_atlas_matches_jax(dtype, mipmaps):
    (jtm, jids), (ttm, tids) = _managers()
    assert jids == tids
    ja = jtm.build_atlas(dtype=dtype, mipmaps=mipmaps)
    ta = ttm.build_atlas(dtype=dtype, mipmaps=mipmaps)
    _assert_atlas_equal(ja, ta)
    rects = np.asarray(ta.rects)
    if mipmaps:
        # a 256x256 PNG has 9 levels (256 .. 1); the first PNG's chain follows its base
        png = tids[-5]
        assert rects[png, TT.RC_COUNT] == 9
        assert rects[rects[png, TT.RC_BASE] + 7, TT.RC_W] == 1


def test_kitchen_textures_match_jax():
    """Kitchen's four PNGs as build_device_scene loads them (sRGB), alone."""
    atlases = []
    for mod in (JT, TT):
        tm = mod.TextureManager(search_path=kitchen_dir())
        assert [tm.load(os.path.join("textures", t)) for t in KITCHEN_TEXTURES] == [0, 1, 2, 3]
        atlases.append(tm.build_atlas())
    _assert_atlas_equal(*atlases)
    assert atlases[1].data.shape == (1376, 256, 4) and atlases[1].rects.shape == (36, 9)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
def test_png_modes_load_as_pil(tmp_path, mode):
    rng = np.random.default_rng(5)
    channels = len(mode)
    px = rng.integers(0, 256, (9, 13, channels), dtype=np.uint8)
    path = str(tmp_path / f"{mode}.png")
    Image.fromarray(px[..., 0] if channels == 1 else px, mode).save(path)
    atlases = []
    for mod in (JT, TT):
        tm = mod.TextureManager()
        assert tm.load(path, srgb=(mode != "LA")) == 0
        atlases.append(tm.build_atlas())
    _assert_atlas_equal(*atlases)


def test_oversized_image_raises(tmp_path):
    """An image over max_dim texels an edge no longer raises: both managers
    shrink it (PIL's bilinear resize in the JAX one, resize_rgba_bilinear in
    the port) and build the same atlas. A missing file is still -1."""
    rng = np.random.default_rng(8)
    cases = {"wide": rng.integers(0, 256, (7, 45, 3), dtype=np.uint8),
             "tall_rgba": rng.integers(0, 256, (77, 20, 4), dtype=np.uint8)}
    cases["tall_rgba"][::3, :, 3] = 0
    cases["tall_rgba"][1::3, :, 3] = 255
    for name, px in cases.items():
        path = str(tmp_path / f"{name}.png")
        Image.fromarray(px).save(path)
        atlases = []
        for mod in (JT, TT):
            tm = mod.TextureManager(atlas_size=32)
            assert tm.load(path) == 0
            atlases.append(tm.build_atlas())
        _assert_atlas_equal(*atlases)
    tm = TT.TextureManager()
    assert tm.load(str(tmp_path / "missing.png")) == -1


@settings(max_examples=60, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40), fy=st.floats(0.05, 1.0), fx=st.floats(0.05, 1.0),
       alpha=st.sampled_from(["random", "binary", "opaque", "clear"]), seed=st.integers(0, 2**16))
def test_resize_matches_pil(h, w, fy, fx, alpha, seed):
    rng = np.random.default_rng(seed)
    px = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
    if alpha == "binary":
        px[..., 3] = rng.choice([0, 255], (h, w))
    elif alpha != "random":
        px[..., 3] = 255 if alpha == "opaque" else 0
    size = (max(1, int(w * fx)), max(1, int(h * fy)))
    ref = np.asarray(Image.fromarray(px, "RGBA").resize(size, Image.BILINEAR))
    assert np.array_equal(TT.resize_rgba_bilinear(px, *size), ref)


@pytest.fixture(params=[False, True], ids=["plain", "smootherstep"])
def smootherstep(request, monkeypatch):
    monkeypatch.setattr(JT, "SMOOTHERSTEP", request.param)
    monkeypatch.setattr(TT, "SMOOTHERSTEP", request.param)
    return request.param


@pytest.fixture(scope="module")
def atlases():
    (jtm, jids), (ttm, _) = _managers()
    ja = jtm.build_atlas()
    ta = TT.atlas_to_device(ttm.build_atlas(), "cpu")
    # the same rects over a sheet whose texels hold their own (x, y)
    h, w = ta.data.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    probe = np.stack([xx, yy, np.zeros_like(xx), np.ones_like(xx)], -1)
    return ja, ta, ja._replace(data=jnp.asarray(probe)), ta._replace(data=torch.tensor(probe)), jids


def _inputs(n_tex, seed=3):
    rng = np.random.default_rng(seed)
    return dict(
        tex_id=rng.integers(-1, n_tex + 1, N).astype(np.int32),
        uv=rng.uniform(-3.0, 3.0, (N, 2)).astype(np.float32),
        lod=rng.uniform(-14.0, 3.0, N).astype(np.float32),
        rnd3=tuple(rng.random(N).astype(np.float32) for _ in range(3)),
        uvw=rng.uniform(-2.0, 2.0, (N, 3)).astype(np.float32),
        direction=rng.normal(size=(N, 3)).astype(np.float32),
    )


def _close(port, ref, what):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape, what
    np.testing.assert_allclose(port, ref, rtol=RTOL, atol=0.0, err_msg=what)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.tensor(a)


def test_texel_setup_matches_jax(atlases, smootherstep):
    """Base texel, filter fractions and wrapped/clamped addresses of every
    lane's level-0 rect."""
    ja, ta, _, _, ids = atlases
    x = _inputs(len(ids))
    tid = np.clip(x["tex_id"], 0, ta.rects.shape[0] - 1)
    jr = jax_rows_t(ja.rects, _j(tid))
    tr = TT._rows_t(ta.rects, _t(tid))
    jout = JT._texel_setup(jr, _j(x["uv"]))
    tout = TT._texel_setup(tr, _t(x["uv"]))
    for k, name in enumerate(("xb", "yb", "tx", "ty")):
        assert np.array_equal(np.asarray(jout[k]), tout[k].numpy()), name
    w, h = tr[TT.RC_W], tr[TT.RC_H]
    for delta in (-1, 0, 1, 2):
        assert np.array_equal(np.asarray(jout[4](jout[0] + delta, jr[TT.RC_W])), tout[4](tout[0] + delta, w).numpy())
        assert np.array_equal(np.asarray(jout[4](jout[1] + delta, jr[TT.RC_H])), tout[4](tout[1] + delta, h).numpy())


def test_bilinear_matches_jax(atlases, smootherstep):
    ja, ta, _, _, ids = atlases
    x = _inputs(len(ids))
    _close(TT.sample_bilinear(ta, _t(x["tex_id"]), _t(x["uv"])),
           JT.sample_bilinear(ja, _j(x["tex_id"]), _j(x["uv"])), "bilinear")


def test_trilinear_matches_jax(atlases, smootherstep):
    ja, ta, _, _, ids = atlases
    x = _inputs(len(ids))
    _close(TT.sample_trilinear(ta, _t(x["tex_id"]), _t(x["uv"]), _t(x["lod"])),
           JT.sample_trilinear(ja, _j(x["tex_id"]), _j(x["uv"]), _j(x["lod"])), "trilinear")


def test_stochastic_trilinear_matches_jax(atlases, smootherstep):
    """The same texel on every lane (its sheet coordinates read through the
    probe sheet), then the decoded value."""
    ja, ta, jprobe, tprobe, ids = atlases
    x = _inputs(len(ids))
    targs = (_t(x["tex_id"]), _t(x["uv"]), _t(x["lod"]), tuple(_t(r) for r in x["rnd3"]))
    jargs = (_j(x["tex_id"]), _j(x["uv"]), _j(x["lod"]), tuple(_j(r) for r in x["rnd3"]))
    t_xy = TT.sample_trilinear_stochastic(tprobe, *targs).numpy()
    j_xy = np.asarray(JT.sample_trilinear_stochastic(jprobe, *jargs))
    live = x["tex_id"] >= 0
    assert np.array_equal(t_xy[live, :2], j_xy[live, :2]), \
        f"{int((t_xy[live, :2] != j_xy[live, :2]).any(-1).sum())} lanes read another texel"
    assert len(np.unique(t_xy[live, :2], axis=0)) > 500  # levels and texels vary
    _close(TT.sample_trilinear_stochastic(ta, *targs), JT.sample_trilinear_stochastic(ja, *jargs), "stochastic")


def test_3d_and_cube_match_jax(atlases, smootherstep):
    ja, ta, _, _, ids = atlases
    x = _inputs(len(ids))
    vol, cube = ids[4], ids[5]
    for head in (vol, cube, 0, -1):
        tid = np.where(x["tex_id"] >= 0, head, -1).astype(np.int32)
        _close(TT.sample_3d(ta, _t(tid), _t(x["uvw"])), JT.sample_3d(ja, _j(tid), _j(x["uvw"])), f"3d {head}")
        _close(TT.sample_cube(ta, _t(tid), _t(x["direction"])),
               JT.sample_cube(ja, _j(tid), _j(x["direction"])), f"cube {head}")


def test_normal_map_matches_jax():
    rng = np.random.default_rng(9)
    n, t, b = (rng.normal(size=(N, 3)).astype(np.float32) for _ in range(3))
    tex = rng.random((N, 3)).astype(np.float32)
    tex[:7] = 0.5  # a zero tangent-space vector keeps the normal
    _close(TT.apply_normal_map(_t(n), _t(t), _t(b), _t(tex)),
           JT.apply_normal_map(_j(n), _j(t), _j(b), _j(tex)), "normal map")


def _jax_tex_rnd(sample_idx, depth, slot):
    """The JAX integrator's uniforms (strelka_tpu/ops/integrator.py, the
    texture block of trace_paths, with ray_id the identity)."""
    n = sample_idx.shape[0]
    rid = jnp.arange(n, dtype=jnp.int32)
    seed = JS.hash_combine(JS.hash_u32(sample_idx), rid.astype(jnp.uint32) * jnp.uint32(2654435761) + jnp.uint32(depth))
    h = JS.hash_u32(JS.hash_combine(seed, jnp.uint32(slot + 1)))
    h2 = JS.hash_u32(h ^ jnp.uint32(0x68BC21EB))
    h3 = JS.hash_u32(h ^ jnp.uint32(0x02E5BE93))
    to_f = lambda u: (u >> jnp.uint32(8)).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))  # noqa: E731
    return (to_f(h), to_f(h2), to_f(h3))


@pytest.mark.parametrize("depth", range(4))
def test_tex_uniforms_match_jax(depth):
    rng = np.random.default_rng(depth)
    idx = rng.integers(0, 2**32, N, dtype=np.uint64).astype(np.uint32)
    idx[:4] = (0, 1, 2**31, 2**32 - 1)
    rnd = TI.tex_uniforms(torch.tensor(idx.astype(np.int64)), torch.arange(N, dtype=torch.int32), depth)
    for slot in range(4):
        for k, (t, j) in enumerate(zip(rnd(slot), _jax_tex_rnd(jnp.asarray(idx), depth, slot))):
            assert t.dtype == torch.float32
            assert np.array_equal(t.numpy(), np.asarray(j)), f"slot {slot} component {k}"


def test_tex_stochastic_flag(monkeypatch):
    monkeypatch.delenv("STRELKA_TEX_STOCHASTIC", raising=False)
    assert TI.tex_stochastic()
    monkeypatch.setenv("STRELKA_TEX_STOCHASTIC", "0")
    assert not TI.tex_stochastic()
    monkeypatch.setenv("STRELKA_TEX_STOCHASTIC", "1")
    assert TI.tex_stochastic()
