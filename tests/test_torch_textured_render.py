"""The two USD bench scenes and the texture path through the port's
render_launch, against the JAX package's, on the CPU.

(a) coffeetable (data/scenes/coffeetable.usda, 64 triangles, flat) from the
    port's UsdLoader, render_launch at 16x16, 1 spp, depth 4, against the
    JAX render_launch on the JAX loader's scene;
(b) a textured scene small enough for the CPU: the Cornell box whose white
    material takes kitchen's wood.png as its diffuse texture (through
    TextureManager.load: the PNG reader, the u8 sRGB atlas with its mip
    chain, the ray cone and one-texel stochastic trilinear all run), at
    (a)'s size, on the JAX scene carried across with
    device_scene_from_arrays, its atlas included.
Both at the bar of tests/test_torch_render.py: at least 99% of pixels within
rtol 1e-3, the image means within 1e-3 relative, the AOV counters equal on
99% of pixels. The JAX launches run eagerly (jax.disable_jit): the same
functions, without the whole-launch compile that takes 40 s a scene here.

In (b) every stochastic lookup of both integrators is recorded: the
uniforms must be bit-equal, and the lanes whose mip level or texel differs
(XLA and torch may round log2 of the footprint an ulp apart) are counted
and named in the message; at most 1% may differ.

(c) Kitchen's device tables (105,168 triangles): the port's build from the
    port's crate reader and loader equals the JAX build bit for bit: the
    triangle, attr (with the joined material rows and their texture ids),
    material, light and BVH tables, and the texture atlas. Kitchen is not
    rendered on the CPU.
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
from strelka_tpu.loaders.usd import UsdLoader as JaxUsdLoader
from strelka_tpu.ops import integrator as JI
from strelka_tpu.render.device_scene import build_device_scene as jax_build
from strelka_tpu.scene import testscenes as JTS
from strelka_tpu.scene.scene import Scene as JaxScene
from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.loaders.usd import UsdLoader
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.render.device_scene import TABLES, build_device_scene, device_scene_from_arrays
from strelka_tpu_torch.scene.kitchen import ensure_kitchen, kitchen_dir
from strelka_tpu_torch.scene.scene import Scene

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COFFEETABLE = os.path.join(ROOT, "data", "scenes", "coffeetable.usda")
WOOD = os.path.join(kitchen_dir(), "textures", "wood.png")
_CORNELL = dict(light_intensity=5000.0, metal_box=True, glass_sphere=True)
W = H = 16


def _load(loader, scene, path):
    assert loader().load(path, scene)
    return scene


def _textured_cornell():
    host = JTS.cornell_box(**_CORNELL)
    white = host.materials[0]
    assert white.name == "white"
    white.params = dict(white.params, diffuse_texture=WOOD, uv_scale=np.array([2.0, 2.0], np.float32))
    return host


def _carried_across(jds):
    """The JAX DeviceScene as the port's, field by field through numpy, the
    atlas as a dict of its fields."""
    arrays = {f.name: np.asarray(getattr(jds, f.name)) for f in dataclasses.fields(jds)
              if not isinstance(getattr(jds, f.name), tuple)}
    for name in ("bvh", "curves", "cones"):
        if getattr(jds, name) is not None:
            arrays[name] = tuple(np.asarray(x) for x in getattr(jds, name))
    if jds.textures is not None:
        atlas = jds.textures
        arrays["textures"] = {"data": np.asarray(atlas.data), "rects": np.asarray(atlas.rects),
                              "size": atlas.size, "meta": np.asarray(atlas.meta)}
    return device_scene_from_arrays(arrays, "cpu")


def _render_both(jhost, tds):
    cam = jhost.get_camera(0)
    cam.update_aspect_ratio(1.0)
    c2v = np.asarray(cam.clip_to_view(), np.float32)
    v2w = np.asarray(cam.view_to_world(), np.float32)
    exposure = np.full(3, 6.25e-4, np.float32)
    kw = dict(width=W, height=H, samples_per_launch=1, max_sample_count=100000, max_depth=4,
              enable_accumulation=True)
    jds = jax_build(jhost)
    jp = JI.LaunchParams(jnp.int32(0), jnp.asarray(c2v), jnp.asarray(v2w), jnp.asarray(exposure), jnp.zeros(3))
    with jax.disable_jit():
        jstate, jimg = JI.render_launch(jds, jp, JI.make_frame_state(H, W), **kw)
    tds = tds(jds)
    tp = TI.LaunchParams(0, c2v, v2w, exposure, np.zeros(3, np.float32))
    # one torch thread: with several, torch 2.13's CPU sqrt can be wrong on
    # its first call in a fresh worker thread (ROADMAP.md section C)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        K.reset_counts()
        tstate, timg = TI.render_launch(tds, tp, TI.make_frame_state(H, W, "cpu"), **kw)
        assert not any(K.launch_counts.values())  # CPU tensors ran the plain versions
    finally:
        torch.set_num_threads(threads)
    out, ref = timg.numpy(), np.asarray(jimg)
    assert out.shape == ref.shape == (3, H, W) and np.isfinite(out).all()
    pixel_ok = np.isclose(out, ref, rtol=1e-3, atol=0.0).all(axis=0)
    assert pixel_ok.mean() >= 0.99, f"{pixel_ok.mean():.4f} of pixels within rtol 1e-3"
    assert abs(out.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())
    for name in ("diffuse_counter", "specular_counter"):
        agree = getattr(tstate, name).numpy() == np.asarray(getattr(jstate, name))
        assert agree.mean() >= 0.99, name
    return tds, out


def test_coffeetable_render_launch_matches_jax():
    jhost = _load(JaxUsdLoader, JaxScene(), COFFEETABLE)
    port_host = _load(UsdLoader, Scene(), COFFEETABLE)
    tds, out = _render_both(jhost, lambda jds: build_device_scene(port_host, device="cpu"))
    assert tds.bvh is None and tds.textures is None and tds.v0.shape[0] == 128
    assert out.max() > 0.0


def _recorder(module, calls):
    real = module.sample_trilinear_stochastic

    def record(atlas, tex_id, uv, lod_uv, rnd3):
        calls.append(tuple(np.asarray(a) for a in (tex_id, uv, lod_uv, *rnd3)))
        return real(atlas, tex_id, uv, lod_uv, rnd3)

    return record


def test_textured_cornell_render_launch_matches_jax(monkeypatch):
    jax_calls, port_calls = [], []
    monkeypatch.setattr(JT, "sample_trilinear_stochastic", _recorder(JT, jax_calls))
    monkeypatch.setattr(TT, "sample_trilinear_stochastic", _recorder(TT, port_calls))
    monkeypatch.delenv("STRELKA_TEX_STOCHASTIC", raising=False)
    tds, out = _render_both(_textured_cornell(), _carried_across)
    assert tds.textures is not None and tds.tex_columns == (12,)
    assert tuple(tds.textures.data.shape) == (384, 256, 4) and tds.textures.data.dtype == torch.uint8

    # the JAX integrator looks up all four slots a bounce (diffuse first);
    # the port only the diffuse column, the one a material row uses
    assert len(jax_calls) == 16 and len(port_calls) == 4
    jax_diffuse = jax_calls[0::4]
    atlas = tds.textures
    h, w = atlas.data.shape[:2]
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    probe = atlas._replace(data=torch.tensor(np.stack([xx, yy, np.zeros_like(xx), np.ones_like(xx)], -1)))
    live = off = 0
    for depth, (j, t) in enumerate(zip(jax_diffuse, port_calls)):
        for k in range(3, 6):  # the uniforms
            assert np.array_equal(j[k], t[k]), f"bounce {depth}: uniform {k - 3} differs"
        lanes = (j[0] >= 0) & (t[0] >= 0)
        read = [TT.sample_trilinear_stochastic(probe, *(torch.tensor(a) for a in c[:3]),
                                               tuple(torch.tensor(a) for a in c[3:])).numpy()[:, :2]
                for c in (j, t)]
        live += int(lanes.sum())
        off += int((read[0] != read[1]).any(-1)[lanes].sum())
    assert live > 100
    assert off <= 0.01 * live, f"{off} of {live} textured lanes read another mip level or texel"


@pytest.fixture(scope="module")
def kitchen_tables():
    path = ensure_kitchen()
    jds = jax_build(_load(JaxUsdLoader, JaxScene(), path))
    tds = build_device_scene(_load(UsdLoader, Scene(), path), device="cpu")
    return jds, tds


@pytest.mark.parametrize("name", TABLES)
def test_kitchen_tables_match_jax(kitchen_tables, name):
    jds, tds = kitchen_tables
    j, t = np.asarray(getattr(jds, name)), getattr(tds, name).numpy()
    assert j.dtype == t.dtype and j.shape == t.shape and np.array_equal(j, t), name


def test_kitchen_bvh_and_atlas_match_jax(kitchen_tables):
    jds, tds = kitchen_tables
    assert tds.num_triangles == 105168 and tds.v0.shape[0] == 105216
    for field in ("bb_min", "bb_max", "skip", "start", "count"):
        assert np.array_equal(np.asarray(getattr(jds.bvh, field)), getattr(tds.bvh, field).numpy()), field
    assert tds.bvh.depth <= 64  # within K5's and K6's stack (kernels refuse a deeper tree)
    for field in ("data", "rects", "meta"):
        assert np.array_equal(np.asarray(getattr(jds.textures, field)), getattr(tds.textures, field).numpy())
    assert tds.textures.size == jds.textures.size
    # the four textured materials carry their texture ids in column 12
    ids = tds.mat_table[:, 12].numpy()
    assert sorted(ids[ids >= 0].tolist()) == [0.0, 1.0, 2.0, 3.0] and tds.tex_columns == (12,)
