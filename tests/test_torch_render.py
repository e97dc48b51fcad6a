"""The port's main paths (Cornell, box_field) against the JAX package and the golden image.

(a) render_launch at 16x16, 1 spp, depth 4 against the JAX render_launch on
    the same scene and parameters: at least 99% of pixels within rtol 1e-3
    and the image means within 1e-3 relative. sin/cos ULP differences
    between XLA and torch may flip a borderline path or two.
(b) TorchRender(device="cpu") at bench.GOLDEN_CONFIGS["cornell"] reaches
    SSIM >= 0.99 against goldens/cornell_golden.png (an f32 CPU render of
    the JAX package); (c) its buffer holds no NaN.
(d) Entry points default to the CUDA card and raise without one.
(e) render_launch of box_field(grid=6) (6,436 triangles, on a BVH) at 16x16
    against the JAX render_launch, at (a)'s tolerance, on the JAX scene
    carried across with device_scene_from_arrays (tables and tree), so the
    comparison does not depend on the two BVH builders agreeing.
"""

import dataclasses

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strelka_tpu.ops import integrator as JI
from strelka_tpu.render.device_scene import build_device_scene as jax_build
from strelka_tpu.scene import testscenes as JTS
from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
from strelka_tpu_torch.render.device_scene import build_device_scene, device_scene_from_arrays
from strelka_tpu_torch.render.render import RenderFactory, RenderType, TorchRender
from strelka_tpu_torch.scene import testscenes as TTS
from strelka_tpu_torch.settings import SharedContext, make_default_settings
from strelka_tpu_torch.utils.image import read_png, ssim

_CORNELL = dict(light_intensity=5000.0, metal_box=True, glass_sphere=True)
_GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "goldens",
                       "cornell_golden.png")
GOLDEN_CONFIG = (64, 64, 4, 4)  # bench.GOLDEN_CONFIGS["cornell"]: w, h, spp per launch, launches


def _carried_across(jds):
    """The JAX DeviceScene as the port's, field by field through numpy."""
    arrays = {f.name: np.asarray(getattr(jds, f.name)) for f in dataclasses.fields(jds)
              if not isinstance(getattr(jds, f.name), tuple)}
    if jds.bvh is not None:
        arrays["bvh"] = tuple(np.asarray(x) for x in jds.bvh)
    return device_scene_from_arrays(arrays, "cpu")


def test_render_launch_matches_jax():
    _compare_render_launch(JTS.cornell_box(**_CORNELL), lambda jds: build_device_scene(
        TTS.cornell_box(**_CORNELL), device="cpu"))


def test_render_launch_box_field_matches_jax():
    K.reset_counts()
    tds = _compare_render_launch(JTS.box_field(grid=6), _carried_across)
    assert tds.bvh is not None and tds.num_triangles == 6436
    assert not any(K.launch_counts.values())  # CPU tensors ran the plain traversal


def _compare_render_launch(host, port_scene):
    w = h = 16
    cam = host.get_camera(0)
    cam.update_aspect_ratio(1.0)
    c2v = np.asarray(cam.clip_to_view(), np.float32)
    v2w = np.asarray(cam.view_to_world(), np.float32)
    exposure = np.full(3, 6.25e-4, np.float32)
    kw = dict(width=w, height=h, samples_per_launch=1, max_sample_count=100000, max_depth=4,
              enable_accumulation=True)

    jp = JI.LaunchParams(jnp.int32(0), jnp.asarray(c2v), jnp.asarray(v2w), jnp.asarray(exposure), jnp.zeros(3))
    launch = jax.jit(lambda scene, params, state: JI.render_launch(scene, params, state, **kw))
    jds = jax_build(host)
    jstate, jimg = launch(jds, jp, JI.make_frame_state(h, w))
    ref = np.asarray(jimg)

    tp = TI.LaunchParams(0, c2v, v2w, exposure, np.zeros(3, np.float32))
    tds = port_scene(jds)
    # one torch thread: with several, torch 2.13's CPU sqrt can be wrong on
    # its first call in a fresh worker thread (ROADMAP.md section C)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tstate, timg = TI.render_launch(tds, tp, TI.make_frame_state(h, w, "cpu"), **kw)
    finally:
        torch.set_num_threads(threads)
    out = timg.numpy()

    assert out.shape == ref.shape == (3, h, w)
    pixel_ok = np.isclose(out, ref, rtol=1e-3, atol=0.0).all(axis=0)
    assert pixel_ok.mean() >= 0.99, f"{pixel_ok.mean():.4f} of pixels within rtol 1e-3"
    assert abs(out.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())
    # the AOV counters follow the first-bounce event types
    for name in ("diffuse_counter", "specular_counter"):
        agree = getattr(tstate, name).numpy() == np.asarray(getattr(jstate, name))
        assert agree.mean() >= 0.99
    return tds


@pytest.fixture(scope="module")
def golden_render():
    w, h, spp, launches = GOLDEN_CONFIG
    s = make_default_settings(w, h)
    s.set("render/pt/sppTotal", spp * launches)
    s.set("render/pt/spp", spp)
    r = RenderFactory.create_render(RenderType.eTorch, device="cpu")
    r.set_scene(TTS.cornell_box(**_CORNELL))
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(w, h, BufferFormat.FLOAT4))
    K.reset_counts()
    for _ in range(launches):
        r.render(buf)
    return r, buf, buf.map().copy()


def test_golden_ssim(golden_render):
    _, _, img = golden_render
    golden = read_png(_GOLDEN)[..., :3]
    assert ssim(np.clip(img[..., :3], 0.0, 1.0), golden) >= 0.99


def test_golden_render_finite_and_on_cpu(golden_render):
    r, buf, img = golden_render
    assert img.shape == (64, 64, 4) and not np.isnan(img).any()
    assert (img[..., 3] == 1.0).all()
    assert r.get_shared_context().subframe_index == 16
    assert not any(K.launch_counts.values())  # CPU tensors ran the plain versions


def test_budget_exhausted_reemits_accumulated_image(golden_render):
    r, buf, img = golden_render
    r.render(buf)  # sppTotal reached: no launch, same image
    np.testing.assert_array_equal(buf.map(), img)


def test_debug_normals_view():
    s = make_default_settings(16, 16)
    s.set("render/pt/debug", 1)
    s.set("render/post/gamma", 0.0)
    r = TorchRender(device="cpu")
    r.set_scene(TTS.cornell_box())
    r.set_shared_context(SharedContext(s))
    buf = r.create_buffer(BufferDesc(16, 16, BufferFormat.FLOAT4))
    r.render(buf)
    img = buf.map()[..., :3]
    # surface pixels show (n + 1) / 2 of unit normals; the light keeps its emission
    as_normal = ((img >= 0.0) & (img <= 1.0 + 1e-6)).all(axis=-1)
    assert img.min() >= 0.0 and as_normal.mean() >= 0.9


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RenderFactory.create_render(RenderType.eTorch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchRender()
