"""Render-layer features of the port: upscaling and row bands.

(a) `render.resize_bilinear` (F.interpolate, bilinear, half-pixel centres,
    antialiased) is within 1e-6 of jax.image.resize(..., "bilinear") at
    factors 0.5, 0.75 and 1.5, on [H, W, 4] images in [0, 1], alpha included;
(b) tests/test_render_features.py:57's upscale case on the port, and the
    upscaled frame equal bit for bit to a frame traced at the reduced size
    and resized;
(c) `render_launch` in 4 row bands over ["cpu"] * 4 (parallel/sharding.py:
    shard_launch) equals the unbanded launch bit for bit at 32x32, in the
    accumulators and the image, and so does TorchRender(use_sharding=True)
    (tests/test_render_features.py:70 on the port);
(d) one band (py_offset=8, full_height=32) agrees with the JAX render_launch
    given the same arguments, to tests/test_torch_render.py's tolerance for
    16x16 launches (99% of pixels within rtol 1e-3, means within 1e-3
    relative), and equals rows 8..23 of the port's whole launch bit for bit;
(e) no band tensor changes device inside a launch (the counterpart of
    tests/test_render_features.py:86, which finds no collective in the
    sharded program): shard_launch(check_devices=True) sees none, and does
    see one in a launch that moves its state to another device;
(f) a checkpoint written by a banded render resumes in an unbanded one (and
    the other way) bit-exact;
(g) the copy of a device scene a band device gets holds every tensor there;
(h) TorchRender(use_sharding=True) on ["cpu"] * 4 keeps one launch a band
    per config key (eager on the CPU; a band on a card is a GraphLaunch)
    and equals the unbanded render across a camera move and a checkpoint
    loaded into the running renderer.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strelka_tpu.ops import integrator as JI
from strelka_tpu.render.device_scene import build_device_scene as jax_build
from strelka_tpu.scene import testscenes as JTS
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.parallel.sharding import make_band_state, shard_launch
from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
from strelka_tpu_torch.render.device_scene import build_device_scene
from strelka_tpu_torch.render.render import RenderFactory, resize_bilinear
from strelka_tpu_torch.scene import testscenes as TTS
from strelka_tpu_torch.settings import SharedContext, make_default_settings

_CORNELL = dict(light_intensity=5000.0, metal_box=True, glass_sphere=True)
_EXPOSURE = np.full(3, 6.25e-4, np.float32)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: with several, torch 2.13's CPU sqrt can be wrong on
    its first call in a fresh worker thread (ROADMAP.md section C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _make(width=32, height=32, spp=2, total=4, **kw):
    s = make_default_settings(width, height)
    s.set("render/pt/sppTotal", total)
    s.set("render/pt/spp", spp)
    ctx = SharedContext(s)
    r = RenderFactory.create_render(device="cpu", **kw)
    r.set_scene(TTS.cornell_box(light_intensity=5000.0))
    r.set_shared_context(ctx)
    r.init()
    return r, ctx, r.create_buffer(BufferDesc(width, height, BufferFormat.FLOAT4)), s


@pytest.mark.parametrize("factor", [0.5, 0.75, 1.5])
def test_resize_matches_jax_image_resize(factor):
    img = np.random.default_rng(int(factor * 4)).random((32, 48, 4), dtype=np.float32)
    h, w = int(32 * factor), int(48 * factor)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (h, w, 4), method="bilinear"))
    out = resize_bilinear(torch.from_numpy(img), h, w).numpy()
    assert out.shape == ref.shape == (h, w, 4)
    assert np.abs(out - ref).max() <= 1e-6


def test_upscale_renders_at_reduced_resolution():
    r, ctx, buf, s = _make(width=64, height=64, spp=2, total=2)
    s.set("render/pt/enableUpscale", True)
    s.set("render/pt/upscaleFactor", 0.5)
    r.render(buf)
    img = buf.map()
    assert img.shape == (64, 64, 4)
    assert not np.isnan(img).any()
    assert img[..., :3].max() > 0.0
    assert r._state.accum.shape == (3, 32, 32)  # internal state is at half resolution
    small, _, sbuf, _ = _make(width=32, height=32, spp=2, total=2)
    small.render(sbuf)
    np.testing.assert_array_equal(img, resize_bilinear(sbuf.device(), 64, 64).numpy())


def _launch_setup(w=32, h=32, spp=2):
    host = TTS.cornell_box(light_intensity=5000.0)
    cam = host.get_camera(0)
    cam.update_aspect_ratio(w / h)
    params = TI.LaunchParams(0, np.asarray(cam.clip_to_view(), np.float32), np.asarray(cam.view_to_world(), np.float32),
                             _EXPOSURE, np.zeros(3, np.float32))
    kw = dict(width=w, samples_per_launch=spp, max_sample_count=100000, max_depth=4, enable_accumulation=True)
    return build_device_scene(host, device="cpu"), params, kw


def _make_launch(kw):
    def make_launch(local_h, full_h):
        def launch(scene, params, state, py_offset):
            state, planar = TI.render_launch(scene, params, state, height=local_h, py_offset=py_offset,
                                             full_height=full_h, **kw)
            return state, planar.permute(1, 2, 0)  # [local_h, W, 3], as shard_launch gathers rows
        return launch
    return make_launch


def test_four_bands_equal_the_unbanded_launch():
    scene, params, kw = _launch_setup()
    whole_state, whole = TI.render_launch(scene, params, TI.make_frame_state(32, 32, "cpu"), height=32, **kw)
    banded = shard_launch(_make_launch(kw), ["cpu"] * 4, check_devices=True)
    bands, image = banded(scene, params, make_band_state(32, 32, banded.devices))
    assert len(bands.bands) == 4 and bands.bands[0].accum.shape == (3, 8, 32)
    assert banded.crossings == []
    assert torch.equal(image, whole.permute(1, 2, 0))
    for i, band in enumerate(bands.bands):
        for name in TI.FrameState._fields:
            assert torch.equal(getattr(band, name), getattr(whole_state, name)[..., 8 * i:8 * (i + 1), :]), name


def test_band_count_must_divide_the_height():
    scene, params, kw = _launch_setup()
    with pytest.raises(ValueError, match="not divisible by 3"):
        make_band_state(32, 32, ["cpu"] * 3)


def test_sharded_render_matches_single_device():
    """tests/test_render_features.py:70 on the port: two frames, 4 bands on the CPU."""
    r1, _, buf1, _ = _make()
    r2, _, buf2, _ = _make(use_sharding=True, band_devices=["cpu"] * 4)
    for _ in range(2):
        r1.render(buf1)
        r2.render(buf2)
        np.testing.assert_array_equal(buf2.map(), buf1.map())


def test_band_launch_matches_jax():
    w, h, fh, off = 16, 16, 32, 8
    host = JTS.cornell_box(**_CORNELL)
    cam = host.get_camera(0)
    cam.update_aspect_ratio(w / fh)
    c2v, v2w = np.asarray(cam.clip_to_view(), np.float32), np.asarray(cam.view_to_world(), np.float32)
    kw = dict(width=w, samples_per_launch=1, max_sample_count=100000, max_depth=4, enable_accumulation=True,
              full_height=fh)
    jp = JI.LaunchParams(jnp.int32(0), jnp.asarray(c2v), jnp.asarray(v2w), jnp.asarray(_EXPOSURE), jnp.zeros(3))
    with jax.disable_jit():  # op by op: about 14 s here against a 50 s compile
        _, jimg = JI.render_launch(jax_build(host), jp, JI.make_frame_state(h, w), height=h,
                                   py_offset=jnp.uint32(off), **kw)
    ref = np.asarray(jimg)

    tds = build_device_scene(TTS.cornell_box(**_CORNELL), device="cpu")
    tp = TI.LaunchParams(0, c2v, v2w, _EXPOSURE, np.zeros(3, np.float32))
    _, band = TI.render_launch(tds, tp, TI.make_frame_state(h, w, "cpu"), height=h, py_offset=off, **kw)
    out = band.numpy()
    assert out.shape == ref.shape == (3, h, w)
    pixel_ok = np.isclose(out, ref, rtol=1e-3, atol=0.0).all(axis=0)
    assert pixel_ok.mean() >= 0.99, f"{pixel_ok.mean():.4f} of pixels within rtol 1e-3"
    assert abs(out.mean() - ref.mean()) <= 1e-3 * abs(ref.mean())
    _, whole = TI.render_launch(tds, tp, TI.make_frame_state(fh, w, "cpu"), height=fh,
                                **{k: v for k, v in kw.items() if k != "full_height"})
    assert torch.equal(band, whole[:, off:off + h])


def test_a_band_tensor_changing_device_is_seen():
    scene, params, kw = _launch_setup(w=16, h=16, spp=1)
    inner = _make_launch(kw)

    def make_launch(local_h, full_h):
        launch = inner(local_h, full_h)

        def moved(scene, params, state, py_offset):
            state = TI.FrameState(*(t.to("meta") for t in state))  # a band tensor leaves its device
            return launch(scene, params, TI.make_frame_state(local_h, 16, "cpu"), py_offset)[0], state.accum
        return moved

    banded = shard_launch(make_launch, ["cpu"] * 2, check_devices=True)
    with pytest.raises(RuntimeError, match="changed device"):
        banded(scene, params, make_band_state(16, 16, banded.devices))
    assert banded.crossings and all(c[1] == "cpu" and c[2] == ["meta"] for c in banded.crossings)


def test_scene_to_moves_every_tensor():
    """The copy of a device scene each band device gets (parallel/sharding.py:scene_to), on the meta device."""
    from strelka_tpu_torch.parallel.sharding import scene_to

    scene = build_device_scene(TTS.box_field(grid=3), device="cpu")
    copy = scene_to(scene, torch.device("meta"))
    assert copy.device == torch.device("meta") and copy.bvh.nodes.device == torch.device("meta")
    for f in dataclasses.fields(scene):
        a, b = getattr(scene, f.name), getattr(copy, f.name)
        if isinstance(a, torch.Tensor):
            assert b.device.type == "meta" and b.shape == a.shape and b.dtype == a.dtype, f.name
        elif not dataclasses.is_dataclass(a):
            assert a == b, f.name


@pytest.mark.parametrize("first, second", [(True, False), (False, True)])
def test_checkpoint_across_bands_is_bitexact(tmp_path, first, second):
    ref, _, rbuf, _ = _make(spp=2, total=4)
    for _ in range(2):
        ref.render(rbuf)
    r1, _, buf1, _ = _make(spp=2, total=4, use_sharding=first, band_devices=["cpu"] * 4)
    r1.render(buf1)
    ckpt = str(tmp_path / "state.npz")
    r1.save_checkpoint(ckpt)
    r2, ctx2, buf2, _ = _make(spp=2, total=4, use_sharding=second, band_devices=["cpu"] * 4)
    r2.load_checkpoint(ckpt)
    r2.render(buf2)
    assert ctx2.subframe_index == 4
    np.testing.assert_array_equal(buf2.map(), rbuf.map())


def test_banded_render_equals_unbanded_across_camera_move_and_checkpoint(tmp_path):
    r1, ctx1, buf1, _ = _make(spp=1, total=8)
    r2, ctx2, buf2, _ = _make(spp=1, total=8, use_sharding=True, band_devices=["cpu"] * 4)

    def frame():
        for r, buf in ((r1, buf1), (r2, buf2)):
            r.render(buf)
        np.testing.assert_array_equal(buf2.map(), buf1.map())
        assert ctx1.subframe_index == ctx2.subframe_index

    frame()
    frame()
    for r in (r1, r2):
        r.get_scene().get_camera(0).translate(np.array([0.1, 0.0, 0.0], np.float32))
    frame()
    assert ctx2.subframe_index == 1  # the move reset the accumulation
    ckpt = str(tmp_path / "state.npz")
    r1.save_checkpoint(ckpt)
    states = r2._state.bands
    for r in (r1, r2):
        r.load_checkpoint(ckpt)
    assert all(a is b for a, b in zip(r2._state.bands, states))  # loaded into the band states in place
    frame()
    frame()
    (banded,) = r2._launch_cache.values()
    (fns,) = banded.bands.values()  # one launch a band, kept between frames
    assert len(fns) == 4 and not any(hasattr(fn, "reset") for fn in fns)  # CPU bands stay eager


def test_bands_on_a_card_get_their_own_graph_launch():
    """shard_launch's graph_launch wraps the bands on CUDA devices only, each
    with its py_offset bound, once per local height; wrapper.reset reaches
    them. Nothing runs: the bands are built, not launched."""
    class Recorder:
        def __init__(self, launch, device):
            self.launch, self.device, self.resets = launch, device, []

        def reset(self, pool):
            self.resets.append(pool)

    banded = shard_launch(lambda lh, fh: (lambda scene, params, state, py_offset: (lh, fh, py_offset)),
                          [torch.device("cuda", 0), "cpu"], graph_launch=Recorder)
    fns = banded.band_launches(8)
    assert banded.band_launches(8) is fns and isinstance(fns[0], Recorder) and not isinstance(fns[1], Recorder)
    assert fns[0].device == torch.device("cuda", 0)
    assert fns[0].launch(None, None, None) == (8, 16, 0) and fns[1](None, None, None) == (8, 16, 8)
    banded.reset("pool")
    assert fns[0].resets == ["pool"]
