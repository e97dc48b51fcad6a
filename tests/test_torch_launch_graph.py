"""The port's launch cache (render/render.py: TorchRender._launch_cache) and
the launch it caches, on the CPU.

On the card each config key is one CUDA graph (GraphLaunch), captured once
and replayed; chip_smoke.py holds the replays bit-equal to eager launches
there. The CPU has no graphs, so here the cache holds the eager launch and
these tests hold what the graph depends on:

(a) the keys: TorchRender's cache keys equal the JAX TpuRender's for the
    same settings sequence (an spp budget that ends in a smaller launch, a
    gamma change, two debug views). TpuRender._build_launch is replaced by
    a stub that records its key, so no XLA compile runs;
(b) the bookkeeping: frames through TorchRender across a camera move, the
    budget's end, a resize and back, a rebuilt scene and a checkpoint
    resume equal, image and state, bit for bit, a model that calls
    render_launch directly with the values each frame should get;
(c) LaunchParams as tensors (plain tensors, and views into GraphLaunch's
    value buffer) equal the same launch with an int and numpy arrays, bit
    for bit, on a flat, a BVH and a textured scene, at subframe 0 and above;
(d) no host read inside a launch: render_launch with tensor LaunchParams on
    a flat, a BVH, a curve and a textured scene runs no
    aten._local_scalar_dense (.item(), int(t), bool(t)) and no aten.nonzero
    outside the plain versions of the kernels, which stand in for the
    kernels on the CPU and may read. A read is a host sync on the card and
    would fail a capture.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from strelka_tpu.render import buffer as JB
from strelka_tpu.render import render as JR
from strelka_tpu.scene import testscenes as JTS
from strelka_tpu.settings import SharedContext as JaxContext
from strelka_tpu.settings import make_default_settings as jax_settings
from strelka_tpu_torch.kernels import bvh as KB
from strelka_tpu_torch.kernels import cones as KC
from strelka_tpu_torch.kernels import gather as KG
from strelka_tpu_torch.kernels import intersect as KI
from strelka_tpu_torch.kernels import open_w as KO
from strelka_tpu_torch.kernels import sobol as KS
from strelka_tpu_torch.ops import integrator as I
from strelka_tpu_torch.ops import tonemap as TM
from strelka_tpu_torch.render import render as R
from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
from strelka_tpu_torch.render.device_scene import build_device_scene
from strelka_tpu_torch.scene import testscenes as TTS
from strelka_tpu_torch.scene.kitchen import kitchen_dir
from strelka_tpu_torch.settings import SharedContext, make_default_settings

_CORNELL = dict(light_intensity=5000.0, metal_box=True, glass_sphere=True)
W = H = 16
DEPTH = 2


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: with several, torch 2.13's CPU sqrt can be wrong on
    its first call in a fresh worker thread (ROADMAP.md section C)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _settings(make, w=W, h=H, spp=2, total=5):
    s = make(w, h)
    s.set("render/pt/sppTotal", total)
    s.set("render/pt/spp", spp)
    s.set("render/pt/depth", DEPTH)
    return s


# ---- (a) the keys --------------------------------------------------------


def _drive_keys(render, host, settings, context, desc, fmt):
    """The settings sequence of (a) through one renderer -> its cache's keys."""
    render.set_scene(host)
    render.set_shared_context(context(settings))
    render.init()
    buf = render.create_buffer(desc(W, H, fmt.FLOAT4))
    render.render(buf)  # 2 spp from sample 0
    settings.set("render/post/gamma", 1.8)  # not a watched key: accumulation goes on
    render.render(buf)  # 2 spp
    render.render(buf)  # the budget's last sample: a 1-spp key
    render.render(buf)  # the budget is spent: no launch
    settings.set("render/pt/debug", 1)  # normals: 1 spp, no accumulation
    render.render(buf)
    settings.set("render/pt/debug", 2)  # the diffuse AOV, from sample 0 again
    render.render(buf)
    render.render(buf)
    return set(render._launch_cache)


def test_launch_keys_match_tpu_render(monkeypatch):
    def stub(self, key):
        width, height = key[0], key[1]

        def launch(scene, params, state):
            return state, jnp.zeros((height, width, 4), jnp.float32)

        self._launch_cache[key] = launch
        return launch

    monkeypatch.setattr(JR.TpuRender, "_build_launch", stub)
    jax_keys = _drive_keys(JR.TpuRender(), JTS.cornell_box(**_CORNELL), _settings(jax_settings), JaxContext,
                           JB.BufferDesc, JB.BufferFormat)
    port_keys = _drive_keys(R.TorchRender(device="cpu"), TTS.cornell_box(**_CORNELL),
                            _settings(make_default_settings), SharedContext, BufferDesc, BufferFormat)
    assert len(jax_keys) == 5
    assert port_keys == jax_keys


# ---- (b) the cache's bookkeeping -----------------------------------------


class Direct:
    """What each TorchRender frame should be: render_launch called directly
    with the frame's values, its own device scene, state and sample count."""

    def __init__(self, host, settings):
        self.host, self.s = host, settings
        self.scene = build_device_scene(host, device="cpu")
        self.state, self.sub = None, 0

    def resize(self, w, h):
        self.state, self.sub = I.make_frame_state(h, w, "cpu"), 0

    def frame(self, w, h):
        s = self.s
        spl = min(s.get_int("render/pt/spp"), s.get_int("render/pt/sppTotal") - self.sub)
        exposure = TM.compute_exposure_value(s)
        tm_type, gamma = s.get_int("render/pt/tonemapperType"), s.get_float("render/post/gamma")
        if spl <= 0:
            return R._post(self.state.accum, 0, tm_type, exposure, gamma)
        cam = self.host.get_camera(0)
        cam.update_aspect_ratio(w / h)
        params = I.LaunchParams(self.sub, np.asarray(cam.clip_to_view(), np.float32),
                                np.asarray(cam.view_to_world(), np.float32), exposure,
                                np.asarray(s.get("render/bgColor"), np.float32))
        self.state, planar = I.render_launch(
            self.scene, params, self.state, width=w, height=h, samples_per_launch=spl,
            max_sample_count=s.get_int("render/pt/sppTotal"), max_depth=DEPTH, enable_accumulation=True)
        self.sub += spl
        return R._post(planar, 0, tm_type, exposure, gamma)


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (-0.0 is not 0.0, a NaN equals the same NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    return torch.equal(a, b)


def test_cache_frames_equal_direct_launches(tmp_path):
    host = TTS.cornell_box(**_CORNELL)
    s = _settings(make_default_settings)
    r = R.TorchRender(device="cpu")
    r.set_scene(host)
    r.set_shared_context(SharedContext(s))
    r.init()
    model = Direct(host, s)  # its own device scene of the same host scene: a camera move moves both
    size = (W, H)
    buf = r.create_buffer(BufferDesc(W, H, BufferFormat.FLOAT4))
    model.resize(W, H)
    checkpoint = str(tmp_path / "ckpt.npz")
    log = []

    def frame(what):
        r.render(buf)
        want = model.frame(*size)
        assert _same(buf.device(), want), f"{what}: the image differs from the direct launch"
        for name, got, ref in zip(I.FrameState._fields, r._state, model.state):
            assert _same(got, ref), f"{what}: state.{name} differs from the direct launch"
        assert r.get_shared_context().subframe_index == model.sub, what
        log.append((what, model.sub))

    frame("first launch")
    frame("second launch")
    r.save_checkpoint(checkpoint)
    saved = ([t.clone() for t in model.state], model.sub)
    frame("the budget's last sample")
    frame("the budget spent: re-emit")
    host.get_camera(0).translate(np.array([0.1, 0.0, 0.0], np.float32))
    model.sub = 0
    frame("camera move")
    for size in ((24, 16), (W, H)):
        buf = r.create_buffer(BufferDesc(*size, BufferFormat.FLOAT4))
        model.resize(*size)
        frame(f"resize to {size}")
    host.dirty = True
    model.scene, model.sub = build_device_scene(model.host, device="cpu"), 0
    frame("rebuilt scene")
    r.load_checkpoint(checkpoint)
    model.state, model.sub = I.FrameState(*saved[0]), saved[1]
    frame("checkpoint resume")
    frame("resumed budget spent: re-emit")
    assert [sub for _, sub in log] == [2, 4, 5, 5, 2, 2, 2, 2, 5, 5]
    assert len(r._launch_cache) == 3  # 16x16 at 2 and 1 spp, 24x16 at 2


# ---- (c) tensor and host LaunchParams ------------------------------------


def _textured_cornell():
    host = TTS.cornell_box(**_CORNELL)
    white = host.materials[0]
    assert white.name == "white"
    white.params = dict(white.params, diffuse_texture=os.path.join(kitchen_dir(), "textures", "wood.png"),
                        uv_scale=np.array([2.0, 2.0], np.float32))
    return host


SCENES = {
    "cornell": lambda: TTS.cornell_box(**_CORNELL),
    "box_field": lambda: TTS.box_field(grid=6),  # 6,436 triangles: a BVH
    "hair_patch": lambda: TTS.hair_patch(n_curves=16),
    "textured": _textured_cornell,
}


def _host_params(host, sub):
    cam = host.get_camera(0)
    cam.update_aspect_ratio(W / H)
    return I.LaunchParams(sub, np.asarray(cam.clip_to_view(), np.float32), np.asarray(cam.view_to_world(), np.float32),
                          np.full(3, 6.25e-4, np.float32), np.array([0.1, 0.2, 0.3], np.float32))


def _tensor_params(params):
    """The values as plain CPU tensors (cone_spread left to render_launch)."""
    return I.LaunchParams(torch.tensor(params.subframe_index, dtype=torch.int32),
                          *(torch.from_numpy(np.array(v, np.float32)) for v in params[1:5]))


def _buffer_params(params):
    """The values as GraphLaunch reads them: views into one f32 buffer."""
    return R.unpack_values(torch.from_numpy(R.pack_values(params._replace(cone_spread=I.ray_cone_spread(params, H)))))


def _scene(name):
    host = SCENES[name]()
    scene = build_device_scene(host, device="cpu")
    assert (scene.bvh is not None) == (name == "box_field")
    assert (scene.textures is not None) == (name == "textured")
    return host, scene


@pytest.mark.parametrize("name", ["cornell", "box_field", "textured"])
def test_tensor_params_equal_host_params(name):
    host, scene = _scene(name)
    kw = dict(width=W, height=H, samples_per_launch=2, max_sample_count=64, max_depth=DEPTH,
              enable_accumulation=True)
    state = I.make_frame_state(H, W, "cpu")
    for sub in (0, 2):  # the first launch starts the AOVs afresh, the second accumulates into them
        params = _host_params(host, sub)
        want_state, want = I.render_launch(scene, params, state, **kw)
        assert int(want_state.diffuse_counter.sum()) > 0
        for make in (_tensor_params, _buffer_params):
            got_state, got = I.render_launch(scene, make(params), state, **kw)
            assert _same(got, want), f"{make.__name__} at subframe {sub}: image"
            for field, a, b in zip(I.FrameState._fields, got_state, want_state):
                assert _same(a, b), f"{make.__name__} at subframe {sub}: {field}"
        state = want_state


# ---- (d) no host read inside a launch ------------------------------------

_READS = (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default)
# the plain versions of K1-K9, which the wrappers call on CPU tensors
_PLAIN = ((KS, "random_dims_plain"), (KI, "closest_plain"), (KI, "any_plain"), (KB, "closest_plain"),
          (KB, "any_plain"), (KC, "closest_plain"), (KC, "any_plain"), (KG, "gather_rows_t_plain"),
          (KO, "open_w_plain"), (KO, "sweep_order_plain"))


class HostReads(TorchDispatchMode):
    """Records the ops that read a tensor's value on the host, except while
    a plain kernel version runs (`paused`)."""

    def __init__(self):
        super().__init__()
        self.paused = 0
        self.reads = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _READS and not self.paused:
            self.reads.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", list(SCENES))
def test_no_host_read_inside_a_launch(name, monkeypatch):
    _check_no_host_read(name, monkeypatch)


@pytest.mark.parametrize("name", list(SCENES))
def test_no_host_read_inside_an_ordered_launch(name, monkeypatch):
    """The card's wavefront order (Z-order pixels, the bounce sort, the
    packed permutes), forced on the CPU, reads nothing on the host either:
    a captured launch takes it as it is."""
    monkeypatch.delenv("STRELKA_NO_ZORDER", raising=False)
    monkeypatch.setattr(I, "accelerated", lambda scene: True)
    _check_no_host_read(name, monkeypatch, sort_rays=True)


def _check_no_host_read(name, monkeypatch, **launch_kw):
    host, scene = _scene(name)
    mode = HostReads()
    ran = []

    def pausing(fn, label):
        def plain(*args, **kwargs):
            ran.append(label)
            mode.paused += 1
            try:
                return fn(*args, **kwargs)
            finally:
                mode.paused -= 1

        return plain

    for module, attr in _PLAIN:
        monkeypatch.setattr(module, attr, pausing(getattr(module, attr), f"{module.__name__}.{attr}"))
    state = I.make_frame_state(H, W, "cpu")
    params = _buffer_params(_host_params(host, 2))
    with mode:
        I.render_launch(scene, params, state, width=W, height=H, samples_per_launch=2, max_sample_count=64,
                        max_depth=DEPTH, enable_accumulation=True, **launch_kw)
    assert ran, "no plain kernel version ran"
    assert mode.reads == [], f"{name}: host reads inside the launch: {mode.reads}"
    # the recorder sees a read outside the plain versions
    with mode:
        int(params.subframe_index)
    assert mode.reads == [str(torch.ops.aten._local_scalar_dense.default)]
