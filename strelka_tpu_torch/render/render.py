"""Render backend — the PyTorch port of strelka_tpu/render/render.py (layer L1).

Mirrors the per-frame flow of OptiXRender::render (OptixRender.cpp:874-1057):
frame-0 device-scene build, camera/settings change detection resetting
progressive accumulation (:895-934), launch-budget computation (:989-1004),
the launch itself (ops.integrator.render_launch) and tonemap dispatch
(:1045-1049). Launches are cached by their static config key, as the JAX
package caches jax.jit(single, donate_argnums=(2,)) (strelka_tpu/render/
render.py:109-155): on the card each key is one CUDA graph (GraphLaunch),
on the CPU the eager launch. With use_sharding the launch runs in row bands
over several devices (parallel/sharding.py), each band on a card one
GraphLaunch of its own; with
render/pt/enableUpscale the frame is traced at upscaleFactor times the
output size and resized bilinearly to it.
"""

from __future__ import annotations

import enum
import gc
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch import log
from strelka_tpu_torch.materials import MaterialManager
from strelka_tpu_torch.ops import integrator as I
from strelka_tpu_torch.ops import tonemap as TM
from strelka_tpu_torch.render.buffer import Buffer, BufferDesc
from strelka_tpu_torch.render.device_scene import build_device_scene
from strelka_tpu_torch.settings import SharedContext
from strelka_tpu_torch.utils import profiling as P
from strelka_tpu_torch.utils.device import resolve_device


class RenderType(enum.IntEnum):
    eTorch = 0


class Render:
    """Abstract backend interface (include/render/render.h:19-63)."""

    def __init__(self) -> None:
        self._scene = None
        self._ctx: Optional[SharedContext] = None

    def set_scene(self, scene) -> None:
        self._scene = scene

    def get_scene(self):
        return self._scene

    def set_shared_context(self, ctx: SharedContext) -> None:
        self._ctx = ctx

    def get_shared_context(self) -> SharedContext:
        return self._ctx

    def init(self) -> None:
        raise NotImplementedError

    def render(self, output: Buffer) -> None:
        raise NotImplementedError

    def create_buffer(self, desc: BufferDesc) -> Buffer:
        return Buffer(desc)


# Settings keys that reset accumulation when changed (OptixRender.cpp:910-934)
_WATCHED_KEYS = (
    "render/pt/depth",
    "render/pt/sppTotal",
    "render/pt/spp",
    "render/pt/rectLightSamplingMethod",
    "render/pt/enableAcc",
    "render/pt/debug",
    "render/pt/dev/shadowRayTmin",
    "render/pt/dev/materialRayTmin",
    "render/bgColor",
)


def _finish_image(planar: torch.Tensor) -> torch.Tensor:
    """[3,H,W] -> [H,W,4] with alpha 1 (the display boundary)."""
    hwc = TM.planar_to_hwc(planar)
    alpha = torch.ones(hwc.shape[:-1] + (1,), dtype=torch.float32, device=hwc.device)
    return torch.cat([hwc, alpha], dim=-1)


def _post(planar: torch.Tensor, debug: int, tm_type: int, exposure, gamma: float) -> torch.Tensor:
    """Tonemap (or gamma for the AOV views) a planar HDR image -> [H,W,4]."""
    if debug == 0:
        planar = TM.apply_tonemap_planar(planar, tm_type, exposure, gamma)
    elif gamma > 0.0 and debug in (2, 3):
        planar = TM.gamma_correction(planar, gamma)
    return _finish_image(planar)


def resize_bilinear(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """[h,w,C] -> [height,width,C], bilinear with half-pixel centres and, when
    shrinking, the triangle filter widened by the scale: the convention of
    jax.image.resize(..., "bilinear") that the JAX package uses."""
    chw = image.permute(2, 0, 1)[None]
    out = F.interpolate(chw, size=(height, width), mode="bilinear", align_corners=False, antialias=True)
    return out[0].permute(1, 2, 0).contiguous()


# the launch's values in one static buffer of f32 words: the subframe index
# (its int32 bits), clip_to_view, view_to_world, exposure, background, cone spread
_VALUE_SLICES = {"subframe_index": (0, 1), "clip_to_view": (1, 17), "view_to_world": (17, 33),
                 "exposure": (33, 36), "bg_color": (36, 39), "cone_spread": (39, 40)}
_VALUE_WORDS = 40


def pack_values(params: I.LaunchParams) -> np.ndarray:
    """Host LaunchParams (cone_spread given) -> the [40] f32 words of GraphLaunch's buffer."""
    words = np.empty(_VALUE_WORDS, np.float32)
    words[:1].view(np.int32)[0] = int(params.subframe_index)
    for name, (a, b) in _VALUE_SLICES.items():
        if name != "subframe_index":
            words[a:b] = np.asarray(getattr(params, name), np.float32).ravel()
    return words


def unpack_values(words: torch.Tensor) -> I.LaunchParams:
    """LaunchParams of views into the device buffer `words` (pack_values' layout)."""
    view = {name: words[a:b] for name, (a, b) in _VALUE_SLICES.items()}
    return I.LaunchParams(
        subframe_index=view["subframe_index"].view(torch.int32)[0],
        clip_to_view=view["clip_to_view"].view(4, 4),
        view_to_world=view["view_to_world"].view(4, 4),
        exposure=view["exposure"],
        bg_color=view["bg_color"],
        cone_spread=view["cone_spread"][0],
    )


class GraphLaunch:
    """One launch config key on the card: the eager launch captured once as
    a CUDA graph and replayed, the counterpart of the JAX package's
    jax.jit(single, donate_argnums=(2,)).

    The first call runs the launch eagerly: it builds the kernels, fills the
    wrappers' host caches and the allocator, and its result is the call's.
    The second call captures the same launch (which runs nothing) and
    replays it; every later call replays. A graph holds its tensors by
    address, so:
      * the launch's values come from one static device buffer, written by
        one host-to-device copy before each call;
      * the state is static: the launch writes its new state into the
        FrameState it read (what donate_argnums=(2,) lets XLA do), so the
        caller keeps one FrameState for every call;
      * the graph's image is overwritten by the next replay, so a call
        returns a copy.
    reset() drops the graph when the device scene or the state it read is
    replaced; the next call starts again with an eager launch. So does a
    call that finds the recorder (utils/profiling.py) in another state than
    the eager launch or the capture did: a graph captured with it on holds
    its device spans' events and lane counters, one captured with it off
    holds none. A capture that fails raises: the launch never runs eagerly
    in its place. Launch counts (kernels.launch_counts) count each replay's
    kernels where kernels.count_replays is set. `key` labels the
    recorder's counters of captures and graph nodes."""

    def __init__(self, launch, device, pool, key: str = "") -> None:
        self.launch = launch  # fn(scene, params, state) -> (new state, image)
        self.device = torch.device(device)
        self.key = key
        self.words = torch.zeros(_VALUE_WORDS, dtype=torch.float32, device=device)
        self.params = unpack_values(self.words)
        self.reset(pool)

    def reset(self, pool) -> None:
        self.pool = pool  # the memory pool this renderer's graphs share (they never run at once)
        self.graph = None
        self.image = None
        self.counts = None  # the launch counts one replay adds
        self.bound = None  # (scene, state) of the eager launch and the capture
        self.traced = False  # the recorder's state at the eager launch and the capture
        self.record = None  # the device spans the capture recorded (the recorder on)

    def _step(self, scene, state):
        with P.launch_record(self.device) as record:
            new_state, image = self.launch(scene, self.params, state)
            for dst, src in zip(state, new_state):
                dst.copy_(src)  # the state is donated: its new values go where the old ones were read
        return image, record

    def nodes(self) -> int:
        """The captured graph's node count (cuGraphGetNodes)."""
        return P.graph_nodes(self.graph)

    def __call__(self, scene, params: I.LaunchParams, state):
        with P.span("launch.upload"):
            self.words.copy_(torch.from_numpy(pack_values(params)).pin_memory(), non_blocking=True)
        if self.bound is not None and self.traced != P.is_on():
            self.reset(self.pool)
        if self.bound is None:
            self.bound = (scene, state)
            self.traced = P.is_on()
            with P.setup_span("launch.eager"):
                image, _ = self._step(scene, state)
            return state, image
        if self.bound[0] is not scene or self.bound[1] is not state:
            raise RuntimeError("GraphLaunch: called on another scene or state than it was captured on; reset() it")
        if self.graph is None:
            with P.setup_span("launch.capture"):
                graph = torch.cuda.CUDAGraph(keep_graph=True)  # its cudaGraph_t stays readable (raw_cuda_graph)

                def capture():
                    with torch.cuda.graph(graph, pool=self.pool):
                        return self._step(scene, state)

                # a dead graph that Python's cycle collector freed inside the
                # capture would end it (its destructor is a CUDA call the capture
                # forbids): collect before, and not during
                collecting = gc.isenabled()
                gc.collect()
                gc.disable()
                try:
                    (self.image, self.record), self.counts = K.take_counts(capture)
                finally:
                    if collecting:
                        gc.enable()
                graph.instantiate()
            self.graph = graph
            P.count("graph.captures", self.key)
            P.set_count("graph.nodes", self.key, self.nodes())
        P.phase("launch.replay")
        P.replayed(self.record)
        self.graph.replay()
        if K.count_replays:
            K.add_counts(self.counts)
        P.phase("frame.copy")
        with P.device_span("frame.copy", self.device):
            image = self.image.clone()
        return state, image


class TorchRender(Render):
    """The PyTorch wavefront path tracer; its kernels run on the CUDA card.

    device: None means the card (raises without one); "cpu" runs the plain
    PyTorch versions of the kernels. The use_bvh attribute goes to
    build_device_scene when the scene is next built: None builds a BVH above
    1024 triangles, False keeps any scene flat. use_sharding bands the
    frame's rows over `band_devices` (default: every CUDA card, or the CPU
    for device="cpu"); the scene is built on `device` and copied to each."""

    def __init__(self, device=None, use_sharding: bool = False, band_devices=None) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self._use_sharding = use_sharding
        self._band_devices = band_devices
        self._bands = None  # the band devices (parallel/sharding.py) when banded
        self._scene_copies: dict = {}  # the device scene's copy on each band device, kept between launches
        self.use_bvh: Optional[bool] = None
        self._device_scene = None
        self._state: Optional[I.FrameState] = None
        self._state_dims: Tuple[int, int] = (0, 0)
        self._prev_view: Optional[np.ndarray] = None
        self._prev_settings: Optional[tuple] = None
        self._launch_cache: Dict[tuple, object] = {}  # config key -> GraphLaunch (card) or eager launch
        self._graph_pool = None  # the memory pool of this renderer's graphs
        self._resume = False  # a checkpoint was loaded: the next frame keeps its sample count
        self.material_manager = MaterialManager()

    def init(self) -> None:
        name = torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu"
        if self._use_sharding:
            from strelka_tpu_torch.parallel.sharding import make_render_mesh

            devices = self._band_devices
            if devices is None and self.device.type == "cpu":
                devices = [self.device]
            self._bands = make_render_mesh(devices)
            log.info("TorchRender init: {} row bands on {}", len(self._bands), [str(d) for d in self._bands])
        log.info("TorchRender init: device={} ({})", self.device, name)

    def create_buffer(self, desc: BufferDesc) -> Buffer:
        return Buffer(desc, self.device)

    def _settings_snapshot(self, s) -> tuple:
        return tuple(repr(s.get(k)) for k in _WATCHED_KEYS)

    def _build_launch(self, key: tuple):
        """The launch of a static config key (the JAX key's twelve fields, in
        its order), cached: fn(scene, params, state) -> (state, image
        [height, W, 4]), render_launch then the tonemap. On the card it is a
        GraphLaunch; on the CPU the eager launch; in row bands the banded
        launch, each band on a card a GraphLaunch."""
        (width, height, spp, max_spp, depth, acc, rect_m, debug, tm_type, gamma, s_tmin, m_tmin) = key
        kw = dict(width=width, samples_per_launch=spp, max_sample_count=max_spp, max_depth=depth,
                  enable_accumulation=acc, rect_light_sampling_method=rect_m, shadow_ray_tmin=s_tmin,
                  material_ray_tmin=m_tmin, debug=debug)

        def make_launch(local_height, full_height):
            def launch(scene, params, state, py_offset=None):
                with P.launch_record(scene.device):
                    new_state, planar = I.render_launch(scene, params, state, height=local_height,
                                                        py_offset=py_offset, full_height=full_height, **kw)
                    P.device_phase("launch.post")
                    return new_state, _post(planar, debug, tm_type, params.exposure, gamma)

            return launch

        on_card = any(d.type == "cuda" for d in (self._bands or [self.device]))
        if on_card and self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        label = ",".join(str(k) for k in key)  # the recorder's counters are by key
        if self._bands is not None:
            from strelka_tpu_torch.parallel.sharding import shard_launch

            pool = self._graph_pool  # not self: the cached launch must not hold the renderer
            graph = (lambda launch, d: GraphLaunch(launch, d, pool, f"{label}@{d}")) if on_card else None
            fn = shard_launch(make_launch, self._bands, copies=self._scene_copies, graph_launch=graph)
        elif on_card:
            fn = GraphLaunch(make_launch(height, height), self.device, self._graph_pool, label)
        else:
            fn = make_launch(height, height)
        self._launch_cache[key] = fn
        return fn

    def _drop_graphs(self) -> None:
        """The device scene or the state was replaced: every graph read the
        old one by address, so each is dropped (its key stays cached), the
        bands' graphs too."""
        if self._graph_pool is None:
            return
        self._graph_pool = torch.cuda.graph_pool_handle()
        for fn in self._launch_cache.values():
            if hasattr(fn, "reset"):  # a GraphLaunch, or a banded launch
                fn.reset(self._graph_pool)

    def _frame_state(self) -> I.FrameState:
        """The accumulators as one FrameState on self.device (the bands joined)."""
        if self._bands is None:
            return self._state
        from strelka_tpu_torch.parallel.sharding import gather_state

        return gather_state(self._state, self.device)

    def render(self, output: Buffer) -> None:
        with P.frame_span():
            P.phase("render.prepare")
            self._render(output)

    def _render(self, output: Buffer) -> None:
        ctx = self._ctx
        settings = ctx.settings
        scene = self._scene
        out_width, out_height = output.width(), output.height()
        # upscale mode: path-trace at reduced internal resolution and
        # bilinear-upscale for display (render/pt/upscaleFactor semantics)
        width, height = out_width, out_height
        if settings.get_bool("render/pt/enableUpscale"):
            factor = settings.get_float("render/pt/upscaleFactor")
            width = max(int(out_width * factor) // 8 * 8, 8)
            height = max(int(out_height * factor) // 8 * 8, 8)

        # frame-0 / dirty scene: rebuild device tables (GAS/SBT analog)
        if self._device_scene is None or scene.dirty:
            self._device_scene = build_device_scene(scene, self.material_manager, device=self.device,
                                                    use_bvh=self.use_bvh)
            scene.dirty = False
            self._drop_graphs()
            if not self._resume:
                ctx.subframe_index = 0

        # resize -> reset (updatePathtracerParams, OptixRender.cpp:827-872)
        if self._state is None or self._state_dims != (height, width):
            if self._bands is not None:
                from strelka_tpu_torch.parallel.sharding import make_band_state

                self._state = make_band_state(height, width, self._bands)
            else:
                self._state = I.make_frame_state(height, width, self.device)
            self._state_dims = (height, width)
            self._drop_graphs()
            ctx.subframe_index = 0

        # camera: view change resets accumulation (OptixRender.cpp:895-908)
        camera = scene.get_camera(0)
        camera.update_aspect_ratio(width / height)
        view = camera.matrices.view
        if not self._resume and (self._prev_view is None or not np.allclose(view, self._prev_view)):
            ctx.subframe_index = 0
        self._prev_view = view.copy()
        self._resume = False

        # settings change resets accumulation (OptixRender.cpp:910-934)
        snap = self._settings_snapshot(settings)
        if self._prev_settings is not None and snap != self._prev_settings:
            ctx.subframe_index = 0
        self._prev_settings = snap

        enable_acc = settings.get_bool("render/pt/enableAcc")
        debug = settings.get_int("render/pt/debug")
        total_spp = settings.get_int("render/pt/sppTotal")
        spp = settings.get_int("render/pt/spp")
        left_spp = total_spp - ctx.subframe_index
        samples_this_launch = min(spp, left_spp) if enable_acc else spp
        if debug == 1:
            samples_this_launch, enable_acc = 1, False

        exposure = TM.compute_exposure_value(settings)
        tm_type = settings.get_int("render/pt/tonemapperType")
        if not settings.get_bool("render/pt/enableTonemap"):
            tm_type = TM.ToneMapperType.eNone
        gamma = settings.get_float("render/post/gamma")

        if samples_this_launch > 0:
            key = (
                width,
                height,
                samples_this_launch,
                max(total_spp, 1),
                settings.get_int("render/pt/depth"),
                enable_acc,
                settings.get_int("render/pt/rectLightSamplingMethod"),
                debug,
                tm_type,
                gamma,
                settings.get_float("render/pt/dev/shadowRayTmin"),
                settings.get_float("render/pt/dev/materialRayTmin"),
            )
            fn = self._launch_cache.get(key) or self._build_launch(key)
            params = I.LaunchParams(
                subframe_index=int(ctx.subframe_index),
                clip_to_view=np.asarray(camera.clip_to_view(), np.float32),
                view_to_world=np.asarray(camera.view_to_world(), np.float32),
                exposure=np.asarray(exposure, np.float32),
                bg_color=np.asarray(settings.get("render/bgColor"), np.float32),
            )
            params = params._replace(cone_spread=I.ray_cone_spread(params, height))
            self._state, image = fn(self._device_scene, params, self._state)
            ctx.subframe_index += samples_this_launch
        else:
            # budget exhausted: re-emit accumulated buffer (OptixRender.cpp:1022-1049)
            state = self._frame_state()
            if debug == 2:
                planar = state.diffuse
            elif debug == 3:
                planar = state.specular
            else:
                planar = state.accum
            image = _post(planar, debug, tm_type, exposure, gamma)

        if (height, width) != (out_height, out_width):
            P.phase("frame.resize")
            with P.device_span("frame.resize", image.device):
                image = resize_bilinear(image, out_height, out_width)

        if settings.get_bool("render/enableValidation"):
            P.phase("render.validate")
            # validation mode parity (OptixRender.cpp:178-185): device NaN
            # canaries paint red pixels; host check reports them per frame
            nan_count = int(torch.isnan(image).sum())
            canary = int((image[..., 0] >= 1e4).sum())
            if nan_count or canary:
                log.error(
                    "validation: {} NaN values, {} canary pixels in frame {}",
                    nan_count, canary, ctx.frame_number,
                )
        output.set_device(image)
        ctx.frame_number += 1

    # ---- checkpoint/resume of the progressive accumulator (render/checkpoint.py)

    def save_checkpoint(self, path: str, meta: Optional[dict] = None) -> None:
        """Persist the progressive accumulator (checkpoint/resume parity);
        `meta` goes into the file as meta_<key> arrays."""
        from strelka_tpu_torch.render.checkpoint import save_checkpoint

        if self._state is None:
            raise RuntimeError("nothing rendered yet")
        save_checkpoint(path, self._frame_state(), self._ctx.subframe_index, meta=meta)

    def load_checkpoint(self, path: str) -> None:
        from strelka_tpu_torch.render.checkpoint import load_checkpoint

        state, subframe = load_checkpoint(path, self.device)
        dims = tuple(state.accum.shape[1:])
        if self._bands is not None:
            from strelka_tpu_torch.parallel.sharding import split_state

            bands = split_state(state, self._bands)
            if self._state is not None and self._state_dims == dims:
                for dst_band, src_band in zip(self._state.bands, bands.bands):
                    for dst, src in zip(dst_band, src_band):
                        dst.copy_(src)  # into the band states the cached graphs read
            else:
                self._state = bands
                self._drop_graphs()
        elif self._state is not None and self._state_dims == dims:
            for dst, src in zip(self._state, state):
                dst.copy_(src)  # into the state the cached graphs read, which stay valid
        else:
            self._state = state
            self._drop_graphs()
        self._state_dims = dims
        self._ctx.subframe_index = subframe
        # prime the change detectors so the next frame CONTINUES accumulating
        self._prev_settings = None
        self._resume = True


class RenderFactory:
    """render.cpp:10-35 — compile-time backend select becomes a registry."""

    @staticmethod
    def create_render(render_type: RenderType = RenderType.eTorch, **kwargs) -> Render:
        if render_type == RenderType.eTorch:
            return TorchRender(**kwargs)
        raise ValueError(f"Unknown render type {render_type}")
