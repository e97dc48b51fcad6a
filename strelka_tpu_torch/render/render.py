"""Render backend — the PyTorch port of strelka_tpu/render/render.py (layer L1).

Mirrors the per-frame flow of OptiXRender::render (OptixRender.cpp:874-1057):
frame-0 device-scene build, camera/settings change detection resetting
progressive accumulation (:895-934), launch-budget computation (:989-1004),
the launch itself (ops.integrator.render_launch) and tonemap dispatch
(:1045-1049). PyTorch runs eagerly, so there is no launch cache. With
use_sharding the launch runs in row bands over several devices
(parallel/sharding.py); with render/pt/enableUpscale the frame is traced at
upscaleFactor times the output size and resized bilinearly to it.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from strelka_tpu_torch import log
from strelka_tpu_torch.materials import MaterialManager
from strelka_tpu_torch.ops import integrator as I
from strelka_tpu_torch.ops import tonemap as TM
from strelka_tpu_torch.render.buffer import Buffer, BufferDesc
from strelka_tpu_torch.render.device_scene import build_device_scene
from strelka_tpu_torch.settings import SharedContext
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

    def _launch_fn(self, height: int, kw: dict, tm_type: int, gamma: float):
        """fn(scene, params, state) -> (state, image [height, W, 4]): render_launch
        with the settings `kw`, then the tonemap; in row bands when sharded."""

        def make_launch(local_height, full_height):
            def launch(scene, params, state, py_offset=None):
                new_state, planar = I.render_launch(scene, params, state, height=local_height, py_offset=py_offset,
                                                    full_height=full_height, **kw)
                return new_state, _post(planar, kw["debug"], tm_type, params.exposure, gamma)

            return launch

        if self._bands is None:
            return make_launch(height, height)
        from strelka_tpu_torch.parallel.sharding import shard_launch

        return shard_launch(make_launch, self._bands, copies=self._scene_copies)

    def _frame_state(self) -> I.FrameState:
        """The accumulators as one FrameState on self.device (the bands joined)."""
        if self._bands is None:
            return self._state
        from strelka_tpu_torch.parallel.sharding import gather_state

        return gather_state(self._state, self.device)

    def render(self, output: Buffer) -> None:
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
            params = I.LaunchParams(
                subframe_index=int(ctx.subframe_index),
                clip_to_view=np.asarray(camera.clip_to_view(), np.float32),
                view_to_world=np.asarray(camera.view_to_world(), np.float32),
                exposure=np.asarray(exposure, np.float32),
                bg_color=np.asarray(settings.get("render/bgColor"), np.float32),
            )
            kw = dict(
                width=width,
                samples_per_launch=samples_this_launch,
                max_sample_count=max(total_spp, 1),
                max_depth=settings.get_int("render/pt/depth"),
                enable_accumulation=enable_acc,
                rect_light_sampling_method=settings.get_int("render/pt/rectLightSamplingMethod"),
                shadow_ray_tmin=settings.get_float("render/pt/dev/shadowRayTmin"),
                material_ray_tmin=settings.get_float("render/pt/dev/materialRayTmin"),
                debug=debug,
            )
            launch = self._launch_fn(height, kw, tm_type, gamma)
            self._state, image = launch(self._device_scene, params, self._state)
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
            image = resize_bilinear(image, out_height, out_width)

        if settings.get_bool("render/enableValidation"):
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

    def save_checkpoint(self, path: str) -> None:
        """Persist the progressive accumulator (checkpoint/resume parity)."""
        from strelka_tpu_torch.render.checkpoint import save_checkpoint

        if self._state is None:
            raise RuntimeError("nothing rendered yet")
        save_checkpoint(path, self._frame_state(), self._ctx.subframe_index)

    def load_checkpoint(self, path: str) -> None:
        from strelka_tpu_torch.render.checkpoint import load_checkpoint

        state, subframe = load_checkpoint(path, self.device)
        self._state_dims = tuple(state.accum.shape[1:])
        if self._bands is not None:
            from strelka_tpu_torch.parallel.sharding import split_state

            state = split_state(state, self._bands)
        self._state = state
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
