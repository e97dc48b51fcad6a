"""The plain reference: the pixels of a frame, worked out again from the inputs.

It builds its own scene from the stage file or the strands (`inputs.py`, `scenes/`) with
the frozen plain code in `refport/` (flat: every ray meets every triangle
and every cone in the dense sweeps), and renders the sampled pixels of the
frame the window left: every sample since the camera's last reset, each with
the program's sample index, camera jitter and texel key (the pixel's slot in
the program's wavefront), accumulated launch after launch by the program's
running-mean formula and tonemapped as a frame is. A viewport frame's pixels
are then resized as the display resizes them (`upscale_taps`).

It imports torch, numpy and `refport` only: nothing of the program, nothing
the program made (no table, tree, atlas or matrix of its), and neither jax nor
the JAX package. `lowp=True` is the control: the same paths with their state
rounded to bfloat16 at every bounce.
"""

from __future__ import annotations

import numpy as np
import torch

from refport.materials import MaterialManager
from refport.ops import integrator as I
from refport.ops import sampler as S
from refport.ops import tonemap as TM
from refport.ops.vec import Vec3
from refport.render.device_scene import build_device_scene
from refport.settings import make_default_settings

import inputs

LANES_PER_TRACE = 1 << 15  # paths traced together: bounds the dense sweeps' temporaries


def make_settings(render_settings: dict):
    """The reference's settings: the defaults with the cell's keys over them."""
    s = make_default_settings(int(render_settings["render/width"]), int(render_settings["render/height"]))
    for key, value in render_settings.items():
        s.set(key, tuple(value) if isinstance(value, list) else value)
    return s


class Reference:
    """One configuration's scene on `device`, built by the reference."""

    def __init__(self, root: str, config: dict, seed: int, device) -> None:
        self.device = torch.device(device)
        self.host = inputs.load_scene("reference", root, config, seed)
        self.scene = build_device_scene(self.host, MaterialManager(), device=self.device, use_bvh=False)

    def camera(self, eye, target, width: int, height: int):
        """(view_to_world, clip_to_view) f32 of the scene's camera at a pose,
        for a traced image of width x height."""
        cam = self.host.get_camera(0)
        cam.look_at(eye, target)
        cam.update_aspect_ratio(width / height)
        return np.asarray(cam.view_to_world(), np.float32), np.asarray(cam.clip_to_view(), np.float32)

    def slots(self, px: torch.Tensor, py: torch.Tensor, width: int, height: int, order: str) -> torch.Tensor:
        """Each pixel's slot in the program's wavefront of a one-sample launch:
        its Z-rank on the card ("zorder"), its row-major index on the CPU."""
        linear = py * width + px
        if order == "rowmajor":
            return linear
        _, inv = I.pixel_zorder(width, height, self.device)
        return inv.to(torch.int64)[linear]

    def pixels(self, settings, view, px, py, n_samples: int, width: int, height: int, order: str,
               lowp: bool = False) -> torch.Tensor:
        """The tonemapped [3, P] values of pixels (px, py) of a [height, width]
        frame after samples 0..n_samples-1, one a launch, at one camera pose."""
        dev = self.device
        px = torch.as_tensor(px, dtype=torch.int64, device=dev)
        py = torch.as_tensor(py, dtype=torch.int64, device=dev)
        view_to_world, clip_to_view = view
        exposure = np.asarray(TM.compute_exposure_value(settings), np.float32)
        params = I.LaunchParams(
            subframe_index=0, clip_to_view=clip_to_view, view_to_world=view_to_world, exposure=exposure,
            bg_color=np.asarray(settings.get("render/bgColor"), np.float32))
        params = params._replace(cone_spread=I.ray_cone_spread(params, height))
        slots = self.slots(px, py, width, height, order)
        max_spp = max(settings.get_int("render/pt/sppTotal"), 1)
        p = px.shape[0]
        radiance = torch.empty((3, n_samples, p), dtype=torch.float32, device=dev)
        lanes = torch.arange(n_samples * p, device=dev)
        for start in range(0, n_samples * p, LANES_PER_TRACE):
            lane = lanes[start:start + LANES_PER_TRACE]
            k, i = lane // p, lane % p
            rgb = self._trace(settings, params, px[i], py[i], k, slots[i], max_spp, width, height, lowp)
            radiance[:, k, i] = torch.stack(list(rgb))
        exposure3 = torch.as_tensor(exposure, device=dev).reshape(3, 1, 1)
        accum = radiance[:, :1]
        for k in range(1, n_samples):
            # the program's running mean, launch by launch (ops/integrator.py:_accumulate_planar)
            accum = I._accumulate_planar(accum, radiance[:, k:k + 1], exposure3, k)
        tm_type = settings.get_int("render/pt/tonemapperType")
        if not settings.get_bool("render/pt/enableTonemap"):
            tm_type = TM.ToneMapperType.eNone
        out = TM.apply_tonemap_planar(accum, tm_type, exposure, settings.get_float("render/post/gamma"))
        return out[:, 0]

    def _trace(self, settings, params, px, py, sample, slot, max_spp, width, height, lowp):
        sample_idx = S.make_sample_index(px, py, sample & S.M32, max_spp)
        dims0 = S.random_dims(sample_idx, 0, (0, 1, 2, 3, 4))
        dim = S.SampleDimension
        origin, direction = I.generate_camera_rays(params, px, py, dims0[dim.ePixelX % 5], dims0[dim.ePixelY % 5],
                                                   width, height)
        radiance, _ = I.trace_paths(
            self.scene, params, sample_idx, origin, direction,
            max_depth=settings.get_int("render/pt/depth"),
            rect_light_sampling_method=settings.get_int("render/pt/rectLightSamplingMethod"),
            shadow_ray_tmin=settings.get_float("render/pt/dev/shadowRayTmin"),
            material_ray_tmin=settings.get_float("render/pt/dev/materialRayTmin"),
            debug=0, depth0_dims=dims0, cone_spread=params.cone_spread, ray_slot=slot, lowp=lowp)
        return Vec3(*radiance)


def upscale_taps(x_out: np.ndarray, out_size: int, in_size: int):
    """The two source taps and weights of output coordinates x_out under the
    display's bilinear resize (half-pixel centres, render/render.py:
    resize_bilinear), edges clamped: (lo, hi, w_lo, w_hi)."""
    src = (x_out.astype(np.float64) + 0.5) * (in_size / out_size) - 0.5
    src = np.maximum(src, 0.0)
    lo = np.floor(src).astype(np.int64)
    frac = (src - lo).astype(np.float32)
    hi = np.minimum(lo + 1, in_size - 1)
    return lo, hi, np.float32(1.0) - frac, frac


def upscale_plan(ox: np.ndarray, oy: np.ndarray, out_w: int, out_h: int, in_w: int, in_h: int):
    """For output pixels (ox, oy): the distinct traced pixels they read
    (tx, ty) and, per output pixel, the four (index into them, weight) pairs
    of the separable bilinear resize."""
    x0, x1, wx0, wx1 = upscale_taps(ox, out_w, in_w)
    y0, y1, wy0, wy1 = upscale_taps(oy, out_h, in_h)
    taps = [(y0, x0, wy0 * wx0), (y0, x1, wy0 * wx1), (y1, x0, wy1 * wx0), (y1, x1, wy1 * wx1)]
    linear = np.stack([ty * in_w + tx for ty, tx, _ in taps])
    uniq, index = np.unique(linear, return_inverse=True)
    weights = np.stack([w for _, _, w in taps]).astype(np.float32)
    return uniq % in_w, uniq // in_w, index.reshape(4, -1), weights


def apply_upscale(values: torch.Tensor, index: np.ndarray, weights: np.ndarray) -> torch.Tensor:
    """[3, T] traced values -> [3, P] output values by upscale_plan's taps,
    summed in the resize's order: rows first, then the two rows' blend."""
    idx = torch.as_tensor(index, device=values.device)
    w = torch.as_tensor(weights, device=values.device)
    v = [values[:, idx[j]] for j in range(4)]
    return v[0] * w[0] + v[1] * w[1] + v[2] * w[2] + v[3] * w[3]
