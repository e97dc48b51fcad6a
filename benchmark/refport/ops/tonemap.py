"""Tonemapping and exposure on planar [3, H, W] images — the PyTorch port of
the planar half of strelka_tpu/ops/tonemap.py.

Ports: src/render/optix/postprocessing/Tonemappers.cu (Reinhard, ACES fitted,
ACES filmic, gamma) and the photographic exposure computation
(OptixRender.cpp:956-987).
"""

from __future__ import annotations

import numpy as np
import torch


class ToneMapperType:
    """Matches the settings encoding (app/main.cpp:306, Display.cpp combo)."""

    eReinhard = 0
    eACES = 1
    eFilmic = 2
    eNone = 3


_ACES_INPUT = np.array(
    [
        [0.59719, 0.35458, 0.04823],
        [0.07600, 0.90834, 0.01566],
        [0.02840, 0.13383, 0.83777],
    ],
    dtype=np.float32,
)
_ACES_OUTPUT = np.array(
    [
        [1.60475, -0.53108, -0.07367],
        [-0.10208, 1.10813, -0.00605],
        [-0.00327, -0.07276, 1.07602],
    ],
    dtype=np.float32,
)


def _lum_planar(color):
    return 0.299 * color[0] + 0.587 * color[1] + 0.114 * color[2]


def _mat3_planar(m: np.ndarray, c: torch.Tensor) -> torch.Tensor:
    """[3,3] constant matrix applied per pixel to a planar [3, H, W] image."""
    return torch.stack([
        float(m[i, 0]) * c[0] + float(m[i, 1]) * c[1] + float(m[i, 2]) * c[2] for i in range(3)
    ])


def gamma_correction(color: torch.Tensor, gamma: float) -> torch.Tensor:
    """Tonemappers.cu:99-109."""
    return torch.pow(torch.clamp(color, min=0.0), 1.0 / gamma)


def apply_tonemap_planar(image: torch.Tensor, tonemapper_type: int, exposure, gamma: float) -> torch.Tensor:
    """Tonemap dispatch (Tonemappers.cu:111-135) on a planar [3, H, W] image.

    exposure: [3] f32, a host value or a tensor (one on the image's device
    is taken as it is, so a captured launch reads it from its buffer)."""
    exposure = torch.as_tensor(exposure, dtype=torch.float32, device=image.device).reshape(3, 1, 1)
    if tonemapper_type == ToneMapperType.eReinhard:
        c = image * exposure
        image = c / (_lum_planar(c)[None] + 1.0)
    elif tonemapper_type == ToneMapperType.eACES:
        c = _mat3_planar(_ACES_INPUT, image * exposure)
        num = c * (c + 0.0245786) - 0.000090537
        den = c * (0.983729 * c + 0.4329510) + 0.238081
        image = torch.clamp(_mat3_planar(_ACES_OUTPUT, num / den), 0.0, 1.0)
    elif tonemapper_type == ToneMapperType.eFilmic:
        x = image * exposure
        image = torch.clamp((x * (2.51 * x + 0.03)) / (x * (2.43 * x + 0.59) + 0.14), 0.0, 1.0)
    if gamma > 0.0:
        image = gamma_correction(image, gamma)
    return image


def planar_to_hwc(image: torch.Tensor) -> torch.Tensor:
    """[3, H, W] -> [H, W, 3] (display/PNG boundary, once per frame)."""
    return image.permute(1, 2, 0)


def compute_exposure_value(settings) -> np.ndarray:
    """Photographic exposure from ISO/fStop/shutter (OptixRender.cpp:956-987)."""
    film_iso = settings.get_float("render/post/tonemapper/filmIso")
    cm2_factor = settings.get_float("render/post/tonemapper/cm2_factor")
    f_stop = settings.get_float("render/post/tonemapper/fStop")
    shutter_speed = settings.get_float("render/post/tonemapper/shutterSpeed")
    white_point = np.array([1.0, 1.0, 1.0], dtype=np.float32)
    exposure_value = np.where(np.all(white_point != 0.0), 1.0 / white_point, np.ones(3, np.float32))
    lum = float(np.dot(exposure_value, [0.299, 0.587, 0.114]))
    if film_iso > 0.0:
        exposure_value = exposure_value * (cm2_factor * film_iso / (shutter_speed * f_stop * f_stop) / 100.0)
    else:
        exposure_value = exposure_value * cm2_factor
    return (exposure_value / lum).astype(np.float32)
