"""Flat string-keyed typed settings registry + shared context.

Equivalent of the reference's SettingsManager (include/settings/settings.h:11-63,
string->string map with typed setAs<T>/getAs<T>) and SharedContext
(include/render/common.h:22-28: frameNumber, subframeIndex, settings, render).

The canonical key set mirrors src/app/main.cpp:289-327.
"""

from __future__ import annotations

from typing import Any, Dict


class SettingsManager:
    """String-keyed KV store with typed accessors.

    Unlike the reference (which asserts on missing keys, settings.h:17-24) we
    raise KeyError with the key name for a debuggable failure.
    """

    def __init__(self) -> None:
        self._map: Dict[str, Any] = {}

    def set(self, key: str, value: Any) -> None:
        self._map[key] = value

    def get(self, key: str, default: Any = KeyError) -> Any:
        if key in self._map:
            return self._map[key]
        if default is KeyError:
            raise KeyError(f"Setting '{key}' was not set")
        return default

    def get_bool(self, key: str) -> bool:
        return bool(self.get(key))

    def get_int(self, key: str) -> int:
        return int(self.get(key))

    def get_float(self, key: str) -> float:
        return float(self.get(key))

    def get_str(self, key: str) -> str:
        return str(self.get(key))

    def has(self, key: str) -> bool:
        return key in self._map

    def keys(self):
        return self._map.keys()

    # C++-style aliases so ported call sites read like the reference
    setAs = set
    getAs = get


def make_default_settings(width: int = 1024, height: int = 768) -> SettingsManager:
    """Canonical startup keys, mirroring src/app/main.cpp:289-327."""
    s = SettingsManager()
    s.set("render/width", width)
    s.set("render/height", height)
    s.set("render/pt/depth", 4)
    s.set("render/pt/sppTotal", 64)
    s.set("render/pt/spp", 1)
    s.set("render/pt/iteration", 0)
    s.set("render/pt/stratifiedSamplingType", 0)
    s.set("render/pt/tonemapperType", 0)  # 0 reinhard, 1 aces, 2 filmic, 3 none
    s.set("render/pt/debug", 0)  # 0 none, 1 normals, 2 diffuse AOV, 3 specular AOV
    s.set("render/cameraSpeed", 1.0)
    s.set("render/pt/upscaleFactor", 0.5)
    s.set("render/pt/enableUpscale", False)
    s.set("render/pt/enableAcc", True)
    s.set("render/pt/enableTonemap", True)
    s.set("render/pt/isResized", False)
    s.set("render/pt/needScreenshot", False)
    s.set("render/pt/screenshotSPP", False)
    s.set("render/pt/rectLightSamplingMethod", 0)  # 0 uniform, 1 spherical-quad
    s.set("render/enableValidation", False)
    s.set("resource/searchPath", "")
    s.set("render/post/tonemapper/filmIso", 100.0)
    s.set("render/post/tonemapper/cm2_factor", 1.0)
    s.set("render/post/tonemapper/fStop", 4.0)
    s.set("render/post/tonemapper/shutterSpeed", 100.0)
    s.set("render/post/gamma", 2.4)  # 0.0 = off
    s.set("render/pt/dev/shadowRayTmin", 0.0)
    s.set("render/pt/dev/materialRayTmin", 0.0)
    s.set("render/bgColor", (0.0, 0.0, 0.0))
    # TPU-specific knobs (no reference equivalent)
    s.set("render/tpu/shardAxis", "y")  # pixel-row sharding over the device mesh
    s.set("render/tpu/donateAccum", True)
    return s


class SharedContext:
    """Frame/subframe counters + settings + render backref (common.h:22-28)."""

    def __init__(self, settings: SettingsManager | None = None) -> None:
        self.frame_number: int = 0
        self.subframe_index: int = 0
        self.settings: SettingsManager = settings or make_default_settings()
        self.render = None
