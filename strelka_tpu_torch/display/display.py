"""Display layer — port of the Display interface (include/display/Display.h:11-99).

The reference has GLFW/OpenGL and Metal swapchain displays plus an ImGui
settings overlay (src/display/). In this environment there is no windowing
system; the capability is covered by:

  * HeadlessDisplay — frame sink writing periodic PNGs (CI / remote use)
  * MatplotlibDisplay — interactive window (imshow-based) when a GUI backend
    exists, with keyboard camera controls mapped like the reference's
    CameraController (WASD + arrows, src/app/main.cpp:16-248)

The ImGui debug panel (src/display/Display.cpp:68-239) maps to
``SettingsBinding``: the same settings keys, mutated at runtime, with the
render layer picking changes up per frame exactly as the reference does.

A copy of the JAX package's strelka_tpu/display/display.py.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from strelka_tpu_torch.render.buffer import ImageBuffer
from strelka_tpu_torch.settings import SettingsManager


class InputHandler:
    """Display.h:25-45."""

    def key_press(self, key: str, action: str) -> None:  # noqa: D102
        pass

    def mouse_button(self, button: int, action: str, x: float, y: float) -> None:  # noqa: D102
        pass

    def mouse_move(self, x: float, y: float) -> None:  # noqa: D102
        pass


class ResizeHandler:
    def frame_buffer_resize(self, width: int, height: int) -> None:  # noqa: D102
        pass


class Display:
    """Abstract display (Display.h:47-99)."""

    def __init__(self) -> None:
        self._input_handler: Optional[InputHandler] = None
        self._resize_handler: Optional[ResizeHandler] = None
        self._window_title = "Strelka"
        self.width = 0
        self.height = 0

    def init(self, width: int, height: int, ctx) -> None:
        self.width, self.height = width, height
        self._ctx = ctx

    def destroy(self) -> None:
        pass

    def set_input_handler(self, handler: InputHandler) -> None:
        self._input_handler = handler

    def set_resize_handler(self, handler: ResizeHandler) -> None:
        self._resize_handler = handler

    def window_should_close(self) -> bool:
        return False

    def poll_events(self) -> None:
        pass

    def on_begin_frame(self) -> None:
        pass

    def on_end_frame(self) -> None:
        pass

    def draw_frame(self, image: ImageBuffer) -> None:
        raise NotImplementedError

    def draw_ui(self) -> None:
        pass

    def set_window_title(self, title: str) -> None:
        self._window_title = title


class HeadlessDisplay(Display):
    """Frame sink: stores the latest frame; optional periodic PNG dump."""

    def __init__(self, png_path: str = "", png_every_n: int = 0):
        super().__init__()
        self.png_path = png_path
        self.png_every_n = png_every_n
        self._frame_count = 0
        self.last_frame: Optional[np.ndarray] = None

    def draw_frame(self, image: ImageBuffer) -> None:
        self.last_frame = np.asarray(image.data)
        self._frame_count += 1
        if self.png_path and self.png_every_n and self._frame_count % self.png_every_n == 0:
            from strelka_tpu_torch.utils.image import write_png

            write_png(self.png_path, self.last_frame[..., :3])


class MatplotlibDisplay(Display):
    """Interactive imshow window with FPS-style camera keys."""

    def __init__(self) -> None:
        super().__init__()
        self._fig = None
        self._im = None
        self._closed = False

    def init(self, width: int, height: int, ctx) -> None:
        super().init(width, height, ctx)
        import matplotlib

        if os.environ.get("DISPLAY") is None and os.environ.get("MPLBACKEND") is None:
            raise RuntimeError("no DISPLAY; use HeadlessDisplay")
        import matplotlib.pyplot as plt

        self._plt = plt
        plt.ion()
        self._fig, ax = plt.subplots(figsize=(width / 100, height / 100))
        ax.axis("off")
        self._im = ax.imshow(np.zeros((height, width, 3), np.float32), origin="lower")
        self._fig.canvas.mpl_connect("close_event", self._on_close)
        self._fig.canvas.mpl_connect("key_press_event", self._on_key)

    def _on_close(self, _event) -> None:
        self._closed = True

    def _on_key(self, event) -> None:
        if self._input_handler is not None and event.key:
            self._input_handler.key_press(event.key, "press")

    def window_should_close(self) -> bool:
        return self._closed

    def poll_events(self) -> None:
        if self._fig is not None:
            self._fig.canvas.flush_events()

    def draw_frame(self, image: ImageBuffer) -> None:
        arr = np.clip(np.asarray(image.data)[..., :3], 0.0, 1.0)
        self._im.set_data(arr)
        self._fig.canvas.draw_idle()

    def set_window_title(self, title: str) -> None:
        super().set_window_title(title)
        if self._fig is not None:
            self._fig.canvas.manager.set_window_title(title)


class DisplayFactory:
    """DisplayFactory::createDisplay (display/DisplayFactory.cpp:9)."""

    @staticmethod
    def create_display(
        headless: Optional[bool] = None, web_port: Optional[int] = None, **kwargs
    ) -> Display:
        if web_port is None and os.environ.get("STRELKA_WEB_PORT"):
            web_port = int(os.environ["STRELKA_WEB_PORT"])
        if web_port is not None:
            from strelka_tpu_torch.display.web import WebDisplay

            return WebDisplay(port=web_port)
        if headless is None:
            headless = os.environ.get("DISPLAY") is None
        if headless:
            return HeadlessDisplay(**kwargs)
        try:
            return MatplotlibDisplay()
        except (RuntimeError, ImportError):
            return HeadlessDisplay(**kwargs)


class SettingsBinding:
    """The ImGui debug-panel capability (Display.cpp:68-239) as a programmatic
    binding: named knobs over the same settings keys, live-mutable.

    knobs() returns (label, key, kind, choices/range) rows — a UI layer (or a
    REPL) can render them; set() writes through to the settings manager and
    the render layer resets accumulation exactly as the reference does.
    """

    KNOBS = [
        ("Debug view", "render/pt/debug", "combo", ["None", "Normals", "Diffuse AOV", "Specular AOV"]),
        ("Rect light sampling", "render/pt/rectLightSamplingMethod", "combo", ["Uniform", "Spherical quad"]),
        ("Max depth", "render/pt/depth", "int", (1, 16)),
        ("Samples per launch", "render/pt/spp", "int", (1, 32)),
        ("Total spp", "render/pt/sppTotal", "int", (1, 16384)),
        ("Accumulation", "render/pt/enableAcc", "bool", None),
        ("Tonemapper", "render/pt/tonemapperType", "combo", ["Reinhard", "ACES", "Filmic", "None"]),
        ("Gamma", "render/post/gamma", "float", (0.0, 4.0)),
        ("Film ISO", "render/post/tonemapper/filmIso", "float", (0.0, 1600.0)),
        ("f-stop", "render/post/tonemapper/fStop", "float", (0.3, 64.0)),
        ("Shutter speed", "render/post/tonemapper/shutterSpeed", "float", (1.0, 8000.0)),
        ("Shadow ray tmin", "render/pt/dev/shadowRayTmin", "float", (0.0, 1.0)),
        ("Material ray tmin", "render/pt/dev/materialRayTmin", "float", (0.0, 1.0)),
    ]

    def __init__(self, settings: SettingsManager):
        self._settings = settings

    def knobs(self):
        return [(label, key, kind, extra, self._settings.get(key)) for label, key, kind, extra in self.KNOBS]

    def set(self, key: str, value) -> None:
        self._settings.set(key, value)
