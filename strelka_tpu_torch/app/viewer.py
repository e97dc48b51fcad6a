"""Interactive viewer — the reference's GLFW/ImGui display loop
(src/app/main.cpp:366-404 + src/display/) on the available display stack.

CameraController ports the FPS control mapping (main.cpp:16-248): WASD +
QE vertical, arrow keys rotate; each camera change resets progressive
accumulation through the render layer's view-change detection.

Usage: python -m strelka_tpu_torch.app.viewer -s builtin://cornell_box --cpu
(MatplotlibDisplay when a GUI exists, HeadlessDisplay with periodic PNG
otherwise.)

The PyTorch counterpart of strelka_tpu/app/viewer.py, with the same flags:
it renders on the CUDA card and exits non-zero without one; --cpu renders on
the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

from strelka_tpu_torch import log
from strelka_tpu_torch.app.cli import load_scene
from strelka_tpu_torch.display import DisplayFactory, InputHandler
from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
from strelka_tpu_torch.render.render import RenderFactory
from strelka_tpu_torch.settings import SharedContext, make_default_settings
from strelka_tpu_torch.utils.device import resolve_device
from strelka_tpu_torch.utils.profiling import FrameStats


class CameraController(InputHandler):
    """FPS camera controls (app/main.cpp:16-248 key mapping)."""

    MOVE_KEYS = {
        "w": (0.0, 0.0, -1.0),
        "s": (0.0, 0.0, 1.0),
        "a": (-1.0, 0.0, 0.0),
        "d": (1.0, 0.0, 0.0),
        "q": (0.0, -1.0, 0.0),
        "e": (0.0, 1.0, 0.0),
    }
    ROT_KEYS = {"left": (-5.0, 0.0), "right": (5.0, 0.0), "up": (0.0, -5.0), "down": (0.0, 5.0)}

    def __init__(self, camera, speed: float = 1.0):
        self.camera = camera
        self.speed = speed

    def key_press(self, key: str, action: str) -> None:
        key = (key or "").lower()
        if key in self.MOVE_KEYS:
            d = self.MOVE_KEYS[key]
            self.camera.translate([c * self.speed * 0.25 for c in d])
        elif key in self.ROT_KEYS:
            r, u = self.ROT_KEYS[key]
            self.camera.rotate(r * 8, u * 8)


class PanelController(InputHandler):
    """Keyboard front-end for the SettingsBinding knob set — the ImGui debug
    panel's live mutations (Display.cpp:68-239) without a mouse UI (this
    environment has no GL window; the reference binds only camera keys,
    main.cpp:160-190, and drives these knobs with the mouse).

    g: cycle debug view     t: cycle tonemapper   p: toggle accumulation
    m: rect light sampling  [ ]: max depth -/+    c: request screenshot
    """

    def __init__(self, binding):
        self.binding = binding
        self.screenshot_requested = False

    def _cycle(self, key: str, n: int, step: int = 1) -> None:
        cur = int(self.binding._settings.get_int(key))
        self.binding.set(key, (cur + step) % n)

    def key_press(self, key: str, action: str) -> None:
        key = (key or "").lower()
        s = self.binding._settings
        if key == "g":
            self._cycle("render/pt/debug", 4)
        elif key == "t":
            self._cycle("render/pt/tonemapperType", 4)
        elif key == "m":
            self._cycle("render/pt/rectLightSamplingMethod", 2)
        elif key == "p":
            self.binding.set("render/pt/enableAcc", not s.get_bool("render/pt/enableAcc"))
        elif key == "]":
            self.binding.set("render/pt/depth", min(16, s.get_int("render/pt/depth") + 1))
        elif key == "[":
            self.binding.set("render/pt/depth", max(1, s.get_int("render/pt/depth") - 1))
        elif key == "c":
            self.screenshot_requested = True


class CompositeHandler(InputHandler):
    """Fan a key event out to several handlers (camera + panel)."""

    def __init__(self, *handlers):
        self.handlers = handlers

    def key_press(self, key: str, action: str) -> None:
        for h in self.handlers:
            h.key_press(key, action)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("strelka-viewer")
    parser.add_argument("-s", "--scene", required=True)
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("-t", "--spp-total", type=int, default=512)
    parser.add_argument("-f", "--spp-subframe", type=int, default=1)
    parser.add_argument("--frames", type=int, default=0, help="exit after N frames (0 = run until closed)")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--png-stream", default="", help="headless: write latest frame here every frame")
    parser.add_argument("--web", type=int, default=None, metavar="PORT",
                        help="serve an interactive browser viewer + settings panel on this port (0 = auto)")
    args = parser.parse_args(argv)

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        log.fatal("{} (--cpu renders on the CPU)", e)
        return 1

    settings = make_default_settings(args.width, args.height)
    settings.set("render/pt/sppTotal", args.spp_total)
    settings.set("render/pt/spp", args.spp_subframe)
    settings.set("render/pt/depth", args.depth)
    ctx = SharedContext(settings)
    scene = load_scene(args.scene)

    render = RenderFactory.create_render(device=device)
    render.set_scene(scene)
    render.set_shared_context(ctx)
    render.init()
    ctx.render = render

    display = DisplayFactory.create_display(
        web_port=args.web,
        png_path=args.png_stream or os.path.join(tempfile.gettempdir(), "strelka_view.png"), png_every_n=4,
    )
    display.init(args.width, args.height, ctx)
    from strelka_tpu_torch.display.display import SettingsBinding

    controller = CameraController(scene.get_camera(0), settings.get_float("render/cameraSpeed"))
    panel = PanelController(SettingsBinding(settings))
    display.set_input_handler(CompositeHandler(controller, panel))

    buf = render.create_buffer(BufferDesc(args.width, args.height, BufferFormat.FLOAT4))
    stats = FrameStats()
    frame = 0
    while not display.window_should_close():
        t0 = time.perf_counter()
        display.poll_events()
        display.on_begin_frame()
        scene.update_camera(controller.camera, 0)
        render.render(buf)
        buf.map()
        display.draw_frame(buf.as_image())
        display.draw_ui()
        display.on_end_frame()
        if panel.screenshot_requested:
            panel.screenshot_requested = False
            from strelka_tpu_torch.utils.image import write_png

            shot = os.path.join(tempfile.gettempdir(), f"strelka_shot_{ctx.subframe_index}spp.png")
            write_png(shot, buf.map()[..., :3])
            log.info("Screenshot: {}", shot)
        stats.add_frame(time.perf_counter() - t0)
        display.set_window_title(stats.title(spp=ctx.subframe_index))
        frame += 1
        if args.frames and frame >= args.frames:
            break
    display.destroy()
    log.info("Viewer exited after {} frames ({} spp)", frame, ctx.subframe_index)
    return 0


if __name__ == "__main__":
    sys.exit(main())
