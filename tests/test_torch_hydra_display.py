"""The port's Hydra delegate, USD runner and display layer.

tests/test_hydra_display.py's cases (:41, :73, :109, :132, :170) run on the
port, on that file's own stage: the delegate's API and a 24x24 frame through
it on the CPU, `python -m strelka_tpu_torch.app.usd_runner --cpu` at 24x24
(its PNG equal to the delegate's frame), the headless display and the
settings binding, the viewer's hotkeys, and the web display's endpoints
(the frame it serves is a PNG that utils/image.py:read_png decodes to the
frame). Beside them: the pxr guard (no pxr on these hosts: the port's own
stage loaders carry the stage), and utils/image.py:encode_png, whose bytes
decode back through read_png and are what write_png writes.
"""

import json
import os
import subprocess
import sys
import urllib.request

import numpy as np
import pytest
import torch

from strelka_tpu_torch.settings import SharedContext, make_default_settings
from strelka_tpu_torch.utils.image import encode_png, read_png, to_uint8, write_png

from test_hydra_display import STAGE  # the JAX package's own stage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def one_thread():
    """ROADMAP.md section C: torch 2.13's first-call CPU sqrt."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _delegate_frame(path):
    from strelka_tpu_torch.hydra import HdStrelkaDriverName, StrelkaRendererPlugin

    settings = make_default_settings(24, 24)
    settings.set("render/pt/sppTotal", 2)
    settings.set("render/pt/spp", 2)
    ctx = SharedContext(settings)
    assert StrelkaRendererPlugin.is_supported()
    delegate = StrelkaRendererPlugin.create_render_delegate(device="cpu")
    assert "Mesh" in delegate.SUPPORTED_RPRIM_TYPES
    assert "mdl" in delegate.get_material_render_contexts()
    with pytest.raises(ValueError):  # missing driver (RenderDelegate asserts on it)
        delegate.set_drivers({})
    delegate.set_drivers({HdStrelkaDriverName: ctx})
    assert ctx.render is delegate.render
    assert delegate.populate_from_usd(str(path))
    buf = delegate.create_render_buffer(24, 24)
    delegate.create_render_pass().execute(buf)
    assert ctx.subframe_index == 2
    return buf.map()


def test_delegate_api_shape(tmp_path, one_thread):
    p = tmp_path / "stage.usda"
    p.write_text(STAGE)
    img = _delegate_frame(p)
    assert img.shape == (24, 24, 4)
    assert not np.isnan(img).any()
    assert img[..., :3].max() > 0.0  # sun lights the floor


def test_usd_runner_cli(tmp_path, one_thread):
    p = tmp_path / "stage.usda"
    p.write_text(STAGE)
    out = tmp_path / "out.png"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "strelka_tpu_torch.app.usd_runner", "-s", str(p), "--width", "24",
                        "--height", "24", "-t", "2", "-f", "2", "--cpu", "-o", str(out)],
                       capture_output=True, text=True, cwd=ROOT, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "spp" in r.stdout
    png = np.round(read_png(str(out)) * 255.0).astype(np.uint8)
    np.testing.assert_array_equal(png, to_uint8(_delegate_frame(p)[..., :3])[::-1])


def test_pxr_guard():
    from strelka_tpu_torch.hydra import StrelkaRendererPlugin, pxr_adapter

    assert pxr_adapter.pxr_available() == _has_pxr()
    if not _has_pxr():
        assert pxr_adapter.open_stage_flattened("missing.usda") is None
        assert pxr_adapter.load_with_pxr("missing.usda", None) is False
    assert pxr_adapter.register()
    assert pxr_adapter.get_renderer_plugin() is StrelkaRendererPlugin


def _has_pxr() -> bool:
    try:
        import pxr  # noqa: F401
    except ImportError:
        return False
    return True


def test_headless_display_and_settings_binding(tmp_path):
    from strelka_tpu_torch.display import DisplayFactory, HeadlessDisplay
    from strelka_tpu_torch.display.display import SettingsBinding
    from strelka_tpu_torch.render.buffer import BufferFormat, ImageBuffer

    png = tmp_path / "frame.png"
    d = DisplayFactory.create_display(headless=True, png_path=str(png), png_every_n=1)
    assert isinstance(d, HeadlessDisplay)
    d.init(8, 8, None)
    frame = np.random.default_rng(3).random((8, 8, 4), dtype=np.float32)
    d.draw_frame(ImageBuffer(data=frame, width=8, height=8, pixel_format=BufferFormat.FLOAT4))
    assert d.last_frame is not None and png.exists()
    np.testing.assert_array_equal(np.round(read_png(str(png)) * 255.0).astype(np.uint8), to_uint8(frame[::-1, :, :3]))

    s = make_default_settings()
    binding = SettingsBinding(s)
    assert any(key == "render/pt/debug" for _, key, _, _, _ in binding.knobs())
    binding.set("render/pt/debug", 1)
    assert s.get_int("render/pt/debug") == 1


def test_panel_controller_hotkeys():
    from strelka_tpu_torch.app.viewer import CompositeHandler, PanelController
    from strelka_tpu_torch.display.display import SettingsBinding

    s = make_default_settings(8, 8)
    panel = PanelController(SettingsBinding(s))
    panel.key_press("g", "press")
    assert s.get_int("render/pt/debug") == 1
    for _ in range(3):
        panel.key_press("g", "press")
    assert s.get_int("render/pt/debug") == 0  # wraps
    panel.key_press("t", "press")
    assert s.get_int("render/pt/tonemapperType") == 1
    acc0 = s.get_bool("render/pt/enableAcc")
    panel.key_press("p", "press")
    assert s.get_bool("render/pt/enableAcc") is not acc0
    d0 = s.get_int("render/pt/depth")
    panel.key_press("]", "press")
    assert s.get_int("render/pt/depth") == d0 + 1
    panel.key_press("[", "press")
    panel.key_press("[", "press")
    assert s.get_int("render/pt/depth") == d0 - 1
    panel.key_press("c", "press")
    assert panel.screenshot_requested
    hits = []

    class Probe:
        def key_press(self, key, action):
            hits.append(key)

    CompositeHandler(Probe(), Probe()).key_press("w", "press")
    assert hits == ["w", "w"]


def test_web_display_endpoints(tmp_path):
    from strelka_tpu_torch.display.web import WebDisplay
    from strelka_tpu_torch.render.buffer import ImageBuffer

    ctx = SharedContext(make_default_settings(16, 16))
    disp = WebDisplay(port=0)  # auto-assign
    keys = []

    class _H:
        def key_press(self, key, action):
            keys.append(key)

    try:
        disp.init(16, 16, ctx)
        disp.set_input_handler(_H())
        frame = np.zeros((16, 16, 4), np.float32)
        frame[..., 0] = 1.0
        frame[:4, :, 1] = 0.5  # the bottom rows: the PNG shows them at its foot
        disp.draw_frame(ImageBuffer(frame))
        base = f"http://127.0.0.1:{disp.port}"
        png = urllib.request.urlopen(f"{base}/frame.png", timeout=10).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        (tmp_path / "served.png").write_bytes(png)
        served = np.round(read_png(str(tmp_path / "served.png")) * 255.0).astype(np.uint8)
        np.testing.assert_array_equal(served, to_uint8(frame[::-1, :, :3]))
        rows = json.loads(urllib.request.urlopen(f"{base}/knobs", timeout=10).read())
        assert any(key == "render/pt/depth" for _, key, *_ in rows)
        req = urllib.request.Request(f"{base}/set", data=json.dumps({"key": "render/pt/depth", "value": 7}).encode(),
                                     method="POST")
        urllib.request.urlopen(req, timeout=10)
        assert ctx.settings.get("render/pt/depth") == 7
        req = urllib.request.Request(f"{base}/key", data=json.dumps({"key": "w"}).encode(), method="POST")
        urllib.request.urlopen(req, timeout=10)
        assert keys == ["w"]
        urllib.request.urlopen(urllib.request.Request(f"{base}/quit", data=b"{}", method="POST"), timeout=10)
        assert disp.window_should_close()
        assert b"debug panel" in urllib.request.urlopen(f"{base}/", timeout=10).read()
    finally:
        disp.destroy()


@pytest.mark.parametrize("dtype", ["float32", "uint8"])
def test_encode_png_round_trip(tmp_path, dtype):
    rng = np.random.default_rng(5)
    img = rng.random((7, 9, 4), dtype=np.float32) * 1.2 - 0.1  # outside [0, 1] too: clipped
    if dtype == "uint8":
        img = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
    blob = encode_png(img)
    path = tmp_path / "x.png"
    write_png(str(path), img)
    assert path.read_bytes() == blob
    u8 = img if img.dtype == np.uint8 else to_uint8(img)
    np.testing.assert_array_equal(np.round(read_png(str(path)) * 255.0).astype(np.uint8), u8[::-1, :, :3])
    assert encode_png(img, flip=False) != blob
