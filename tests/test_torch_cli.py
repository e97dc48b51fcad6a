"""The port's CLI, `python -m strelka_tpu_torch.app.cli`.

(a) With --cpu, a 16x16 Cornell render exits 0 and writes a PNG equal, pixel
    for pixel, to what an in-process TorchRender(device="cpu") renders with
    the same settings (to_uint8, flipped upright as write_png writes it);
(b) without --cpu, on a host with no CUDA card, it exits non-zero and names
    the missing CUDA device (it never falls back to the CPU);
(c) --checkpoint after 2 of 4 samples, then --resume, gives accumulators
    bit-equal to one uninterrupted run;
(d) --profile writes a torch.profiler trace that summarize_trace reads (on
    the CPU: host operators, no device kernel);
(e) the PNG name without -o follows the hdRunner scheme (cli.py's
    <scene>_<iter>i_<depth>d_<spp>spp_0.png);
(f) --play-animation on a .gltf with an animated camera node starts the
    accumulation again every frame;
(g) the USD runner and the viewer, too, exit non-zero without a card.
(a) and (b) run the module in a subprocess; the rest call main(argv).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from strelka_tpu_torch.app import cli
from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
from strelka_tpu_torch.render.render import RenderFactory
from strelka_tpu_torch.settings import SharedContext, make_default_settings
from strelka_tpu_torch.utils.image import read_png, to_uint8
from strelka_tpu_torch.utils.profiling import summarize_trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["-s", "builtin://cornell_box", "--width", "16", "--height", "16"]


def _run(*extra):
    # one torch thread: ROADMAP.md section C, torch 2.13's first-call CPU sqrt
    env = dict(os.environ, OMP_NUM_THREADS="1", CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "strelka_tpu_torch.app.cli", *ARGS, *extra], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=300)


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _in_process(width=16, height=16, spp_total=2, spp=2):
    s = make_default_settings(width, height)
    s.set("render/pt/sppTotal", spp_total)
    s.set("render/pt/spp", spp)
    s.set("render/pt/depth", 4)
    r = RenderFactory.create_render(device="cpu")
    r.set_scene(cli.load_scene("builtin://cornell_box"))
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(width, height, BufferFormat.FLOAT4))
    r.render(buf)
    return buf.map()


def test_cli_png_equals_in_process_render(tmp_path, one_thread):
    out = tmp_path / "out.png"
    r = _run("-t", "2", "-f", "2", "--cpu", "-o", str(out))
    assert r.returncode == 0, r.stderr[-2000:]
    assert "[2 spp]" in r.stdout  # the per-frame title line
    assert "Rendered 2 spp" in r.stderr  # the summary, in the log
    png = np.round(read_png(str(out)) * 255.0).astype(np.uint8)
    ref = to_uint8(_in_process()[..., :3])[::-1]
    assert png.shape == ref.shape == (16, 16, 3)
    np.testing.assert_array_equal(png, ref)


def test_cli_without_cpu_and_without_card_fails():
    r = _run("-t", "2", "-f", "2")
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def _state(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_checkpoint_resume_is_bitexact(tmp_path, one_thread):
    base = ARGS + ["-t", "4", "-f", "2", "--cpu"]
    half, resumed, whole = (str(tmp_path / f"{n}.npz") for n in ("half", "resumed", "whole"))
    assert cli.main(base + ["-i", "1", "--checkpoint", half]) == 0
    assert cli.main(base + ["--resume", half, "--checkpoint", resumed]) == 0
    assert cli.main(base + ["--checkpoint", whole]) == 0
    a, b, c = _state(half), _state(resumed), _state(whole)
    assert int(a["subframe_index"]) == 2 and int(b["subframe_index"]) == int(c["subframe_index"]) == 4
    assert b.keys() == c.keys()
    for k in c:
        np.testing.assert_array_equal(b[k], c[k], err_msg=k)
    assert not np.array_equal(a["state_0"], c["state_0"])


def test_profile_writes_a_trace(tmp_path, one_thread):
    trace = str(tmp_path / "trace")
    assert cli.main(ARGS + ["-t", "2", "-f", "2", "--cpu", "--profile", trace, "-o", str(tmp_path / "p.png")]) == 0
    ops = dict(summarize_trace(trace, top=200, category="cpu_op"))
    assert ops and all(ms >= 0.0 for ms in ops.values())
    assert any(name.startswith("aten::") for name in ops)
    assert summarize_trace(trace) == []  # no card, no device kernel


def test_play_animation_moves_the_gltf_camera(tmp_path, one_thread):
    """--play-animation on a glTF whose camera node is animated: every frame
    moves the camera, so the accumulation starts again each frame."""
    from test_torch_gltf import _write

    scene = _write(tmp_path, "animated")
    base = ["-s", scene, "--width", "16", "--height", "16", "-t", "8", "-f", "2", "-i", "3", "--cpu"]
    moving, still = str(tmp_path / "moving.npz"), str(tmp_path / "still.npz")
    assert cli.main(base + ["--play-animation", "--checkpoint", moving]) == 0
    assert cli.main(base + ["--checkpoint", still]) == 0
    assert int(_state(moving)["subframe_index"]) == 2 and int(_state(still)["subframe_index"]) == 6


@pytest.mark.parametrize("app", ["usd_runner", "viewer"])
def test_other_apps_without_card_fail(tmp_path, monkeypatch, app):
    import importlib

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = importlib.import_module(f"strelka_tpu_torch.app.{app}").main
    stage = tmp_path / "stage.usda"
    stage.write_text("#usda 1.0\n")
    assert main(["-s", str(stage) if app == "usd_runner" else "builtin://cornell_box"]) == 1


def test_screenshot_name_follows_the_hdrunner_scheme(tmp_path, one_thread, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert cli.main(ARGS + ["-t", "2", "-f", "2", "--cpu", "-c"]) == 0
    assert os.path.exists(tmp_path / "cornell_box_1i_4d_2spp_0.png")
