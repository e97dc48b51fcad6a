"""scripts/torch_northstar.py and torch_northstar_image.py on the CPU.

The north-star kitchen render (1024x768, 2048 spp on the card) at 32x24,
8 spp, 2 spp a launch, a checkpoint every launch (--cpu), run in-process
through the scripts' main(argv) under one torch thread (torch 2.13's CPU
sqrt can be wrong on its first call in a fresh worker thread, ROADMAP.md
section C):
(a) a run cut by --max-seconds at its first checkpoint and then resumed
    ends with the accumulator, AOVs and counters of an uninterrupted run,
    bit for bit;
(b) re-running a finished run renders nothing, writes its image and its
    row, and leaves the checkpoint as it was;
(c) the image script tonemaps with the exposure in the checkpoint's meta;
(d) without a card the script exits 1 unless --cpu is given; a checkpoint
    of another config is refused.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch_northstar as NS  # noqa: E402
import torch_northstar_image as NI  # noqa: E402

from strelka_tpu_torch.ops import tonemap as TM  # noqa: E402
from strelka_tpu_torch.render.checkpoint import load_meta  # noqa: E402
from strelka_tpu_torch.utils.image import read_png  # noqa: E402

ARGS = ["--cpu", "--w", "32", "--h", "24", "--spp", "8", "--spl", "2", "--ckpt-every", "1"]


def _args(d, name, *extra):
    return ARGS + ["--ckpt", str(d / f"{name}.npz"), "--image", str(d / f"{name}.png"),
                   "--out-json", str(d / f"{name}.json"), *extra]


def _arrays(path):
    with np.load(path) as data:
        return {k: data[k].copy() for k in data.files if k.startswith("state_") or k == "subframe_index"}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("northstar")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        assert NS.main(_args(d, "full")) == 0
        assert NS.main(_args(d, "cut", "--max-seconds", "1e-9")) == 0
        cut = _arrays(d / "cut.npz")
        cut_outputs = (d / "cut.png").exists(), (d / "cut.json").exists()
        assert NS.main(_args(d, "cut")) == 0  # resumed
    finally:
        torch.set_num_threads(threads)
    return d, cut, cut_outputs


def test_cut_and_resumed_equals_uninterrupted(runs):
    d, cut, cut_outputs = runs
    assert int(cut["subframe_index"]) == 2  # stopped at its first checkpoint
    assert cut_outputs == (False, False)  # a cut run writes no image and no row
    full, resumed = _arrays(d / "full.npz"), _arrays(d / "cut.npz")
    assert int(full["subframe_index"]) == int(resumed["subframe_index"]) == 8
    for k in full:
        assert full[k].dtype == resumed[k].dtype and np.array_equal(full[k], resumed[k]), k
    assert np.isfinite(full["state_0"]).all() and full["state_0"].mean() > 0.0
    assert np.array_equal(read_png(str(d / "full.png")), read_png(str(d / "cut.png")))
    meta = load_meta(str(d / "cut.npz"))
    assert {k: meta[k] for k in NS.CONFIG_KEYS} == dict(W=32, H=24, spp=8, spl=2, depth=4)
    assert meta["card"] == "cpu" and meta["elapsed_s"] > 0.0 and len(meta["exposure"]) == 3
    row = json.loads((d / "cut.json").read_text())
    assert row["complete"] and row["spp_done"] == 8 and row["card"] == "cpu"
    assert row["padded_mrays_per_s"] == pytest.approx(32 * 24 * 8 * 2 * 4 / row["value"] / 1e6)


def test_rerun_of_finished_run_writes_image(runs):
    d, _, _ = runs
    before = _arrays(d / "full.npz")
    (d / "full.png").unlink()
    (d / "full.json").unlink()
    assert NS.main(_args(d, "full")) == 0
    assert (d / "full.png").exists()
    row = json.loads((d / "full.json").read_text())
    assert row["complete"] and row["spp_done"] == 8 and row["this_run_load_s"] == 0.0
    after = _arrays(d / "full.npz")
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_image_script_takes_exposure_from_meta(runs, tmp_path):
    d, _, _ = runs
    src = str(d / "full.npz")
    meta = load_meta(src)
    assert np.allclose(meta["exposure"], 6.25e-4)  # the default settings' ISO 100, f/4, 1/100 s
    # a copy whose meta says another exposure
    with np.load(src) as data:
        arrays = {k: data[k] for k in data.files}
    arrays["meta_exposure"] = np.asarray(meta["exposure"], np.float32) * 8.0
    other = str(tmp_path / "other.npz")
    np.savez_compressed(other, **arrays)
    shutil.copy(src, tmp_path / "same.npz")
    images = []
    for ckpt, exposure in ((str(tmp_path / "same.npz"), meta["exposure"]), (other, arrays["meta_exposure"])):
        assert NI.main(["--ckpt", ckpt, str(tmp_path / "out.png")]) == 0
        accum = torch.tensor(arrays["state_0"])
        want = TM.apply_tonemap_planar(accum, TM.ToneMapperType.eReinhard, np.asarray(exposure, np.float32), 2.4)
        want = np.clip(want.numpy().transpose(1, 2, 0), 0.0, 1.0)[::-1]  # the PNG's rows are bottom-up
        got = read_png(str(tmp_path / "out.png"))[..., :3]
        assert got.shape == want.shape and np.abs(got - want).max() <= 1.0 / 255 + 1e-6
        images.append(got)
    assert not np.array_equal(images[0], images[1])  # the exposure moved the image
    assert NI.main(["--ckpt", str(tmp_path / "missing.npz")]) == 1


def test_no_card_and_other_config(runs, monkeypatch, capsys):
    d, _, _ = runs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in _args(d, "nocard") if a != "--cpu"]
    assert NS.main(argv) == 1
    assert "no CUDA device" in capsys.readouterr().err and not (d / "nocard.npz").exists()
    other = _args(d, "full")
    other[other.index("--spp") + 1] = "16"
    assert NS.main(other) == 2
