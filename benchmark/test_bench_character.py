"""The character cell (character-converge) on the CPU at a small size: its
frozen builder writes the program generator's stage byte for byte, both sides
read it into the same device tables, the reference side loads nothing of the
program, a program without the cone kernels' reach stops at the set-up, and
a run with the timed path broken underneath comes out not correct
(test_bench_faults.py's faults and control), where the sound run is correct
and reads `curves_load_s`. Marked `card`: the same runs at the cell's own
size."""

import json
import os

import pytest
import torch

import harness
import inputs
from test_bench_faults import FAULTS, SETUP_PARTS
from test_bench_independence import _top_level_names
from test_bench_inputs import _assert_same_tables, _tables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILDER = inputs.scene_builder("character")
SMALL = dict(around=40, down=25, scalp=320, beard=80, texture=64)  # tests/test_torch_character.py's stage
CELL = "character-converge"


def _config() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", "character.json")) as f:
        return json.load(f)


def _small() -> dict:
    config = _config()
    config["scene"] = dict(config["scene"], **SMALL)
    return config


def test_frozen_stage_is_the_generators(tmp_path):
    """The builder's stage and texture are the bytes of the program's
    ensure_character with the same arguments, and the configuration's are
    the generator's full size and seed."""
    import inspect

    from strelka_tpu_torch.scene import character_gen as G
    from strelka_tpu_torch.scene.character import CHARACTER_FILES, ensure_character

    spec = _small()["scene"]
    got = os.path.dirname(BUILDER.ensure_stage(spec))
    want = os.path.dirname(ensure_character(str(tmp_path), **SMALL, seed=spec["stage_seed"]))
    assert BUILDER.FILES == CHARACTER_FILES
    for rel in BUILDER.FILES:
        with open(os.path.join(got, rel), "rb") as a, open(os.path.join(want, rel), "rb") as b:
            assert a.read() == b.read(), rel
    full = _config()["scene"]
    assert {k: full[k] for k in G.FULL} == G.FULL
    assert inspect.signature(G.build_character_stage).parameters["seed"].default == full["stage_seed"]
    assert BUILDER.ensure_stage(spec) == os.path.join(got, BUILDER.FILES[0])  # the cache is taken as it is


def test_stage_cache_is_named_by_the_spec():
    a = BUILDER.stage_dir(_small()["scene"])
    assert a == BUILDER.stage_dir(dict(_small()["scene"]))
    assert a != BUILDER.stage_dir(dict(_small()["scene"], beard=81))
    assert os.path.commonpath([a, ROOT]) != ROOT  # outside the checkout


def test_character_stage_read_alike():
    _, a = _tables("program", _small(), 4)
    _, b = _tables("reference", _small(), 4)
    _assert_same_tables(a, b)
    assert a.num_cones == b.num_cones == (SMALL["scalp"] + SMALL["beard"]) * 40 and a.textures is not None


def test_builder_gives_the_reference_no_program():
    scene = {"scene": _small()["scene"]}
    names = _top_level_names(f"inputs.load_scene('reference', {ROOT!r}, {scene!r}, 3)")
    assert not names & {"jax", "jaxlib", "flax", "strelka_tpu", "strelka_tpu_torch"}, names


def test_a_program_without_the_reach_stops_at_the_set_up(monkeypatch):
    """A program whose cone kernels lack the closed form's reach renders the
    stage wrongly: its run stops when the scene is built, before any timing."""
    from strelka_tpu_torch.ops import curves

    monkeypatch.delattr(curves, "cone_reach")
    with pytest.raises(RuntimeError, match="reach"):
        inputs.load_scene("program", ROOT, _small(), 3)
    inputs.load_scene("reference", ROOT, _small(), 3)  # the reference is not the program


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.card)], ids=["cpu", "card"])
def device(request):
    """The CPU on the small stage at 16x12, or the card at the cell's own size."""
    if request.param == "cuda":
        request.getfixturevalue("card")
    return request.param


def _cell(device):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.Cell(json.load(f), CELL)
    if device == "cpu":
        cell.config = _small()
        cell.traffic = dict(cell.traffic, width=16, height=12)
        cell.limits = dict(cell.limits, pixels=24)
        torch.set_num_threads(2)
    return cell


def _run(device, control=False):
    return harness.run_cell(_cell(device), 2 ** 31 + 77, 3.0 if device == "cpu" else 2.0, False, device,
                            control=control)


def test_sound_run_is_correct(device):
    run = _run(device)
    result = run["result"]
    assert result["correct"], result["compared"]
    assert result["compared"]["samples_off"]["value"] == 0.0
    cell = _cell(device)
    parts = [harness.load_reader(cell.metrics_dir, part)(run["record"]) for part in SETUP_PARTS]
    assert all(p > 0 for p in parts) and sum(parts) < run["record"]["setup_s"], parts
    curves = harness.load_reader(cell.metrics_dir, "curves_load_s")(run["record"])
    assert 0 < curves < parts[SETUP_PARTS.index("scene_load_s")]


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["control"])
def test_each_fault_and_the_control_fail(fault, device, monkeypatch):
    from strelka_tpu_torch.ops import integrator as I

    if fault != "control":
        FAULTS[fault](I, monkeypatch)
    result = _run(device, control=fault == "control")["result"]
    assert not result["correct"], (fault, result["compared"])
