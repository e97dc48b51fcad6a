"""A run with the timed path broken underneath comes out not correct.

Each case drives the whole of a run (set-up, the window, the check against
the reference) past the harness's look for a card: on the CPU at a small
size, and (marked `card`) on the card at the cell's own size. One fault is
planted in the program where its answer is produced: the launch returning
its state unchanged, half of the frame's pixels left out of the launch, the
paths' answers altered, the accumulation reset by the renderer where the
camera stood still. The sound run and the control (the reference in
bfloat16 put in the program's place) bracket them. The cells run on one
card, so there is no exchange between cards to leave out.
"""

import json
import os

import pytest
import torch

import harness

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = {"kitchen-converge": (16, 12), "kitchen-viewport": (32, 24), "cornell-converge": (16, 12),
        "box_field-converge": (16, 12)}
ADDED = ["cornell-converge", "box_field-converge"]  # cells whose faults are checked cell by cell


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.card)], ids=["cpu", "card"])
def device(request):
    """The CPU at a small size, or the card at the cell's own size."""
    if request.param == "cuda":
        request.getfixturevalue("card")
    return request.param


def _cell(name, device):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.Cell(json.load(f), name)
    if device == "cpu":
        w, h = SIZE[name]
        cell.traffic = dict(cell.traffic, width=w, height=h)
        cell.limits = dict(cell.limits, pixels=24)
        if cell.traffic["map_each_frame"]:  # a drag of 2 frames: the CPU's few frames reach the still ones
            cell.traffic["cycle"] = [dict(cell.traffic["cycle"][0], frames=2)] + cell.traffic["cycle"][1:]
    return cell


def _run(cell, device, control=False):
    if device == "cpu":
        torch.set_num_threads(2)
    seconds = 3.0 if device == "cpu" else 2.0  # three frames or more on the CPU: an image accumulates
    return harness.run_cell(cell, 2 ** 31 + 77, seconds, False, device, control=control)["result"]


def _state_unchanged(I, monkeypatch):
    launch = I.render_launch

    def broken(scene, params, state, **kw):
        launch(scene, params, state, **kw)
        return state, state.accum

    monkeypatch.setattr(I, "render_launch", broken)


def _half_left_out(I, monkeypatch):
    launch = I.render_launch

    def broken(scene, params, state, **kw):
        new_state, image = launch(scene, params, state, **kw)
        half = image.shape[-1] // 2
        new_state.accum[..., half:] = state.accum[..., half:]
        return new_state, new_state.accum

    monkeypatch.setattr(I, "render_launch", broken)


def _answer_altered(I, monkeypatch):
    trace = I.trace_paths

    def broken(*a, **kw):
        radiance, first_event, stats = trace(*a, **kw)
        return type(radiance)(radiance.z, radiance.y, radiance.x), first_event, stats

    monkeypatch.setattr(I, "trace_paths", broken)


def _accumulation_reset(I, monkeypatch):
    """The renderer restarts its accumulation at every frame, and so counts one sample where the schedule put many."""
    from strelka_tpu_torch.render.render import TorchRender

    render = TorchRender.render

    def broken(self, output):
        self._ctx.subframe_index = 0
        return render(self, output)

    monkeypatch.setattr(TorchRender, "render", broken)


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out, "answer_altered": _answer_altered,
          "accumulation_reset": _accumulation_reset}


def test_sound_run_is_correct_and_its_line_is_whole(device):
    result = _run(_cell("kitchen-converge", device), device)
    assert result["correct"], result["compared"]
    assert result["compared"]["samples_off"]["value"] == 0.0
    assert list(result) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert set(result["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(result["metrics"]) == {"setup_s", "msamples_per_s"}
    assert all(set(c) == {"value", "limit"} for c in result["compared"].values())


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_caught(fault, device, monkeypatch):
    from strelka_tpu_torch.ops import integrator as I

    FAULTS[fault](I, monkeypatch)
    result = _run(_cell("kitchen-converge", device), device)
    assert not result["correct"], (fault, result["compared"])


def test_viewport_answer_altered_is_caught(device, monkeypatch):
    from strelka_tpu_torch.ops import integrator as I

    _answer_altered(I, monkeypatch)
    assert not _run(_cell("kitchen-viewport", device), device)["correct"]


def test_control_is_not_correct(device):
    result = _run(_cell("kitchen-converge", device), device, control=True)
    assert not result["correct"], result["compared"]


SETUP_PARTS = ("start_s", "scene_load_s", "init_s", "first_launch_s", "capture_s")  # setup_s less one replay


@pytest.mark.parametrize("name", ADDED)
def test_sound_run_of_an_added_cell_is_correct(name, device):
    cell = _cell(name, device)
    if device == "cpu":
        torch.set_num_threads(2)
    run = harness.run_cell(cell, 2 ** 31 + 77, 3.0 if device == "cpu" else 2.0, False, device)
    result = run["result"]
    assert result["correct"], result["compared"]
    assert result["compared"]["samples_off"]["value"] == 0.0
    # the set-up readers tile setup_s up to its one replay
    parts = [harness.load_reader(cell.metrics_dir, part)(run["record"]) for part in SETUP_PARTS]
    assert all(p > 0 for p in parts) and sum(parts) < run["record"]["setup_s"], parts


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["control"])
@pytest.mark.parametrize("name", ADDED)
def test_each_fault_and_the_control_fail_an_added_cell(name, fault, device, monkeypatch):
    from strelka_tpu_torch.ops import integrator as I

    if fault != "control":
        FAULTS[fault](I, monkeypatch)
    result = _run(_cell(name, device), device, control=fault == "control")
    assert not result["correct"], (name, fault, result["compared"])
