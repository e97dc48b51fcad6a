"""The reference's frozen inputs agree with what the program is handed, on the
CPU at a small size: its Sobol draws, the hair strands, its reading of the
kitchen stage, and the frozen builders of the Cornell box and the box field,
down to the device tables each side builds from them."""

import os

import numpy as np
import pytest
import torch

import inputs

HAIR = inputs.scene_builder("hair_patch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITCHEN = {"scene": {"kind": "usd", "stage": "benchmark/data/kitchen/kitchen.usdc"}}


def test_sobol_draws_bit_equal():
    from refport.kernels import sobol as ref_sobol
    from strelka_tpu_torch.kernels import sobol as prog_sobol

    gen = torch.Generator().manual_seed(7)
    idx = torch.randint(0, 2 ** 32, (4096,), generator=gen, dtype=torch.int64)
    for depth in range(4):
        want = prog_sobol.random_dims_plain(idx, depth, (0, 1, 2, 3, 4))
        got = ref_sobol.random_dims(idx, depth, (0, 1, 2, 3, 4))
        assert torch.equal(want.view(torch.int32), got.view(torch.int32)), depth


def test_strands_are_hair_patch():
    """The frozen strand arithmetic draws the program's hair_patch strands from the same generator."""
    from strelka_tpu_torch.scene.testscenes import hair_patch

    prog = hair_patch(n_curves=24, ctrl_per_curve=8, seed=3)
    arrays = HAIR.hair_patch_arrays(24, 8, np.random.default_rng(3))
    np.testing.assert_array_equal(np.concatenate(prog.curve_points), arrays["points"])
    np.testing.assert_array_equal(np.concatenate(prog.curve_vertex_counts), arrays["counts"])
    np.testing.assert_array_equal(np.concatenate(prog.curve_widths), arrays["widths"])
    # a run's strands are these, in the order its seed draws
    spec = {"n_curves": 24, "ctrl_per_curve": 8, "strand_seed": 3}
    runs = [HAIR.hair_strands(spec, seed) for seed in (0, 2 ** 31 + 3)]
    assert not np.array_equal(runs[0]["points"], runs[1]["points"])
    for run in runs:
        assert sorted(map(bytes, run["points"].reshape(24, -1))) == sorted(map(bytes, arrays["points"].reshape(24, -1)))


def _tables(side: str, config: dict, seed: int):
    if side == "program":
        from strelka_tpu_torch.materials import MaterialManager
        from strelka_tpu_torch.render.device_scene import build_device_scene
    else:
        from refport.materials import MaterialManager
        from refport.render.device_scene import build_device_scene
    host = inputs.load_scene(side, ROOT, config, seed)
    return host, build_device_scene(host, MaterialManager(), device=torch.device("cpu"), use_bvh=False)


def _assert_same_tables(a, b):
    for name in ("v0", "e1", "e2", "geom_mask", "attr_table", "mat_table", "light_table", "cone_geom", "cone_attr",
                 "cone_bounds", "cone_sbounds"):
        if getattr(a, name, None) is None:
            assert getattr(b, name, None) is None, name
            continue
        x, y = getattr(a, name), getattr(b, name)
        assert x.shape == y.shape and torch.equal(x.view(torch.int32) if x.dtype == torch.float32 else x,
                                                  y.view(torch.int32) if y.dtype == torch.float32 else y), name
    assert a.num_lights == b.num_lights and a.num_triangles == b.num_triangles


def test_kitchen_stage_read_alike():
    """Both sides read the stage into the same device tables, texture atlas and camera."""
    pa, a = _tables("program", KITCHEN, 0)
    pb, b = _tables("reference", KITCHEN, 0)
    _assert_same_tables(a, b)
    for x, y in zip(a.textures, b.textures):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor) else np.array_equal(x, y))
    ca, cb = pa.get_camera(0), pb.get_camera(0)
    assert ca.fov == cb.fov
    np.testing.assert_array_equal(ca.matrices.view, cb.matrices.view)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_hair_scene_built_alike(seed):
    config = {"scene": {"kind": "hair_patch", "n_curves": 40, "ctrl_per_curve": 8, "strand_seed": 3}}
    _, a = _tables("program", config, seed)
    _, b = _tables("reference", config, seed)
    _assert_same_tables(a, b)
    assert a.num_cones == b.num_cones > 0


def _config(name: str) -> dict:
    import json

    with open(os.path.join(ROOT, "benchmark", "configs", name + ".json")) as f:
        return json.load(f)


def _generated(name: str):
    """The program's own generator of a configuration's scene, with the configuration's arguments."""
    from strelka_tpu_torch.scene import testscenes as TS

    if name == "cornell":
        return TS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True)
    spec = _config(name)["scene"]
    return TS.box_field(grid=spec["grid"], seed=spec["field_seed"])


@pytest.mark.parametrize("name", ["cornell", "box_field"])
def test_frozen_builder_is_the_generator(name):
    """The frozen builder gives the program the triangles, materials, lights and
    camera of the generator (cornell_box(5000, metal box, glass sphere),
    box_field(48, 7)), bit for bit, whatever the run's seed."""
    from strelka_tpu_torch.materials import MaterialManager
    from strelka_tpu_torch.render.device_scene import build_device_scene

    config = _config(name)
    want_host = _generated(name)
    want = build_device_scene(want_host, MaterialManager(), device=torch.device("cpu"), use_bvh=False)
    for seed in (0, 2 ** 31 + 13):
        host, got = _tables("program", config, seed)
        _assert_same_tables(got, want)
        assert [m.name for m in host.materials] == [m.name for m in want_host.materials]
        np.testing.assert_array_equal(host.get_camera(0).matrices.view, want_host.get_camera(0).matrices.view)
        assert host.get_camera(0).fov == want_host.get_camera(0).fov
    assert got.num_triangles == config["sizes"]["triangles"] and got.num_lights == config["sizes"]["lights"]


@pytest.mark.parametrize("name", ["cornell", "box_field"])
def test_added_scene_built_alike(name):
    """Both sides build the same device tables from the frozen builder."""
    _, a = _tables("program", _config(name), 4)
    _, b = _tables("reference", _config(name), 4)
    _assert_same_tables(a, b)
