"""The Einar-class character stage (scene/character_gen.py) on the CPU, at a
small size: a 40 x 25 bust grid (2,000 triangles) and 400 strands (320 scalp,
80 beard: 2,000 segments, 16,000 cones), a 64x64 texture.

(a) the generator writes the same bytes twice;
(b) the port's UsdLoader reads the stated counts, detects the hair material
    as hair (the MDL hair df), and the lights and camera as built;
(c) the vectorised BasisCurves bake (loaders/usd.py:_bake_curves) gives the
    arrays of the element-by-element conversion it replaced, bit for bit;
(d) the recorder on the mixed launch: the child spans of the two sweeps lie
    inside bounce.closest and bounce.shadow and tile bounce.closest within 2%
    (the reconciliation tolerance of tests/test_torch_profiling_card.py), the
    lanes whose closest hit is a curve and those whose closest hit is a
    triangle add up to the lanes that hit; with the recorder off the
    set-up spans usd.curves and the one-shot scene counters are there; a
    scene without curves keeps its span set;
(e) the plain walk of kernels K7/K8 with the reach the scene takes
    (ops/curves.py:cone_reach) equals the dense sweeps on the camera's rays,
    where without it the walk drops the closed form's ghost hits outside the
    thin cones' boxes (ROADMAP C.6);
(f) the port's launches on the CPU, driven by the benchmark's harness at
    16x12 (converge traffic, depth 3), against the benchmark's frozen
    reference (benchmark/refport/, each side loading the stage with its own
    UsdLoader) at max_gap 0 on every pixel: on CPU tensors both run the
    dense cone sweep, so both keep the closed form's ghost hits alike;
(g) the port's render_launch against the JAX package's (each side loading
    the stage with its own UsdLoader) by the comparison of
    tests/test_torch_textured_render.py::test_coffeetable_render_launch_matches_jax
    (its _render_both: 16x16, 1 spp, depth 4; 99% of pixels within rtol 1e-3,
    means within 1e-3, AOV counters equal on 99% of pixels). It fails, as a
    strict xfail, by ROADMAP C.6: at this hair's width most hair hits are
    ghosts of the closed form at a discriminant near 0, which the two
    frameworks' roundings decide apart (98.83% of pixels within rtol 1e-3);
    a fix of C.6 turns it green.
"""

import json
import os

import numpy as np
import pytest
import torch

from strelka_tpu_torch.loaders.usd import UsdLoader
from strelka_tpu_torch.materials import BsdfType, MaterialManager
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.render.device_scene import build_device_scene
from strelka_tpu_torch.scene.character import CHARACTER_FILES, ensure_character
from strelka_tpu_torch.scene.scene import Scene
from strelka_tpu_torch.utils import profiling as P

SMALL = dict(around=40, down=25, scalp=320, beard=80, texture=64)
STRANDS = SMALL["scalp"] + SMALL["beard"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
    return ensure_character(str(tmp_path_factory.mktemp("character")), **SMALL)


def _load(loader, scene, path):
    assert loader().load(path, scene)
    return scene


def test_generator_writes_the_same_bytes_twice(stage, tmp_path):
    again = ensure_character(str(tmp_path), **SMALL)
    for rel in CHARACTER_FILES:
        with open(os.path.join(os.path.dirname(stage), rel), "rb") as a, open(os.path.join(tmp_path, rel), "rb") as b:
            assert a.read() == b.read(), rel
    assert ensure_character(str(tmp_path)) == again  # complete: taken as it is


def test_loaded_scene_is_as_built(stage):
    host = _load(UsdLoader, Scene(), stage)
    ds = build_device_scene(host, device="cpu")
    # the bust, the backdrop and the rect light's two triangles
    assert ds.num_triangles == 2 * SMALL["around"] * SMALL["down"] + 2 + 2 and ds.bvh is not None
    assert sum(len(c) for c in host.curve_vertex_counts) == STRANDS
    assert ds.num_cones == STRANDS * 5 * 8 and ds.has_curves and ds.has_hair
    compiled = MaterialManager().compile_scene_materials(host.materials)
    assert [m.bsdf_type for m in compiled] == [BsdfType.OMNI_PBR] * 3 + [BsdfType.HAIR]
    assert ds.textures is not None and ds.tex_columns == (12,)  # the skin's diffuse texture
    rect, distant = sorted(host.lights, key=lambda light: light.type)
    assert (rect.type, distant.type) == (0, 3)
    edges = np.linalg.norm(np.diff(rect.points[:, :3], axis=0), axis=1)
    np.testing.assert_allclose(sorted(edges)[:2], [0.6, 0.6], rtol=1e-5)
    assert distant.half_angle == pytest.approx(np.radians(3.0))
    cam = host.get_camera(0)
    assert cam.fov == pytest.approx(30.0, abs=1e-3)
    np.testing.assert_allclose(cam.position, [0.62, 0.06, 0.74], atol=1e-6)


def test_vectorised_curve_bake_is_bit_equal(stage):
    """The port's bake against the element-by-element conversion it replaced
    (the JAX package's loader keeps it), on both BasisCurves prims."""
    from strelka_tpu.loaders.usd import UsdLoader as JaxUsdLoader
    from strelka_tpu.scene.scene import Scene as JaxScene

    port = _load(UsdLoader, Scene(), stage)
    old = _load(JaxUsdLoader, JaxScene(), stage)
    assert len(port.curve_points) == len(old.curve_points) == 2
    for name in ("curve_points", "curve_widths", "curve_vertex_counts"):
        for a, b in zip(getattr(port, name), getattr(old, name)):
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), name


@pytest.fixture
def recorder():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    P.disable()
    P.reset()
    yield P
    P.disable()
    P.reset()
    torch.set_num_threads(threads)


def _launch(scene, host, size=24, depth=3):
    cam = host.get_camera(0)
    cam.update_aspect_ratio(1.0)
    params = TI.LaunchParams(1, np.asarray(cam.clip_to_view(), np.float32), np.asarray(cam.view_to_world(), np.float32),
                             np.full(3, 6.25e-4, np.float32), np.zeros(3, np.float32))
    kw = dict(width=size, height=size, samples_per_launch=1, max_sample_count=1024, max_depth=depth,
              enable_accumulation=True)
    with P.launch_record(scene.device):
        TI.render_launch(scene, params, TI.make_frame_state(size, size, "cpu"), **kw)


def test_mixed_launch_spans_and_hit_counts(stage, recorder, monkeypatch):
    host = _load(UsdLoader, Scene(), stage)
    names = [s["name"] for s in P.setup_spans()]
    assert names.count("usd.curves") == 2 and names[-1] == "scene.load"  # recorded with the recorder off
    scene = build_device_scene(host, device="cpu")
    counts = P.counters()
    assert counts["scene.cones"] == {"": STRANDS * 40} and counts["scene.curve_segments"] == {"": STRANDS * 5}
    assert counts["scene.triangles"] == {"": scene.num_triangles} and counts["cones.tree_levels"] == {"": 2}
    hits = []
    surface = TI.KSF.shade_surface

    def record(tables, hit, chit, origin, direction, inside, alive, *a, **k):
        sf = surface(tables, hit, chit, origin, direction, inside, alive, *a, **k)
        hits.append((int((alive & ((hit.prim >= 0) | sf.is_curve)).sum()), int(sf.is_curve.sum())))
        return sf

    monkeypatch.setattr(TI.KSF, "shade_surface", record)
    P.enable()
    _launch(scene, host)
    got = P.collect()
    lanes, device = got["lanes"], got["device"]
    assert [c + t for c, t in zip(lanes["curve_hits"], lanes["triangle_hits"])] == [h for h, _ in hits]
    assert lanes["curve_hits"] == [c for _, c in hits] and lanes["curve_hits"][0] > 0 and lanes["triangle_hits"][0] > 0
    children = {"closest.triangles": "bounce.closest", "closest.curves": "bounce.closest",
                "shadow.triangles": "bounce.shadow", "shadow.curves": "bounce.shadow"}
    by_parent: dict = {}
    for i, d in enumerate(device):
        if d["name"] in children:
            parent = device[d["parent"]]
            assert parent["name"] == children[d["name"]] and parent["bounce"] == d["bounce"]
            assert parent["start_ms"] <= d["start_ms"] <= d["end_ms"] <= parent["end_ms"]
            by_parent.setdefault(d["parent"], []).append(d)
    closest = [i for i, d in enumerate(device) if d["name"] == "bounce.closest"]
    assert len(closest) == 3 and all(len(by_parent[i]) == 2 for i in closest)
    for i in closest:
        covered = sum(c["ms"] for c in by_parent[i])
        assert covered <= device[i]["ms"] and covered >= 0.98 * device[i]["ms"], (covered, device[i]["ms"])
    assert sum(d["name"] == "shadow.curves" for d in device) == 3


def test_scene_without_curves_keeps_its_spans(recorder):
    from strelka_tpu_torch.scene import testscenes as TTS

    host = TTS.cornell_box()
    scene = build_device_scene(host, device="cpu")
    assert P.counters()["cones.tree_levels"] == {"": 0} and P.counters()["scene.curve_segments"] == {"": 0}
    P.enable()
    _launch(scene, host, size=8, depth=2)
    got = P.collect()
    names = {d["name"] for d in got["device"]}
    assert names == {"launch.camera", "bounce.sample", "bounce.closest", "bounce.surface", "bounce.bsdf", "bounce.nee",
                     "bounce.shadow", "bounce.next", "launch.accumulate"}
    assert got["lanes"]["curve_hits"] == [0, 0] and got["lanes"]["triangle_hits"][0] > 0


def test_tree_walk_with_the_scene_reach_equals_the_dense_sweeps(stage):
    """The plain walk of kernels K7/K8 (ops/curves.py:cone_tree_walk) with the
    reach the scene takes (ops/curves.py:cone_reach) against the dense
    sweeps on the stage camera's rays at 128x96: the same closest t and
    occlusion on every ray. Without the reach the walk drops ghost hits
    outside the thin cones' boxes (ROADMAP C.6), which the sweeps keep."""
    from strelka_tpu_torch.ops import curves as C
    from strelka_tpu_torch.scene import testscenes as TTS

    host = _load(UsdLoader, Scene(), stage)
    scene = build_device_scene(host, device="cpu")
    assert scene.cone_reach == C.CONE_REACH
    assert build_device_scene(TTS.hair_patch(n_curves=64), device="cpu").cone_reach == 0.0
    w, h = 128, 96
    cam = host.get_camera(0)
    cam.update_aspect_ratio(w / h)
    params = TI.LaunchParams(1, np.asarray(cam.clip_to_view(), np.float32), np.asarray(cam.view_to_world(), np.float32),
                             np.ones(3, np.float32), np.zeros(3, np.float32))
    py, px = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    half = torch.full((w * h,), 0.5)
    o, d = TI.generate_camera_rays(params, px.reshape(-1), py.reshape(-1), half, half, w, h)
    tmin, tmax = torch.zeros(w * h), torch.full((w * h,), 1e16)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        t_p, c_p, _ = C.intersect_curves_closest_plain(scene.cone_geom, o, d, tmin, tmax)
        occ = C.intersect_curves_any_plain(scene.cone_geom, o, d, tmin, tmax)
        walks = {reach: (C.cone_tree_walk(scene.cone_geom, scene.cone_tree, o, d, tmin, tmax, reach=reach).t,
                         C.cone_tree_walk(scene.cone_geom, scene.cone_tree, o, d, tmin, tmax, any_hit=True,
                                          reach=reach).t < C.MISS_T)
                 for reach in (scene.cone_reach, 0.0)}
    finally:
        torch.set_num_threads(threads)
    assert int((c_p >= 0).sum()) > 100
    t, hit = walks[scene.cone_reach]
    assert torch.equal(t.view(torch.int32), t_p.view(torch.int32)) and torch.equal(hit, occ)
    t0, hit0 = walks[0.0]
    assert int((t0 != t_p).sum()) > 0  # the rays the reach is for


def _stage_cell(harness, stage, width, height):
    """A converge cell of the benchmark (its traffic and limits) on the small
    stage, at the stage's own camera, every pixel compared."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.Cell(json.load(f), "hair_long-converge")
    cam = _load(UsdLoader, Scene(), stage).get_camera(0)
    v2w = np.asarray(cam.view_to_world(), np.float64)
    eye = v2w[:3, 3]
    cell.config = {"scene": {"kind": "character"}, "depth": 3, "spp_total": 1024, "settings": {},
                   "camera": {"eye": eye.tolist(), "target": (eye - v2w[:3, 2]).tolist(), "orbit_span_deg": 20.0,
                              "route_steps": 128}}
    cell.traffic = dict(cell.traffic, width=width, height=height)
    cell.limits = dict(cell.limits, pixels=width * height)
    return cell


def test_cpu_launches_equal_the_benchmark_reference(stage, recorder, monkeypatch):
    monkeypatch.syspath_prepend(BENCH)
    import harness
    import inputs

    def load_scene(side, root, config, seed):
        return _load(inputs.side_modules(side).UsdLoader, inputs.side_modules(side).scene.Scene(), stage)

    monkeypatch.setattr(inputs, "load_scene", load_scene)
    cell = _stage_cell(harness, stage, 16, 12)
    run = harness.run_cell(cell, 2 ** 31 + 24, 4.0, False, "cpu")
    compared = run["result"]["compared"]
    assert run["samples_per_pixel"] >= 2, run["samples_per_pixel"]
    assert compared["max_gap"]["value"] == 0.0, compared
    assert run["result"]["correct"] and compared["max_gap"]["value"] == 0.0 and compared["samples_off"]["value"] == 0.0


@pytest.mark.xfail(strict=True, raises=AssertionError,
                   reason="ROADMAP C.6: the round cone's closed form reports ghost hits at this hair's width")
def test_render_launch_matches_jax(stage):
    from strelka_tpu.loaders.usd import UsdLoader as JaxUsdLoader
    from strelka_tpu.scene.scene import Scene as JaxScene
    from test_torch_textured_render import _render_both

    port_host = _load(UsdLoader, Scene(), stage)
    _render_both(_load(JaxUsdLoader, JaxScene(), stage), lambda jds: build_device_scene(port_host, device="cpu"))
