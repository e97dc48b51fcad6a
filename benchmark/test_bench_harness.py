"""The harness on the CPU: cells resolve from their files by name, a new cell is
new files and an entry, the window's arithmetic, the roofline counts on
hand-worked rays and boxes, and BENCHMARK.json's names, units and keys."""

import json
import os
import re
import shutil

import numpy as np
import pytest
import torch

import bounds
import harness
import reference
import inputs
import tracing

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", [w["name"] for w in _bench()["workloads"]])
def test_each_cell_resolves_from_its_files(name):
    cell = harness.Cell(_bench(), name)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer, name
    for m in cell.per_layer:
        assert m["moves"] in names, (name, m["name"])
        assert callable(harness.load_reader(cell.metrics_dir, m["name"]))
    assert cell.limits["compare"] and cell.limits["pixels"] > 0
    assert cell.render_settings()["render/pt/depth"] == cell.config["depth"]


def test_a_new_cell_is_new_files_and_an_entry(tmp_path):
    bench_dir = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(os.path.join(BENCH_DIR, sub), bench_dir / sub)
    bench = _bench()
    (bench_dir / "traffic" / "burst.json").write_text(json.dumps(
        {"width": 640, "height": 480, "spp_per_frame": 1, "spp_total": 16, "upscale": False,
         "upscale_factor": 0.5, "map_each_frame": True, "trace_frames": 4, "pose_stride": 4,
         "cycle": [{"frames": 4, "advance": "every"}, {"frames": 8, "advance": "none"}]}))
    (bench_dir / "limits" / "kitchen-burst.json").write_text(json.dumps(
        {"pixels": 16, "compare": {"max_gap": 1e-3, "samples_off": 0}}))
    bench["workloads"].append({"name": "kitchen-burst", "config": "kitchen", "traffic": "burst", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"][-1]["workloads"] = bench["end_to_end"][-1].get("workloads", []) + ["kitchen-burst"]
    cell = harness.Cell(bench, "kitchen-burst", bench_dir=str(bench_dir), root=ROOT)
    assert cell.traced_size() == (640, 480) and cell.spp_total() == 16
    assert [harness.Schedule(cell.traffic, 16, 1).step(f) for f in range(14)] == [0, 1, 2, 3] + [3] * 8 + [4, 5]


def test_a_new_scene_kind_is_a_new_file(tmp_path):
    """A builder in scenes/<kind>.py is found by name and builds both sides' scenes from the same arrays."""
    (tmp_path / "quad.py").write_text(
        "import numpy as np\n"
        "def build(side, root, spec, seed):\n"
        "    s = side.scene.Scene()\n"
        "    e = float(spec['extent'])\n"
        "    pos = np.array([[-e, 0, -e], [e, 0, -e], [e, 0, e], [-e, 0, e]], np.float32)\n"
        "    mesh = s.create_mesh(pos, np.array([0, 1, 2, 0, 2, 3], np.uint32))\n"
        "    mat = s.add_material(side.scene.MaterialDescription(type='mdl', file='default.mdl', name='m'))\n"
        "    s.create_instance(side.scene.InstanceType.eMesh, mesh, mat, side.math3d.identity4())\n"
        "    return s\n")
    builder = inputs.scene_builder("quad", scenes_dir=str(tmp_path))
    scenes = [builder.build(inputs.side_modules(side), ROOT, {"kind": "quad", "extent": 2.0}, 5)
              for side in ("program", "reference")]
    assert [(len(s.meshes), s.meshes[0].count, s.meshes[0].vertex_count) for s in scenes] == [(1, 6, 4)] * 2
    with pytest.raises(ValueError):
        inputs.scene_builder("no_such_kind", scenes_dir=str(tmp_path))


@pytest.mark.parametrize("cycle,total,want", [
    # the converge traffic: one pose until the image holds spp_total samples
    ([{"frames": None, "advance": "first"}], 4, [0, 0, 0, 0, 1, 1, 1, 1, 2, 2]),
    # a drag of 3 frames, then 2 still
    ([{"frames": 3, "advance": "every"}, {"frames": 2, "advance": "none"}], 64, [0, 1, 2, 2, 2, 3, 4, 5, 5, 5]),
    # a jump, 2 frames held, then a drag of 2
    ([{"frames": 3, "advance": "first"}, {"frames": 2, "advance": "every"}], 64, [0, 0, 0, 1, 2, 3, 3, 3, 4, 5]),
])
def test_schedules(cycle, total, want):
    assert [harness.Schedule({"cycle": cycle}, total, 1).step(f) for f in range(10)] == want


def test_viewport_schedule_never_fills_a_frame():
    with open(os.path.join(BENCH_DIR, "traffic", "viewport.json")) as f:
        view = harness.Schedule(json.load(f), 64, 1)
    steps = [view.step(f) for f in range(130)]
    assert steps[:16] == list(range(16)) and set(steps[16:64]) == {15} and steps[64:66] == [16, 17]
    # no still run reaches the 64 samples a pose: 1 + 48 at most
    runs = [len(list(g)) for _, g in __import__("itertools").groupby(steps)]
    assert max(runs) == 49


def test_converge_on_a_64_spp_scene_steps_on_at_each_complete_image():
    """cornell-converge traces 1024x768 at 1 spp a launch and, its scene's 64
    samples a pixel reached, moves the camera one route step and starts again."""
    cell = harness.Cell(_bench(), "cornell-converge")
    assert cell.traced_size() == (1024, 768) and cell.spp_total() == 64
    assert cell.render_settings()["render/pt/enableUpscale"] is False and not cell.traffic["map_each_frame"]
    steps = [harness.Schedule(cell.traffic, cell.spp_total(), 1).step(f) for f in range(200)]
    assert steps == [f // 64 for f in range(200)]


@pytest.mark.parametrize("cycle", [[], [{"frames": 4, "advance": "none"}], [{"frames": 0, "advance": "every"}],
                                   [{"frames": 4, "advance": "sometimes"}]])
def test_schedule_refuses_a_cycle_that_cannot_run(cycle):
    with pytest.raises(ValueError):
        harness.Schedule({"cycle": cycle}, 64, 1)


def test_orbit_route_is_the_same_for_every_seed():
    cfg = {"camera": {"eye": [2.3, 1.6, 2.1], "target": [0.9617, 1.291, 0.6462], "orbit_span_deg": 12.0,
                      "route_steps": 128}}
    target = np.asarray(cfg["camera"]["target"])
    rel0 = np.asarray(cfg["camera"]["eye"]) - target

    def angle(eye):
        rel = eye - target
        cos = np.dot(rel[[0, 2]], rel0[[0, 2]]) / np.dot(rel0[[0, 2]], rel0[[0, 2]])
        return np.degrees(np.arccos(min(cos, 1.0)))

    stops = []
    for seed in (0, 1, 2 ** 31 + 11, 77):
        poses = [inputs.orbit_pose(cfg, seed, step, 16)[0] for step in range(-1, 128)]
        assert max(angle(e) for e in poses) <= 12.0 + 1e-9
        assert all(np.linalg.norm(a - b) > 0 for a, b in zip(poses, poses[1:]))
        # a lap passes every pose of the route; the poses at multiples of the stride are one set
        stops.append(sorted(round(float(inputs.orbit_pose(cfg, seed, 16 * k, 16)[0][0]), 9) for k in range(8)))
    assert all(s == stops[0] for s in stops)
    # without a stride every seed starts at the route's start
    assert all(np.array_equal(inputs.orbit_pose(cfg, seed, 0, None)[0], inputs.orbit_pose(cfg, 0, 0, None)[0])
               for seed in (1, 2 ** 31 + 11))


def _window(frame_s, pixels):
    """What the window reads off a closed loop of frames: rate and frame-time tail."""
    return harness.sample_rate(len(frame_s) * pixels, sum(frame_s)), harness.frame_p95([f * 1e3 for f in frame_s])


def test_window_arithmetic_sees_a_stall():
    steady = [0.020] * 200
    stalled = [0.020] * 188 + [0.300] * 12  # a stall of 12 frames
    rate0, p95_0 = _window(steady, 196608)
    rate1, p95_1 = _window(stalled, 196608)
    assert rate0 == pytest.approx(196608 / 0.020 / 1e6)
    assert p95_0 == pytest.approx(20.0)
    assert rate1 < rate0 * 0.6 and p95_1 > 100.0


def test_box_overlaps_hand_worked():
    o = torch.tensor([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [0.0, 2.0, 0.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    lo = torch.tensor([[1.0, -1.0, -1.0], [3.0, -1.0, -1.0]])
    hi = torch.tensor([[2.0, 1.0, 1.0], [4.0, 1.0, 1.0]])
    tmin = torch.zeros(3)
    tfar = torch.tensor([2.5, 10.0, 10.0])
    got = bounds.box_overlaps(o, d, tmin, tfar, lo, hi)
    # ray 0 meets box 0 at [1, 2] and stops at 2.5 before box 1 at [3, 4]; ray 1 goes the other way;
    # ray 2 runs at y = 2, above both boxes
    assert got.tolist() == [[True, False], [False, False], [False, False]]


def test_triangle_bound_hand_worked():
    # two triangles in the plane x = 1 and x = 3; a ray along +x hits the first at t = 1
    v0 = torch.tensor([[1.0, -1.0, -1.0], [3.0, -1.0, -1.0]])
    e1 = torch.tensor([[0.0, 2.0, 0.0], [0.0, 2.0, 0.0]])
    e2 = torch.tensor([[0.0, 0.0, 2.0], [0.0, 0.0, 2.0]])
    mask = torch.tensor([1, 1], dtype=torch.int32)
    o = torch.tensor([[0.0, -0.5, -0.5], [0.0, -0.5, -0.5], [0.0, 5.0, 0.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    tmin = torch.zeros(3)
    tmax = torch.tensor([1e16, 0.0, 1e16])  # the second ray is dead
    t_hit = torch.tensor([1.0, 1e16, 1e16])
    got = bounds.triangle_bound_s([(o, d, tmin, tmax, t_hit, v0, e1, e2, mask, 1)], seed=0)
    # 3 rays' inputs and hits, and one needed triangle (the first; the miss at y = 5 needs none)
    want = (3 * (bounds.RAY_IN_BYTES + bounds.HIT_BYTES) + 1 * bounds.TRI_BYTES) / bounds.PEAK_BYTES_PER_S
    assert got == pytest.approx(want)


def test_cone_bound_hand_worked():
    # cone 0 on the x axis from x = 1 to 2 (radius 0.1), cone 1 from x = 5 to 6; cone 2 is padding
    geom = torch.tensor([[1.0, 0, 0, 0.1, 2.0, 0, 0, 0.1], [5.0, 0, 0, 0.1, 6.0, 0, 0, 0.1],
                         [0.0, 0, 0, -1.0, 0.0, 0, 0, -1.0]])
    o = torch.zeros((2, 3))
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    tmin = torch.zeros(2)
    tmax = torch.full((2,), 1e16)
    t_hit = torch.tensor([0.9, 1e16])  # ray 0 stops at the first cone, ray 1 passes both
    got = bounds.cone_bound_s([(o, d, tmin, tmax, t_hit, geom)], seed=0)
    ops = (1 + 2) * bounds.CONE_FLOPS / bounds.PEAK_F32_PER_S
    assert got == pytest.approx(max(ops, 2 * (bounds.CONE_RAY_IN_BYTES + bounds.CONE_HIT_BYTES)
                                    / bounds.PEAK_BYTES_PER_S))


def test_flat_bound_hand_worked():
    # 33 triangles in the plane x = 1 (ids 0-31, group 0) and one at x = 3 (id 32, group 1,
    # padded with 31 empty rows); triangle 1's mask does not match the rays'
    v0 = torch.tensor([[1.0, -1.0, -1.0]] * 32 + [[3.0, -1.0, -1.0]])
    e1 = torch.tensor([[0.0, 2.0, 0.0]] * 33)
    e2 = torch.tensor([[0.0, 0.0, 2.0]] * 33)
    mask = torch.ones(33, dtype=torch.int32)
    mask[1] = 2
    o = torch.tensor([[0.0, -0.5, -0.5], [0.0, -0.5, -0.5], [0.0, 5.0, 0.0], [2.0, 0.0, 0.0]])
    d = torch.tensor([[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.0, 0.0]])
    tmin = torch.zeros(4)
    tmax = torch.tensor([1e16, 0.0, 1e16, 1e16])  # the second ray is dead
    t_hit = torch.tensor([1.0, 1e16, 1e16, 1.0])  # ray 3 starts between the planes and hits x = 3
    lo, hi, kept = bounds.group_boxes(v0, e1, e2, (mask & 1) != 0)
    assert kept.tolist() == [31, 1] and lo[1].tolist() == [3.0, -1.0, -1.0] and hi[1].tolist() == [3.0, 1.0, 1.0]
    got = bounds.flat_bound_s([(o, d, tmin, tmax, t_hit, v0, e1, e2, mask, 1)], seed=0)
    # live rays 0, 2, 3: ray 0 meets group 0 (31 matching), ray 3 group 1 (1), ray 2 none
    ops = (2 * bounds.GROUP_BOX_FLOPS + 32 * bounds.MT_FLOPS) / bounds.PEAK_F32_PER_S
    rays = 4 * (bounds.RAY_IN_BYTES + bounds.HIT_BYTES) / bounds.PEAK_BYTES_PER_S
    assert got == pytest.approx(max(ops, rays))


def test_busy_and_gaps():
    spans = [(0.0, 10.0), (5.0, 20.0), (30.0, 40.0)]
    assert tracing.device_busy(spans) == (30.0, 40.0)
    gaps = tracing.idle_gaps(spans, [("map", 21.0, 29.0)])
    assert gaps == [("map", 10.0 / 1e6)]
    assert tracing.kernel_family("void bvh_closest_kernel<0>(...)") == "bvh_closest"
    assert not tracing.is_kernel("Memcpy DtoH (Device -> Pageable)")


def test_reduce_events_keeps_host_ranges_off_the_device():
    """A host range's annotation on the device's timeline is no device work; its
    host side names the gaps, and a CPU range gives the device time it launched."""
    import types

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, dev, a, b, device_us=0.0):
        return types.SimpleNamespace(name=name, device_type=dev, time_range=types.SimpleNamespace(start=a, end=b),
                                     device_time_total=device_us)

    events = [ev("bench.frame", cpu, 0, 100), ev("bench.frame", cuda, 0, 100),
              ev("void bvh_closest_kernel<false>(StrelkaRays)", cuda, 10, 20), ev("texture_path", cpu, 30, 40, 5.0),
              ev("texture_path", cuda, 30, 40), ev("Memcpy DtoH (Device -> Pageable)", cuda, 50, 60)]
    got = tracing.reduce_events(events, 1, ("texture_path",))
    assert (got["busy_s"], got["window_s"], got["kernels_per_launch"]) == (20e-6, 50e-6, 1.0)
    assert got["family_ms_per_launch"] == {"bvh_closest": 0.01} and got["range_ms_per_launch"] == {"texture_path": 0.005}
    assert got["idle_gaps"] == [("frame", 30e-6)]


def test_upscale_taps_match_the_display_resize():
    """The reference's resize of sampled pixels equals render.resize_bilinear's at the viewport's 2x."""
    from strelka_tpu_torch.render.render import resize_bilinear

    gen = torch.Generator().manual_seed(3)
    img = torch.rand((24, 32, 4), generator=gen)
    want = resize_bilinear(img, 48, 64)
    oy, ox = np.meshgrid(np.arange(48), np.arange(64), indexing="ij")
    ox, oy = ox.ravel(), oy.ravel()
    tx, ty, index, weights = reference.upscale_plan(ox, oy, 64, 48, 32, 24)
    traced = img[torch.as_tensor(ty), torch.as_tensor(tx), :3].T
    got = reference.apply_upscale(traced, index, weights)
    torch.testing.assert_close(got.T, want[oy, ox, :3], rtol=0, atol=1e-6)


def test_compare_and_judge():
    ref = np.full((4, 3), 0.5)
    prog = ref.copy()
    prog[0, 1] += 2e-5
    prog[1, 0] += 5e-6
    numbers = harness.compare(prog, ref, 12, 12)
    assert numbers["max_gap"] == pytest.approx(2e-5) and numbers["samples_off"] == 0.0
    prog[2, 2] = np.nan  # a value that is not finite gaps the most
    numbers = harness.compare(prog, ref, 11, 12)
    assert numbers == {"max_gap": harness.NONFINITE_GAP, "samples_off": 1.0}
    limits = {"compare": {"max_gap": 1e-3, "samples_off": 0}}
    assert harness.judge(numbers, limits) == {"max_gap": {"value": harness.NONFINITE_GAP, "limit": 1e-3},
                                              "samples_off": {"value": 1.0, "limit": 0.0}}


def test_split_metric_reads_its_base_reader(tmp_path):
    (tmp_path / "base_ms.py").write_text("def read(run):\n    return run['x']\n")
    (tmp_path / "own.viewport.py").write_text("def read(run):\n    return -1\n")
    assert harness.load_reader(str(tmp_path), "base_ms.viewport")({"x": 3}) == 3
    assert harness.load_reader(str(tmp_path), "base_ms")({"x": 4}) == 4
    assert harness.load_reader(str(tmp_path), "own.viewport")({}) == -1


def test_benchmark_json_keeps_the_contract():
    bench = _bench()
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and bench["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])
    layers = {}
    reports = {w["name"]: {e["name"] for e in bench["end_to_end"] if w["name"] in e.get("workloads", [w["name"]])}
               for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
        # every cell that reports the metric reports the end-to-end metric it moves
        assert all(m["moves"] in reports[w] for w in m["workloads"]), m["name"]
        if "roofline" in m["name"]:  # a kernel's share of its roofline: <kernel>_roofline
            assert re.match(r"^[a-z0-9_]+_roofline(\.[a-z]+)?$", m["name"]) and m["unit"] == "%"
        layers.setdefault(m["layer"], 0)
    for w, names in reports.items():
        assert "setup_s" in names and len(names) >= 2, w
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(bench)) < 64 * 1024
