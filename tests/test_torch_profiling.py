"""The port's utils/profiling.py.

(a) FrameStats gives the same ms, avg_ms, mrays_per_sec and title as the JAX
    package's on the same frame times and ray counts (its rolling window
    included);
(b) summarize_trace sums the complete events of one category by function
    name (a template's instances together) from the newest trace under a
    directory: "kernel" (the card's kernels), not the host's "cpu_op" events;
(c) device_trace writes one numbered run directory a trace, each holding a
    Chrome trace that summarize_trace reads;
(d) the span-and-counter recorder on CPU launches: off it records no
    per-frame span or counter, on and off give bit-equal images and states,
    its spans nest (a span's self time is its duration less its children's),
    a host span lines up with a torch.profiler range on the profiler's
    clock, the lane counters equal the lanes each sweep was handed, and the
    idle gaps take the innermost span's name. The card's side is
    test_torch_profiling_card.py.
"""

import json
import os
import time
import types

import numpy as np
import pytest
import torch

from strelka_tpu.utils.profiling import FrameStats as JaxFrameStats
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
from strelka_tpu_torch.render.render import TorchRender
from strelka_tpu_torch.scene import testscenes as TTS
from strelka_tpu_torch.settings import SharedContext, make_default_settings
from strelka_tpu_torch.utils import profiling as P
from strelka_tpu_torch.utils.profiling import TRACE_NAME, FrameStats, device_trace, summarize_trace

FRAMES = [(0.0125, 1_000_000), (0.031, 2_500_000), (0.0002, 0), (1.5, 123_456_789)]


@pytest.mark.parametrize("window", [2, 32])
def test_frame_stats_match_jax(window):
    a, b = JaxFrameStats(window), FrameStats(window)
    assert b.title(spp=0) == a.title(spp=0) and b.ms == a.ms == 0.0
    for i, (seconds, rays) in enumerate(FRAMES):
        a.add_frame(seconds, rays)
        b.add_frame(seconds, rays)
        assert (b.ms, b.avg_ms, b.mrays_per_sec, b.frame_count) == (a.ms, a.avg_ms, a.mrays_per_sec, a.frame_count)
        assert b.title(spp=4 * i) == a.title(spp=4 * i)
        assert b.title("Viewer", spp=i) == a.title("Viewer", spp=i)


def _trace(path, events):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, TRACE_NAME), "w") as f:
        json.dump({"traceEvents": events}, f)


def test_summarize_trace_counts_kernels_only(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "name": "tri_warp_kernel", "dur": 1500.0},
        {"ph": "X", "cat": "kernel", "name": "void sobol_kernel<31>(long long const*, float*)", "dur": 150.0},
        {"ph": "X", "cat": "kernel", "name": "void sobol_kernel<3>(long long const*, float*)", "dur": 50.0},
        {"ph": "X", "cat": "kernel", "name": "tri_warp_kernel(StrelkaRays, int)", "dur": 500.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 9000.0},
        {"ph": "i", "cat": "kernel", "name": "instant", "dur": 1.0},
    ]
    _trace(tmp_path / "1", [{"ph": "X", "cat": "kernel", "name": "old", "dur": 1.0}])
    time.sleep(0.01)
    _trace(tmp_path / "2", events)
    assert summarize_trace(str(tmp_path)) == [("tri_warp_kernel", 2.0), ("sobol_kernel", 0.2)]
    assert summarize_trace(str(tmp_path), top=1) == [("tri_warp_kernel", 2.0)]
    assert summarize_trace(str(tmp_path), category="cpu_op") == [("aten::add", 9.0)]
    assert summarize_trace(str(tmp_path / "none")) == []


def test_kernel_name():
    from strelka_tpu_torch.utils.profiling import kernel_name

    assert kernel_name("void at::native::vectorized_elementwise_kernel<4, F, std::array<char*, 3ul> >(int, F)") == \
        "at::native::vectorized_elementwise_kernel"
    assert kernel_name("void at::native::(anonymous namespace)::where_kernel<bool>(int)") == \
        "at::native::(anonymous namespace)::where_kernel"
    assert kernel_name("tri_thread_kernel(StrelkaRays, StrelkaTris)") == "tri_thread_kernel"
    assert kernel_name("aten::mul") == "aten::mul"


def test_device_trace_writes_a_run_a_trace(tmp_path):
    x = torch.ones(64)
    for _ in range(2):
        with device_trace(str(tmp_path)):
            torch.mul(x, 2.0).sum()
    assert sorted(os.listdir(tmp_path)) == ["1", "2"]
    assert all(os.path.exists(tmp_path / run / TRACE_NAME) for run in ("1", "2"))
    ops = dict(summarize_trace(str(tmp_path), category="cpu_op"))
    assert "aten::mul" in ops and "aten::sum" in ops


@pytest.fixture
def recorder():
    """The recorder emptied and off, one torch thread (torch 2.13's CPU
    first-call fault), and both as they were afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    P.disable()
    P.reset()
    yield P
    P.disable()
    P.reset()
    torch.set_num_threads(threads)


def _frames(on: bool, frames: int = 2, size: int = 16):
    """Cornell at size x size, 1 spp a frame, depth 4, through TorchRender on
    the CPU: each frame's image, what collect() read after it (with the
    recorder on), and the final state."""
    if on:
        P.enable()
    s = make_default_settings(size, size)
    s.set("render/pt/spp", 1)
    s.set("render/pt/depth", 4)
    r = TorchRender(device="cpu")
    r.set_scene(TTS.cornell_box())
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(size, size, BufferFormat.FLOAT4))
    images, reads = [], []
    for _ in range(frames):
        r.render(buf)
        images.append(buf.map().copy())
        reads.append(P.collect())
    P.disable()
    return images, reads, r._state


def test_recorder_off_records_no_frame_span_or_counter(recorder):
    images, reads, _ = _frames(False)
    assert all(not r["host"] and not r["device"] and not r["lanes"] and r["frames"] == 0 for r in reads)
    assert [s["name"] for s in P.setup_spans()] == ["tables.upload", "device_scene.build"]  # set-up, always
    assert P.export()["device_ms"] == {} and P.export()["host_ms"] == {} and P.export()["sweep_lane_use"] is None


def test_launch_bit_equal_with_recorder_on_and_off(recorder):
    off_images, _, off_state = _frames(False)
    on_images, reads, on_state = _frames(True)
    assert all(np.array_equal(a, b) for a, b in zip(off_images, on_images))
    assert all(torch.equal(a, b) for a, b in zip(off_state, on_state))
    assert all(r["device"] and r["lanes"] and r["frames"] == 1 for r in reads)


def test_spans_nest_and_self_time_is_duration_less_children(recorder):
    _, reads, _ = _frames(True, frames=1)
    host, device = reads[0]["host"], reads[0]["device"]
    by_id = {s["id"]: s for s in host}
    assert {s["name"] for s in host} == {"render", "render.prepare", "buffer.map"}
    for s in host:  # a child lies inside its parent, on the same frame
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] <= s["end_ns"] <= p["end_ns"] and p["frame"] == s["frame"]
    assert by_id[next(s["parent"] for s in host if s["name"] == "render.prepare")]["name"] == "render"
    parents = {d["name"]: device[d["parent"]]["name"] for d in device if d["parent"] is not None}
    assert parents == {"bounce.shadow": "bounce.nee"}  # Cornell has no texture
    top = [d["name"] for d in device if d["parent"] is None]
    assert top[0] == "launch.camera" and top[-2:] == ["launch.accumulate", "launch.post"]
    assert top[1:-2] == ["bounce.sample", "bounce.closest", "bounce.surface", "bounce.bsdf", "bounce.nee",
                         "bounce.next"] * 4
    for a, b in zip(device, device[1:]):  # the top-level phases tile the launch
        if a["parent"] is None and b["parent"] is None:
            assert a["end_ms"] == pytest.approx(b["start_ms"], abs=1e-9)
    nee = [i for i, d in enumerate(device) if d["name"] == "bounce.nee"]
    own = P.self_ms(device, "start_ms", "end_ms")
    for i in nee:
        child = next(d for d in device if d["parent"] == i)
        assert own[i] == pytest.approx(device[i]["ms"] - child["ms"], abs=1e-9)
    # a hand-worked case: children overlapping each other and the parent's edge
    spans = [{"id": 1, "parent": None, "a": 0, "b": 10}, {"id": 2, "parent": 1, "a": 2, "b": 5},
             {"id": 3, "parent": 1, "a": 4, "b": 6}, {"id": 4, "parent": 1, "a": 9, "b": 12},
             {"id": 5, "parent": 2, "a": 3, "b": 4}]
    assert P.self_ms(spans, "a", "b") == [10 - 4 - 1, 3 - 1, 2, 3, 1]


def test_host_span_contains_profiler_range(recorder):
    from torch.profiler import ProfilerActivity, profile, record_function

    P.enable()
    x = torch.ones(256)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm"):  # the profiler's first range pays its set-up
            x.sum()
        with P.span("outer"):
            with record_function("inner"):
                torch.mul(x, 2.0).sum()
                time.sleep(0.002)
    outer = P.collect()["host"][0]
    t0 = prof.profiler.kineto_results.trace_start_ns()
    inner = next(e for e in prof.events() if e.name == "inner")
    start, end = t0 + inner.time_range.start * 1e3, t0 + inner.time_range.end * 1e3
    assert outer["name"] == "outer" and outer["start_ns"] <= start + 50e3 and end <= outer["end_ns"] + 50e3
    assert "outer" in {e.name for e in prof.events()}  # under an active profiler a span is also a range


def test_lane_counters_equal_alive_sums(recorder, monkeypatch):
    """The lanes alive at each closest sweep and the shadow rays cast, as
    the sweeps were handed them (their `active` masks), bounce by bounce."""
    handed = {"closest": [], "any": []}
    closest, any_hit = TI.intersect_closest, TI.intersect_any

    def count_closest(*a, active, **k):
        handed["closest"].append(int(active.sum()))
        return closest(*a, active=active, **k)

    def count_any(*a, active, **k):
        handed["any"].append(int(active.sum()))
        return any_hit(*a, active=active, **k)

    monkeypatch.setattr(TI, "intersect_closest", count_closest)
    monkeypatch.setattr(TI, "intersect_any", count_any)
    host = TTS.cornell_box()
    from strelka_tpu_torch.render.device_scene import build_device_scene

    scene = build_device_scene(host, device="cpu")
    cam = host.get_camera(0)
    cam.update_aspect_ratio(1.0)
    params = TI.LaunchParams(3, np.asarray(cam.clip_to_view(), np.float32), np.asarray(cam.view_to_world(), np.float32),
                             np.full(3, 6.25e-4, np.float32), np.zeros(3, np.float32))
    kw = dict(width=16, height=16, samples_per_launch=2, max_sample_count=1024, max_depth=5,
              enable_accumulation=True)
    P.enable()
    TI.render_launch(scene, params, TI.make_frame_state(16, 16, "cpu"), **kw)
    lanes = P.collect()["lanes"]
    assert lanes["alive"] == handed["closest"] and lanes["shadow"] == handed["any"]
    assert lanes["swept"] == [2 * 16 * 16] * 5 and lanes["alive"][0] == 512 > lanes["alive"][-1] > 0
    P.disable()
    handed["closest"].clear()
    TI.render_launch(scene, params, TI.make_frame_state(16, 16, "cpu"), **kw)
    assert len(handed["closest"]) == 5 and P.collect()["lanes"] == {}  # off: the sweeps run, nothing is counted
    assert P.export()["sweep_lane_use"] == pytest.approx(100.0 * sum(lanes["alive"]) / (5 * 512))


def test_idle_gaps_named_by_innermost_span():
    """Gaps between the card's events of a profile (a stand-in with the
    profiler's fields) take the name of the innermost span that holds their
    midpoint, on the profiler's clock; "host" where none does."""
    cuda = torch.autograd.DeviceType.CUDA
    t0 = 1_000_000_000

    def ev(a_us, b_us, device=cuda):
        return types.SimpleNamespace(device_type=device, time_range=types.SimpleNamespace(start=a_us, end=b_us))

    prof = types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(trace_start_ns=lambda: t0)),
        events=lambda: [ev(0, 10), ev(20, 30), ev(25, 40), ev(100, 110), ev(50, 60, torch.autograd.DeviceType.CPU),
                        ev(300, 301)])
    ns = lambda us: t0 + us * 1000  # noqa: E731
    spans = [{"id": 7, "parent": None, "name": "render", "start_ns": ns(5), "end_ns": ns(150)},
             {"id": 8, "parent": 7, "name": "render.prepare", "start_ns": ns(12), "end_ns": ns(18)}]
    assert P.idle_gaps(prof, spans) == [("host", 190e-6), ("render", 60e-6), ("render.prepare", 10e-6)]
