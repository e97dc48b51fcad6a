"""The port's utils/profiling.py.

(a) FrameStats gives the same ms, avg_ms, mrays_per_sec and title as the JAX
    package's on the same frame times and ray counts (its rolling window
    included);
(b) summarize_trace sums the complete events of one category by function
    name (a template's instances together) from the newest trace under a
    directory: "kernel" (the card's kernels), not the host's "cpu_op" events;
(c) device_trace writes one numbered run directory a trace, each holding a
    Chrome trace that summarize_trace reads.
"""

import json
import os
import time

import pytest
import torch

from strelka_tpu.utils.profiling import FrameStats as JaxFrameStats
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
