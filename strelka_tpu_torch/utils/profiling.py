"""Tracing/profiling: frame counters and a device trace.

The reference measures wall-clock frame time for the window title
(app/main.cpp:368-404) and uses TfStopwatch/HD_TRACE in the Hydra path.
FrameStats keeps the same ms/spp counters plus rolling averages and a rays/s
estimate (a copy of the JAX package's, strelka_tpu/utils/profiling.py).
device_trace() wraps torch.profiler around a block and exports a Chrome
trace; summarize_trace() sums the device kernels of the newest trace by name.
"""

from __future__ import annotations

import contextlib
from collections import deque


class FrameStats:
    """Per-frame timing + throughput counters (title-bar parity)."""

    def __init__(self, window: int = 32):
        self._times = deque(maxlen=window)
        self.frame_count = 0

    def add_frame(self, seconds: float, rays: int = 0) -> None:
        self._times.append((seconds, rays))
        self.frame_count += 1

    @property
    def ms(self) -> float:
        return self._times[-1][0] * 1e3 if self._times else 0.0

    @property
    def avg_ms(self) -> float:
        if not self._times:
            return 0.0
        return sum(t for t, _ in self._times) / len(self._times) * 1e3

    @property
    def mrays_per_sec(self) -> float:
        if not self._times:
            return 0.0
        t = sum(t for t, _ in self._times)
        r = sum(r for _, r in self._times)
        return r / t / 1e6 if t > 0 else 0.0

    def title(self, name: str = "Strelka", spp: int = 0) -> str:
        """app/main.cpp:399-403 window-title format + throughput."""
        extra = f" [{self.mrays_per_sec:.1f} Mray/s]" if self.mrays_per_sec else ""
        return f"{name} [{self.ms:.1f} ms] [{spp} spp]{extra}"


TRACE_NAME = "trace.json"


@contextlib.contextmanager
def device_trace(trace_dir: str):
    """Trace a block with torch.profiler (CPU, and CUDA where a card is
    present) and export it as a Chrome trace, <trace_dir>/<n>/trace.json,
    n one more than the newest run there."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    runs = [int(d) for d in os.listdir(trace_dir) if d.isdigit()] if os.path.isdir(trace_dir) else []
    out = os.path.join(trace_dir, str(max(runs, default=0) + 1))
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(out, TRACE_NAME))


def kernel_name(name: str) -> str:
    """A traced kernel's function name without its return type, template
    arguments and parameters: "void ns::k<4, F>(int, F)" -> "ns::k"."""
    name = name.replace("(anonymous namespace)", "{anonymous}")
    if name.startswith("void "):
        name = name[len("void "):]
    for stop in "<(":
        name = name.split(stop, 1)[0]
    return name.replace("{anonymous}", "(anonymous namespace)")


def summarize_trace(trace_dir: str, top: int = 20, category: str = "kernel"):
    """Device kernel time by name from the newest trace under trace_dir:
    [(name, total_ms)], largest first; the instances of a template share
    their function's name (kernel_name), as the JAX version sums the
    variants of an op. Only complete events of `category` count: "kernel"
    is the card's kernels (a trace taken on the CPU has none), "cpu_op" the
    host's operators."""
    import collections
    import glob
    import json
    import os

    files = glob.glob(os.path.join(trace_dir, "**", TRACE_NAME), recursive=True)
    if not files:
        return []
    with open(max(files, key=os.path.getmtime)) as f:
        data = json.load(f)
    per = collections.Counter()
    for e in data.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") == category and "dur" in e:
            per[kernel_name(e.get("name", "?"))] += e["dur"]
    return [(name, dur / 1e3) for name, dur in per.most_common(top)]
