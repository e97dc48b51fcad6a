"""Tracing/profiling: frame counters, a device trace, and the program's
span-and-counter recorder.

The reference measures wall-clock frame time for the window title
(app/main.cpp:368-404) and uses TfStopwatch/HD_TRACE in the Hydra path.
FrameStats keeps the same ms/spp counters plus rolling averages and a rays/s
estimate (a copy of the JAX package's, strelka_tpu/utils/profiling.py).
device_trace() wraps torch.profiler around a block and exports a Chrome
trace; summarize_trace() sums the device kernels of the newest trace by name.

The recorder (below FrameStats) is off by default; enable() / disable()
switch it. While it is on:
  * host spans: render() and its phases (render.prepare with launch.upload,
    launch.replay, frame.copy, frame.resize, render.validate) and
    buffer.map, stamped in Unix-epoch nanoseconds, the clock of a
    torch.profiler trace (its trace_start_ns plus the events' offsets); under
    an active profiler each is also a profiler range;
  * device spans: the launch's phases (launch.camera, per bounce
    bounce.order, bounce.sample, bounce.closest, bounce.surface with
    bounce.texture, bounce.bsdf, bounce.nee with bounce.shadow, bounce.next,
    then launch.unorder, launch.accumulate, launch.post) between timing
    CUDA events recorded in the launch. A CUDA graph captured while the
    recorder is on holds those events as nodes, so every replay records them
    again (render/render.py:GraphLaunch captures again when the recorder's
    state changes; a graph captured with it off has no such node). The
    image's copy and resize outside the graph are device spans frame.copy
    and frame.resize. On the CPU a device span is stamped on the host clock;
  * lane counters: each bounce adds, on the device, the lanes alive at the
    closest sweep, the shadow rays cast, the lanes swept, and the lanes
    whose closest hit is a curve and a triangle. On a scene with curves the
    two sweeps of bounce.closest and of bounce.shadow are child spans each
    (closest.triangles, closest.curves, shadow.triangles, shadow.curves).
Always, whatever the state: the set-up spans (scene.load with usd.curves a
BasisCurves prim, device_scene.build with bvh.build, cones.build and
tables.upload, kernels.load, launch.eager, launch.capture) and the one-shot
counters (graph.captures and graph.nodes per config key, kernels.built per
source, kernels.loaded; scene.triangles, scene.curve_segments, scene.cones
and cones.tree_levels set at device_scene.build), a handful a run.

Everything stays in memory. collect() reads the spans recorded since the
last call, the last frame's device spans (once its work has completed: a
replay overwrites the events of the one before, so call it after each frame
whose device spans are wanted) and the lane counters; export() gives the
per-frame means over the collected frames, the counters and the set-up spans.
Off, a per-frame span site costs an attribute test and allocates nothing.
"""

from __future__ import annotations

import contextlib
import time
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
SPANS_NAME = "spans.json"  # the recorder's export() beside a trace (the CLI's --profile)


@contextlib.contextmanager
def device_trace(trace_dir: str):
    """Trace a block with torch.profiler (CPU, and CUDA where a card is
    present) and export it as a Chrome trace, <trace_dir>/<n>/trace.json,
    n one more than the newest run there; yields that run's directory."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    runs = [int(d) for d in os.listdir(trace_dir) if d.isdigit()] if os.path.isdir(trace_dir) else []
    out = os.path.join(trace_dir, str(max(runs, default=0) + 1))
    os.makedirs(out, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=activities) as prof:
        yield out
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


# ---------------------------------------------------------------------------
# The recorder
# ---------------------------------------------------------------------------

MAX_SPANS = 1 << 16  # per-frame host spans kept between two collect() calls
MAX_SETUP = 1024  # set-up spans kept (a rebuilt scene adds a few)
MAX_FRAMES = 4096  # collected frames export() averages over
LANE_ROWS = 64  # bounces a lane counter holds (a deeper bounce adds into the last row)
LANES = ("alive", "shadow", "swept", "curve_hits", "triangle_hits")  # the lane counter's columns
TOP = 10  # named idle gaps kept a collect


class _Null:
    """The context a span site gets while the recorder is off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()  # the context of a span that is not recorded, and of a span site where none applies


class _Recorder:
    def __init__(self) -> None:
        self.on = False
        self.lane_counters: dict = {}  # device -> [LANE_ROWS, len(LANES)] int64, static (a graph adds into it)
        self.reset()

    def reset(self) -> None:
        self.frame = 0  # frames opened while on
        self.frames_collected = 0  # self.frame at the last collect()
        self.next_id = 0
        self.stack: list = []  # open host spans, innermost last
        self.spans: deque = deque(maxlen=MAX_SPANS)
        self.setup: deque = deque(maxlen=MAX_SETUP)
        self.counters: dict = {}
        self.launch = None  # the open launch record
        self.pending: list = []  # the last frame's launch records
        self.collected: deque = deque(maxlen=MAX_FRAMES)
        for counter in self.lane_counters.values():
            counter.zero_()


_REC = _Recorder()


def enable() -> None:
    """Switch the recorder on (graphs captured off are captured again)."""
    _REC.on = True


def disable() -> None:
    """Switch the recorder off; what it recorded stays until reset()."""
    _REC.on = False


def is_on() -> bool:
    return _REC.on


def reset() -> None:
    """Drop everything recorded: spans, counters, collected frames."""
    _REC.reset()


def _profiler_active() -> bool:
    import torch

    return torch._C._autograd._profiler_enabled()


class _HostSpan:
    __slots__ = ("name", "setup", "phase", "id", "parent", "start", "range")

    def __init__(self, name: str, setup: bool = False, phase: bool = False) -> None:
        self.name, self.setup, self.phase = name, setup, phase

    def __enter__(self):
        rec = _REC
        self.id = rec.next_id
        rec.next_id += 1
        self.parent = rec.stack[-1].id if rec.stack else None
        rec.stack.append(self)
        self.range = None
        if rec.on and _profiler_active():
            from torch.autograd.profiler import record_function

            self.range = record_function(self.name)
            self.range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        rec = _REC
        while rec.stack and rec.stack[-1] is not self:  # an open phase ends with its span
            rec.stack[-1].__exit__(None, None, None)
        end = time.time_ns()
        if rec.stack:
            rec.stack.pop()
        if self.range is not None:
            self.range.__exit__(None, None, None)
        row = {"id": self.id, "name": self.name, "parent": self.parent, "frame": rec.frame,
               "start_ns": self.start, "end_ns": end}
        (rec.setup if self.setup else rec.spans).append(row)
        return False


def span(name: str):
    """A host span around a `with` block, recorded while the recorder is on."""
    if not _REC.on:
        return NULL
    return _HostSpan(name)


def setup_span(name: str):
    """A one-shot set-up span, recorded whatever the recorder's state."""
    return _HostSpan(name, setup=True)


def frame_span():
    """render()'s span: a new frame (its device spans replace the last frame's)."""
    rec = _REC
    if not rec.on:
        return NULL
    rec.frame += 1
    rec.pending = []
    return _HostSpan("render")


def phase(name) -> None:
    """End the open phase of the innermost span and start `name` in its
    place (None: start none). A span's last phase ends with the span."""
    rec = _REC
    if not rec.on:
        return
    if rec.stack and rec.stack[-1].phase:
        rec.stack[-1].__exit__(None, None, None)
    if name is not None:
        _HostSpan(name, phase=True).__enter__()


# ---- device spans


class _LaunchRecord:
    """The device spans of one launch: [name, parent, bounce, start mark,
    end mark] rows; a mark is a timing CUDA event (on the CPU, host ns)."""

    __slots__ = ("device", "rows", "open_phase", "stack")

    def __init__(self, device) -> None:
        self.device = device
        self.rows: list = []
        self.open_phase = None  # row index of the open top-level phase
        self.stack: list = []  # row indices of the open child spans

    def mark(self):
        if self.device.type != "cuda":
            return time.time_ns()
        import torch

        event = torch.cuda.Event(enable_timing=True, external=True)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def open(self, name: str, bounce: int, top: bool, mark=None) -> int:
        parent = self.stack[-1] if self.stack else (None if top else self.open_phase)
        self.rows.append([name, parent, bounce, self.mark() if mark is None else mark, None])
        return len(self.rows) - 1

    def close(self, index: int, mark=None):
        mark = self.mark() if mark is None else mark
        self.rows[index][4] = mark
        return mark

    def end(self) -> None:
        if self.open_phase is not None:
            self.close(self.open_phase)
            self.open_phase = None


def _capturing(device) -> bool:
    import torch

    return device.type == "cuda" and torch.cuda.is_current_stream_capturing()


@contextlib.contextmanager
def _launch_record(device):
    rec = _REC
    outer = rec.launch is None
    if outer:
        rec.launch = _LaunchRecord(device)
    record = rec.launch
    try:
        yield record
    finally:
        if outer:
            rec.launch = None
            record.end()
            if not _capturing(device):  # a captured record is registered at each replay (replayed)
                rec.pending.append(record)


def launch_record(device):
    """The device spans of a launch on `device` (nested calls join the
    outermost one); yields the record, which a graph's capture keeps for
    replayed(). Off: yields None."""
    if not _REC.on:
        return NULL
    import torch

    return _launch_record(torch.device(device))


def replayed(record) -> None:
    """A replay of a graph whose capture recorded `record`: its events are
    this frame's device spans."""
    if _REC.on and record is not None:
        _REC.pending.append(record)


def device_phase(name, bounce: int = -1) -> None:
    """End the launch's open top-level device phase and start `name` at the
    same mark (None: start none). Outside a launch record, nothing."""
    rec = _REC
    if not rec.on or rec.launch is None:
        return
    record = rec.launch
    mark = record.close(record.open_phase) if record.open_phase is not None else None
    record.open_phase = None
    if name is not None:
        record.open_phase = record.open(name, bounce, True, mark)


@contextlib.contextmanager
def _device_span(name: str, device):
    rec = _REC
    if rec.launch is None:  # a span of its own outside any launch (the frame's copy, its resize)
        with _launch_record(device) as record:
            record.open_phase = record.open(name, -1, True)
            yield
        return
    record = rec.launch
    index = record.open(name, record.rows[record.open_phase][2] if record.open_phase is not None else -1, False)
    record.stack.append(index)
    try:
        yield
    finally:
        record.stack.pop()
        record.close(index)


def device_span(name: str, device=None):
    """A device span around a `with` block: a child of the launch's open
    phase, or outside a launch a top-level span of its own on `device`
    (given no device there, nothing)."""
    rec = _REC
    if not rec.on or (rec.launch is None and device is None):
        return NULL
    import torch

    return _device_span(name, torch.device(device) if device is not None else None)


def _read_record(record, ref):
    """The rows of a launch record as (name, parent, bounce, start ms, ms)
    from the reference mark `ref` (which a CUDA record's events follow)."""
    out = []
    for name, parent, bounce, start, end in record.rows:
        if record.device.type == "cuda":
            t0, ms = ref.elapsed_time(start), start.elapsed_time(end)
        else:
            t0, ms = (start - ref) / 1e6, (end - start) / 1e6
        out.append((name, parent, bounce, t0, ms))
    return out


def _read_pending(records) -> list:
    """The last frame's device spans, one list over its launch records:
    dicts of name, parent (an index into the list), bounce, start_ms and
    end_ms (from the frame's first mark on that device), ms and device.
    Waits for the work."""
    import torch

    refs, rows = {}, []
    for record in records:
        if not record.rows:
            continue
        key = str(record.device)
        if record.device.type == "cuda" and key not in refs:
            torch.cuda.synchronize(record.device)
        refs.setdefault(key, record.rows[0][3])
        base = len(rows)
        for name, parent, bounce, t0, ms in _read_record(record, refs[key]):
            rows.append({"name": name, "parent": None if parent is None else base + parent, "bounce": bounce,
                         "start_ms": t0, "end_ms": t0 + ms, "ms": ms, "device": key})
    return rows


# ---- counters


def lane_counts(max_depth: int, device):
    """A launch's lane counter ([max_depth, 5] int64 zeros, LANES: alive at
    the closest sweep, shadow rays cast, lanes swept, closest hits on a curve,
    on a triangle) while the recorder is on, else None."""
    if not _REC.on:
        return None
    import torch

    return torch.zeros((max_depth, len(LANES)), dtype=torch.int64, device=device)


def add_lanes(lanes) -> None:
    """Add a launch's lane counts into the device's static counter (a graph
    captured with the recorder on adds them at every replay)."""
    if lanes is None:
        return
    import torch

    key = str(lanes.device)
    counter = _REC.lane_counters.get(key)
    if counter is None:
        if _capturing(lanes.device):
            raise RuntimeError("profiling: a lane counter is made by the eager launch before a capture")
        counter = torch.zeros((LANE_ROWS, len(LANES)), dtype=torch.int64, device=lanes.device)
        _REC.lane_counters[key] = counter
    rows = min(lanes.shape[0], LANE_ROWS)
    counter[:rows].add_(lanes[:rows])
    if lanes.shape[0] > LANE_ROWS:
        counter[-1].add_(lanes[LANE_ROWS:].sum(0))


def count(name: str, label: str = "", n: int = 1) -> None:
    """Add n to a one-shot counter (recorded whatever the state)."""
    per = _REC.counters.setdefault(name, {})
    per[label] = per.get(label, 0) + n


def set_count(name: str, label: str, value: int) -> None:
    _REC.counters.setdefault(name, {})[label] = int(value)


def counters() -> dict:
    return {name: dict(per) for name, per in _REC.counters.items()}


def setup_spans() -> list:
    """The set-up spans recorded so far (each a dict of id, name, parent,
    frame, start_ns, end_ns), oldest first."""
    return list(_REC.setup)


def graph_nodes(graph) -> int:
    """The node count of a captured torch.cuda.CUDAGraph made with
    keep_graph=True (cuGraphGetNodes on its cudaGraph_t)."""
    import ctypes

    n = ctypes.c_size_t(0)
    rc = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                                                     ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed: CUresult {rc}")
    return n.value


# ---- reading


def self_ms(spans: list, start: str, end: str) -> list:
    """Each span's self time: its duration less the part of its interval
    that its children's intervals cover (their union).
    spans: dicts with "parent" and "id" (else a span's id is its index in
    the list); `start` and `end` name their interval's keys."""
    children: dict = {}
    ids = [s.get("id", i) for i, s in enumerate(spans)]
    for s in spans:
        if s["parent"] is not None:
            children.setdefault(s["parent"], []).append(s)
    out = []
    for ident, s in zip(ids, spans):
        a, b = s[start], s[end]
        covered, cur = 0.0, None
        for c in sorted(children.get(ident, []), key=lambda c: c[start]):
            lo, hi = max(c[start], a), min(c[end], b)
            if hi <= lo:
                continue
            if cur is None or lo > cur[1]:
                if cur is not None:
                    covered += cur[1] - cur[0]
                cur = [lo, hi]
            else:
                cur[1] = max(cur[1], hi)
        if cur is not None:
            covered += cur[1] - cur[0]
        out.append((b - a) - covered)
    return out


def idle_gaps(prof, spans: list, top: int = TOP) -> list:
    """The gaps between the card's events of a torch.profiler profile,
    longest first, each named by the innermost program host span (of
    `spans`, on the profiler's clock) that holds its midpoint, "host" where
    none does: [(name, seconds)]."""
    import torch

    t0 = prof.profiler.kineto_results.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    events = sorted((t0 + e.time_range.start * 1e3, t0 + e.time_range.end * 1e3) for e in prof.events()
                    if e.device_type == cuda)
    by_id = {s["id"]: s for s in spans}

    def depth(s) -> int:  # ancestors among `spans`
        d, p = 0, s["parent"]
        while p in by_id:
            d, p = d + 1, by_id[p]["parent"]
        return d

    gaps, end = [], None
    for a, b in events:
        if end is not None and a > end:
            mid = (a + end) / 2
            holding = [s for s in spans if s["start_ns"] <= mid <= s["end_ns"]]
            name = max(holding, key=depth)["name"] if holding else "host"
            gaps.append((name, (a - end) / 1e9))
        end = b if end is None else max(end, b)
    gaps.sort(key=lambda g: -g[1])
    return gaps[:top]


def _read_lanes() -> dict:
    total = None
    for counter in _REC.lane_counters.values():
        values = counter.cpu().tolist()
        counter.zero_()
        total = values if total is None else [[x + y for x, y in zip(r, q)] for r, q in zip(total, values)]
    rows = [r for r in total or [] if r[2] > 0]
    return {name: [r[i] for r in rows] for i, name in enumerate(LANES)} if rows else {}


def collect(profile=None) -> dict:
    """What was recorded since the last call: the host spans, the last
    frame's device spans (after its work completed), the lane counts summed
    over the frames since, and, given the torch.profiler profile those frames
    ran under, the named idle gaps (a profiled frame's device spans are
    stretched by the profiler and are left out of export()'s means)."""
    rec = _REC
    out = {"frames": rec.frame - rec.frames_collected, "host": list(rec.spans), "device": _read_pending(rec.pending),
           "lanes": _read_lanes(), "profiled": profile is not None}
    if profile is not None:
        out["gaps"] = idle_gaps(profile, out["host"])
    rec.spans.clear()
    rec.pending = []
    rec.frames_collected = rec.frame
    rec.collected.append(out)
    return out


def device_ms(rows: list) -> dict:
    """A frame's device ms by span name (the spans of a name summed: one a bounce)."""
    out: dict = {}
    for r in rows:
        out[r["name"]] = out.get(r["name"], 0.0) + r["ms"]
    return out


def export() -> dict:
    """The collected frames reduced to per-frame means: device ms by span
    name, their self ms and the top-level spans' sum, and host ms by span
    name, over the frames not profiled; the lane counts a frame and the share of swept
    lanes alive at the closest sweeps (%); the named idle gaps; the one-shot
    counters and the set-up spans."""
    frames = list(_REC.collected)
    timed = [f for f in frames if f["device"] and not f["profiled"]]
    dev: dict = {}
    dev_self: dict = {}
    top = []
    for f in timed:
        rows = f["device"]
        for name, ms in device_ms(rows).items():
            dev[name] = dev.get(name, 0.0) + ms / len(timed)
        for r, own in zip(rows, self_ms(rows, "start_ms", "end_ms")):
            dev_self[r["name"]] = dev_self.get(r["name"], 0.0) + own / len(timed)
        top.append(sum(r["ms"] for r in rows if r["parent"] is None))
    unprofiled = [f for f in frames if not f["profiled"]]
    host_frames = sum(f["frames"] for f in unprofiled)
    host: dict = {}
    for f in unprofiled:
        for s in f["host"]:
            host[s["name"]] = host.get(s["name"], 0.0) + (s["end_ns"] - s["start_ns"]) / 1e6
    host = {k: v / max(host_frames, 1) for k, v in host.items()}
    lanes = {name: [] for name in LANES}
    lane_frames = 0
    for f in frames:
        if f["lanes"]:
            lane_frames += f["frames"]
            for name in LANES:
                col = lanes[name]
                for i, v in enumerate(f["lanes"][name]):
                    if i < len(col):
                        col[i] += v
                    else:
                        col.append(v)
    swept = sum(lanes["swept"])
    gaps = [g for f in frames for g in f.get("gaps", [])]
    return {
        "frames": sum(f["frames"] for f in frames),
        "timed_frames": len(timed),
        "device_ms": dev,
        "device_self_ms": dev_self,
        "device_top_ms": sum(top) / len(top) if top else None,
        "host_ms": host,
        "lanes": {name: [v / max(lane_frames, 1) for v in col] for name, col in lanes.items()},
        "sweep_lane_use": 100.0 * sum(lanes["alive"]) / swept if swept else None,
        "gaps": sorted(gaps, key=lambda g: -g[1])[:TOP],
        "counters": counters(),
        "setup": setup_spans(),
    }
