"""The benchmark of strelka_tpu_torch on one CUDA card: one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

A cell (an entry of BENCHMARK.json's `workloads`) names a configuration (a
scene, `configs/<name>.json`, whose `scene.kind` names its builder,
`scenes/<kind>.py`) and a traffic mix (`traffic/<name>.json`, the data of
one general schedule: sizes, samples, the camera's cycle of phases); the
per-layer metrics are readers in `metrics/<name>.py` (a metric split by
cells, `<name>.<part>`, falls back to `metrics/<name>.py`) and each cell's
limits of correctness are in `limits/<cell>.json`. All are found by name: a
new cell is new files and new entries, not an edit.

A run loads the scene through the program's loaders, builds a renderer by
the library API (RenderFactory.create_render, TorchRender.render, Buffer.map)
and warms it at a pose of its own: the first launch of the config key runs
eagerly, the second is captured and replayed. That is the set-up
(`setup_s`). The window then drives the traffic mix's closed loop of frames
for --seconds, ending in a synchronize. After it the run takes the device's
peak memory and, with --trace 1, times a few more replayed frames by CUDA
events (their device time and the card's busy share), profiles as many (the
kernels, by name, and the breakdown), and one eager launch (the texture
range and the rays the intersection kernels got). It then frees the
program and checks the frame the run left against the plain reference
(reference.py) on a seeded sample of its pixels, rendered with the samples
the harness's own schedule put into that frame since the camera last moved;
the program's own count of them has to agree.

The last line of standard output is one JSON object (correct, attempted,
failed, metrics, device, breakdown with --trace 1, and `compared`: each
number compared with its limit), and the numbers compared are also the last
lines of standard error. With no card, too few cards, or without the program
beside the benchmark, it exits non-zero and prints no result; also when jax,
jaxlib, flax or the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "strelka_tpu")
PROGRAM = "strelka_tpu_torch"
WARM_STEP = -1  # the orbit step of the warm-up frames: a pose the window does not use
PIPELINE = 2  # launches a loop without a display copy keeps queued on the card
TEXTURE_RANGE = "texture_path"
NONFINITE_GAP = 1e30  # the gap reported for a value that is not finite
EXIT_NO_PROGRAM, EXIT_NO_CARD, EXIT_FORBIDDEN = 2, 3, 4


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of BENCHMARK.json resolved from its files."""

    def __init__(self, bench: dict, name: str, bench_dir: str = BENCH_DIR, root: str = ROOT) -> None:
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.workload = found[0]
        self.name = name
        self.root = root
        self.chips = int(self.workload["chips"])
        self.config_name = self.workload["config"]
        self.traffic_name = self.workload["traffic"]
        cfg = [c for c in bench["configs"] if c["name"] == self.config_name]
        if not cfg:
            raise KeyError(f"no configuration {self.config_name!r} in BENCHMARK.json")
        self.config = _load_json(os.path.join(root, cfg[0]["file"]))
        self.traffic = _load_json(os.path.join(bench_dir, "traffic", self.traffic_name + ".json"))
        self.limits = _load_json(os.path.join(bench_dir, "limits", name + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if self._applies(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
        self.metrics_dir = os.path.join(bench_dir, "metrics")

    def _applies(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def spp_total(self) -> int:
        """Samples a pixel may hold: the traffic's cap, else the scene's own total."""
        t = self.traffic
        return int(t["spp_total"] if t["spp_total"] is not None else self.config["spp_total"])

    def render_settings(self) -> dict:
        """The renderer's settings of this cell: the traffic's, then the scene's own."""
        t, c = self.traffic, self.config
        out = {"render/width": t["width"], "render/height": t["height"], "render/pt/spp": t["spp_per_frame"],
               "render/pt/depth": c["depth"], "render/pt/enableUpscale": bool(t["upscale"]),
               "render/pt/upscaleFactor": t["upscale_factor"], "render/pt/sppTotal": self.spp_total()}
        out.update(c.get("settings", {}))
        return out

    def traced_size(self):
        t = self.traffic
        w, h = t["width"], t["height"]
        if t["upscale"]:  # render/render.py: the traced size of an upscaled frame
            return max(int(w * t["upscale_factor"]) // 8 * 8, 8), max(int(h * t["upscale_factor"]) // 8 * 8, 8)
        return w, h


def load_reader(metrics_dir: str, name: str):
    """The `read` of `metrics/<name>.py`, or, for a metric split by cells
    (`<name>.<part>`) that has no file of its own, of `metrics/<name>.py`."""
    path = os.path.join(metrics_dir, name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(metrics_dir, name.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location("bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


ADVANCES = ("every", "first", "none")


class Schedule:
    """The traffic mix's camera: the orbit step of each frame of the run.

    The traffic's `cycle` is a list of phases, repeated: each phase is
    `frames` frames long (null: as many as the cell's samples a pixel allow,
    spp_total / spp_per_frame) and `advance`s the camera one orbit step at
    "every" frame, at its "first" frame only, or at "none". A frame's step is
    the number of advancing frames up to it, less one, so the run's first
    frame (which has to advance) is at step 0. A step that changes resets the
    accumulation; a still camera accumulates."""

    def __init__(self, traffic: dict, spp_total: int, spp_per_frame: int) -> None:
        fill = max(spp_total // spp_per_frame, 1)
        self.phases = [(fill if p["frames"] is None else int(p["frames"]), p["advance"]) for p in traffic["cycle"]]
        if not self.phases or any(n < 1 or a not in ADVANCES for n, a in self.phases):
            raise ValueError(f"a cycle is phases of one frame or more, advancing one of {ADVANCES}")
        if self.phases[0][1] == "none":
            raise ValueError("a cycle's first frame advances the camera")
        self.length = sum(n for n, _ in self.phases)
        self.per_cycle = self._advances(self.length)

    def _advances(self, frames: int) -> int:
        """Advancing frames among the cycle's first `frames`."""
        count, left = 0, frames
        for n, advance in self.phases:
            k = min(n, left)
            count += k if advance == "every" else (1 if advance == "first" and k > 0 else 0)
            left -= k
        return count

    def step(self, frame: int) -> int:
        cycle, k = divmod(frame, self.length)
        return cycle * self.per_cycle + self._advances(k + 1) - 1


def frame_p95(frames_ms) -> float:
    """The 95th percentile over every frame time of the window (numpy's linear rule)."""
    return float(np.percentile(np.asarray(frames_ms, np.float64), 95))


def sample_rate(samples: int, window_s: float) -> float:
    """Msamples/s: every pixel sample the window completed over its whole time."""
    return samples / window_s / 1e6


@contextlib.contextmanager
def replay_marks(torch, marks: list):
    """While open, a CUDA event is recorded right before each CUDA graph
    replay is enqueued and appended to `marks`: where a frame's device work
    begins, after render()'s host part."""
    cls = torch.cuda.CUDAGraph
    replay = cls.replay

    def marked(self, *a, **k):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return replay(self, *a, **k)

    cls.replay = marked
    try:
        yield
    finally:
        cls.replay = replay


class ProgramRun:
    """The program side of one run: set-up, the window, the trace."""

    def __init__(self, cell: Cell, seed: int, device, t_start: float) -> None:
        import torch

        from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
        from strelka_tpu_torch.render.render import RenderFactory
        from strelka_tpu_torch.settings import SharedContext, make_default_settings

        import inputs

        self.torch = torch
        self.cell, self.seed, self.device = cell, seed, torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.spans = {"start_s": time.perf_counter() - t_start}  # interpreter, torch, the card's context
        self.settings_dict = cell.render_settings()
        t = time.perf_counter()
        self.host = inputs.load_scene("program", cell.root, cell.config, seed)
        self.spans["scene_load_s"] = time.perf_counter() - t
        settings = make_default_settings(cell.traffic["width"], cell.traffic["height"])
        for key, value in self.settings_dict.items():
            settings.set(key, tuple(value) if isinstance(value, list) else value)
        t = time.perf_counter()
        self.render = RenderFactory.create_render(device=self.device)
        self.render.set_scene(self.host)
        self.ctx = SharedContext(settings)
        self.render.set_shared_context(self.ctx)
        self.render.init()
        self.buf = self.render.create_buffer(BufferDesc(cell.traffic["width"], cell.traffic["height"],
                                                        BufferFormat.FLOAT4))
        self.spans["init_s"] = time.perf_counter() - t  # the renderer's creation to its output buffer
        self.spp = int(self.settings_dict["render/pt/spp"])
        self.spp_total = int(self.settings_dict["render/pt/sppTotal"])
        self.schedule = Schedule(cell.traffic, self.spp_total, self.spp)
        self.pose_step = None
        self.samples = 0  # samples a pixel the schedule has put in since the camera last moved
        self.frame_index = 0
        self.host_range = contextlib.nullcontext  # a profiler range in the traced frames
        self.viewport = cell.traffic["map_each_frame"]
        # set-up: three frames at the warm-up pose (the key's eager launch, its
        # capture, a replay), each ending in a synchronize
        self.set_pose(WARM_STEP)
        for span in ("first_launch_s", "capture_s", None):
            t = time.perf_counter()
            self._render()
            if self.viewport:
                self.buf.map()
            self.sync()
            if span:
                self.spans[span] = time.perf_counter() - t
        self.setup_s = time.perf_counter() - t_start

    def sync(self) -> None:
        if self.on_card:
            self.torch.cuda.synchronize(self.device)

    def set_pose(self, step: int) -> None:
        import inputs

        if step != self.pose_step:
            eye, target = inputs.orbit_pose(self.cell.config, self.seed, step, self.cell.traffic["pose_stride"])
            self.host.get_camera(0).look_at(eye, target)
            self.pose_step = step
            self.pose = (eye, target)
            self.samples = 0

    def _render(self) -> None:
        with self.host_range("bench.render"):
            self.render.render(self.buf)
        self.samples = min(self.samples + self.spp, self.spp_total)

    def frame(self, log=None, end_event=None, copy_events=None) -> None:
        """The next frame of the schedule: render(), and in the viewport its
        image to the host; log gets (call, render, display, whole) seconds;
        end_event is recorded behind the frame's device work, and the pair
        copy_events around the display's copy."""
        self.set_pose(self.schedule.step(self.frame_index))
        self.frame_index += 1
        t0 = time.perf_counter()
        self._render()
        t1 = time.perf_counter()
        if end_event is not None:
            end_event.record()
        if self.viewport:
            with self.host_range("bench.wait"):
                if self.on_card:
                    ev = self.torch.cuda.Event()
                    ev.record()
                    ev.synchronize()
            t2 = time.perf_counter()
            if copy_events is not None:
                copy_events[0].record()
            with self.host_range("bench.display"):
                self.buf.map()
            if copy_events is not None:
                copy_events[1].record()
            t3 = time.perf_counter()
            if log is not None:
                log.append((t1 - t0, t2 - t1, t3 - t2, t3 - t0))

    def frames(self, n: int, log=None, end_events=None, copy_events=None) -> None:
        """n frames as the window runs them: a loop without a display copy
        keeps PIPELINE launches queued on the card."""
        torch, queued = self.torch, collections.deque()
        for i in range(n):
            self.frame(log, None if end_events is None else end_events[i],
                       None if copy_events is None else copy_events[i])
            if self.on_card and not self.viewport:
                ev = torch.cuda.Event()
                ev.record()
                queued.append(ev)
                if len(queued) > PIPELINE:
                    queued.popleft().synchronize()

    def window(self, seconds: float) -> dict:
        """The measured closed loop: frames until `seconds` have passed, then a synchronize."""
        log = []
        frames = 0
        t0 = time.perf_counter()
        while True:
            self.frames(1, log)
            frames += 1
            if time.perf_counter() - t0 >= seconds:
                break
        self.sync()
        window_s = time.perf_counter() - t0
        w, h = self.cell.traced_size()
        out = {"frames": frames, "window_s": window_s, "samples": frames * w * h * self.spp, "log": log}
        out["msamples_per_s"] = sample_rate(out["samples"], window_s)
        if log:
            out["p95_ms"] = frame_p95([x[3] * 1e3 for x in log])
            out["render_call_ms"] = float(np.mean([x[0] for x in log])) * 1e3
            out["display_ms"] = float(np.mean([x[2] for x in log])) * 1e3
        return out

    def trace(self) -> dict:
        """Replayed frames timed by CUDA events, then profiled, then one
        eager launch of the same key with the texture range and the kernels'
        ray recorders on."""
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        from strelka_tpu_torch.kernels import bvh as KB
        from strelka_tpu_torch.kernels import cones as KC
        from strelka_tpu_torch.kernels import intersect as KI
        from strelka_tpu_torch.ops import integrator as I

        import bounds
        import tracing

        n = int(self.cell.traffic["trace_frames"])
        # each frame's device ms by CUDA events, from the mark before its
        # graph replay is enqueued (after render()'s host part) to the event
        # behind its work, and the display copy's between the events around
        # it; the card's busy seconds are their sum over the frames' wall
        # time. Without the profiler, whose tracing of ~10^4 graph kernels a
        # frame stretches them and the host's calls between them.
        self.sync()
        timed = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
        marks, ends = [], [timed() for _ in range(n)]
        copies = [(timed(), timed()) for _ in range(n)] if self.viewport else None
        t0 = time.perf_counter()
        with replay_marks(torch, marks):
            self.frames(n, end_events=ends, copy_events=copies)
            self.sync()
        events_window_s = time.perf_counter() - t0
        if len(marks) != n:
            raise RuntimeError(f"trace: {len(marks)} graph replays in {n} frames; every traced frame replays")
        frame_ms = [b.elapsed_time(e) for b, e in zip(marks, ends)]
        copy_ms = [a.elapsed_time(b) for a, b in copies] if copies else []
        # the profiler: kernels by name, the breakdown's device operations and
        # what the host did in each idle gap
        self.host_range = record_function
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                self.frames(n)
                self.sync()
        finally:
            self.host_range = contextlib.nullcontext
        replayed = tracing.reduce_events(prof.events(), n)

        # one eager launch: the graph dropped, the key's next launch runs eagerly
        k2_calls, k5_calls, k7_calls = [], [], []
        shade, bvh_closest, cone_closest = I.shade_textures, KB.bvh_closest, KC.cone_closest
        flat_closest = KI.intersect_closest

        def traced_shade(*a, **k):
            with record_function(TEXTURE_RANGE):
                return shade(*a, **k)

        def rec_bvh(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, ray_mask, *a, **k):
            out = bvh_closest(o, d, tmin, tmax, exclude, bvh, v0, e1, e2, mask, ray_mask, *a, **k)
            k5_calls.append((torch.stack(o, 1).clone(), torch.stack(d, 1).clone(), tmin.clone(), tmax.clone(),
                             out[0].clone(), v0, e1, e2, mask, int(ray_mask)))
            return out

        def rec_cone(o, d, tmin, tmax, cones, *a, **k):
            out = cone_closest(o, d, tmin, tmax, cones, *a, **k)
            k7_calls.append((torch.stack(o, 1).clone(), torch.stack(d, 1).clone(), tmin.clone(), tmax.clone(),
                             out[0].clone(), cones.geom))
            return out

        def rec_flat(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask, *a, **k):
            out = flat_closest(o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask, *a, **k)
            k2_calls.append((torch.stack(o, 1).clone(), torch.stack(d, 1).clone(), tmin.clone(), tmax.clone(),
                             out[0].clone(), v0, e1, e2, mask, int(ray_mask)))
            return out

        I.shade_textures, KB.bvh_closest, KC.cone_closest = traced_shade, rec_bvh, rec_cone
        KI.intersect_closest = rec_flat
        try:
            self.render._drop_graphs()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                self.frame()
                self.sync()
        finally:
            I.shade_textures, KB.bvh_closest, KC.cone_closest = shade, bvh_closest, cone_closest
            KI.intersect_closest = flat_closest
        eager = tracing.reduce_events(prof.events(), 1, (TEXTURE_RANGE,))
        return {
            "frame_device_ms": float(np.mean(frame_ms)),
            "busy_s": (sum(frame_ms) + sum(copy_ms)) / 1e3,
            "window_s": events_window_s,
            "replayed": replayed,
            "eager": eager,
            "has_textures": self.render._device_scene.textures is not None,
            "k5_bound_s": bounds.triangle_bound_s(k5_calls, self.seed) if k5_calls else None,
            "k7_bound_s": bounds.cone_bound_s(k7_calls, self.seed) if k7_calls else None,
            "k2_bound_s": bounds.flat_bound_s(k2_calls, self.seed) if k2_calls else None,
        }

    def output(self) -> dict:
        """The frame the program left, on the host, and what made it."""
        image = self.buf.map()
        w, h = self.cell.traced_size()
        return {"image": np.array(image, copy=True), "samples": self.samples,
                "program_samples": int(self.ctx.subframe_index), "pose": self.pose,
                "traced": (w, h), "out": (self.cell.traffic["width"], self.cell.traffic["height"])}

    def close(self) -> None:
        del self.render, self.buf, self.host, self.ctx
        gc.collect()
        if self.on_card:
            self.torch.cuda.synchronize(self.device)
            self.torch.cuda.empty_cache()


def sample_pixels(seed: int, width: int, height: int, count: int) -> tuple:
    """`count` distinct pixels of a width x height frame, drawn from the seed."""
    import inputs

    rng = inputs.rng_for(seed, 0x5EED0003)
    flat = rng.choice(width * height, size=min(count, width * height), replace=False)
    return flat % width, flat // width


def reference_values(ref, cell: Cell, seed: int, out: dict, lowp: bool, order: str):
    """The reference's [3, P] display values at the sampled output pixels,
    with the samples the harness's schedule put into the frame."""
    from reference import apply_upscale, make_settings, upscale_plan

    settings = make_settings(cell.render_settings())
    (tw, th), (ow, oh) = out["traced"], out["out"]
    view = ref.camera(out["pose"][0], out["pose"][1], tw, th)
    ox, oy = sample_pixels(seed, ow, oh, int(cell.limits["pixels"]))
    if (tw, th) == (ow, oh):
        return ox, oy, ref.pixels(settings, view, ox, oy, out["samples"], tw, th, order, lowp)
    tx, ty, index, weights = upscale_plan(ox, oy, ow, oh, tw, th)
    traced = ref.pixels(settings, view, tx, ty, out["samples"], tw, th, order, lowp)
    return ox, oy, apply_upscale(traced, index, weights)


def compare(program_rgb: np.ndarray, reference_rgb: np.ndarray, program_samples: int, samples: int) -> dict:
    """Program [P, 3] against reference [P, 3] display values, and the
    program's count of the frame's samples against the schedule's:
    max_gap, the widest gap of a channel over the sampled pixels (a value
    that is not finite gaps NONFINITE_GAP); samples_off, how far the counts
    differ."""
    gap = np.abs(program_rgb.astype(np.float64) - reference_rgb.astype(np.float64))
    gap = np.where(np.isfinite(gap), gap, NONFINITE_GAP)
    return {"max_gap": float(gap.max()), "samples_off": float(abs(int(program_samples) - int(samples)))}


def judge(numbers: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} of each number the cell's limits hold."""
    return {k: {"value": numbers[k], "limit": float(v)} for k, v in limits["compare"].items()}


def check(cell: Cell, seed: int, out: dict, device, control: bool) -> tuple:
    """(correct, compared, seconds) of the frame `out` against the reference."""
    import torch

    from reference import Reference

    t = time.perf_counter()
    order = "zorder" if torch.device(device).type == "cuda" else "rowmajor"
    ref = Reference(cell.root, cell.config, seed, device)
    ox, oy, want = reference_values(ref, cell, seed, out, False, order)
    if control:  # the reference in bfloat16, put in the program's place
        got = reference_values(ref, cell, seed, out, True, order)[2].T.cpu().numpy()
    else:
        got = out["image"][oy, ox, :3]
    numbers = compare(got, want.T.cpu().numpy(), out["program_samples"], out["samples"])
    compared = judge(numbers, cell.limits)
    correct = all(np.isfinite(c["value"]) and c["value"] <= c["limit"] for c in compared.values())
    return correct, compared, time.perf_counter() - t


def card_kind(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if torch.device(device).type == "cuda" else "cpu"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda", t_start=None,
             control: bool = False) -> dict:
    """One run: the result object of the last line, and the run's records."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    prog = ProgramRun(cell, seed, device, t_start)
    win = prog.window(seconds)
    closed = forbidden_modules()
    on_card = torch.device(device).type == "cuda"
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    traced = prog.trace() if trace and on_card else None
    out = prog.output()
    prog.close()
    correct, compared, ref_s = check(cell, seed, out, device, control)
    record = {"spans": prog.spans, "window": win, "trace": traced, "setup_s": prog.setup_s}
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(cell.metrics_dir, m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {"setup_s": prog.setup_s, "msamples_per_s": win["msamples_per_s"],
                  "frame_ms_p95": win.get("p95_ms")}
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]} for m in cell.end_to_end}
    device_info = {"platform": "gpu" if on_card else "cpu", "kind": card_kind(device), "count": cell.chips,
                   "memory_peak_bytes": peak}
    result = {"correct": bool(correct), "attempted": win["frames"], "failed": 0, "metrics": metrics,
              "device": device_info}
    if traced is not None:
        device_info["busy_s"] = traced["busy_s"]
        device_info["window_s"] = traced["window_s"]
        result["breakdown"] = {"device_ops": [list(x) for x in traced["replayed"]["device_ops"]],
                               "idle_gaps": [list(x) for x in traced["replayed"]["idle_gaps"]]}
    result["compared"] = compared
    return {"result": result, "record": record, "forbidden_at_close": closed, "reference_s": ref_s,
            "samples_per_pixel": out["samples"]}


def parse(argv):
    ap = argparse.ArgumentParser(description="One run of one cell of the benchmark.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="judge the reference in bfloat16 in the program's place (the control; not a run)")
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    bench = _load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = Cell(bench, args.workload)
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"benchmark: the program ({PROGRAM}) is not beside the benchmark", file=sys.stderr)
        return EXIT_NO_PROGRAM
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: the cell needs {cell.chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return EXIT_NO_CARD
    torch.cuda.set_device(0)
    run = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start, bool(args.control))
    found = sorted(set(run["forbidden_at_close"]) | set(forbidden_modules()))
    if found:
        print(f"benchmark: loaded in this process: {', '.join(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    result = run["result"]
    print(f"benchmark: {cell.name} seed {args.seed}: {result['attempted']} frames, "
          f"{run['samples_per_pixel']} samples a pixel, {run['record']['window']['msamples_per_s']!r} Msamples/s, "
          f"set-up {run['record']['setup_s']!r} s, reference {run['reference_s']:.2f} s", file=sys.stderr)
    traced = run["record"]["trace"]
    if traced is not None:
        print(f"benchmark: traced frames: {traced['frame_device_ms']!r} device ms a frame, busy "
              f"{traced['busy_s']!r} s of {traced['window_s']!r} s by events; profiled: busy "
              f"{traced['replayed']['busy_s']!r} s of {traced['replayed']['window_s']!r} s", file=sys.stderr)
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
