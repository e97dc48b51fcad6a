#!/usr/bin/env python3
"""The program's own spans and counters on a cell of the benchmark, on a CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_bench_spans.py --workload kitchen-converge --seed 2147483719 [--cost 10] [--out DIR]

Sets the cell up as `benchmark/run.py` does (benchmark/harness.py:ProgramRun:
the scene through the program's loaders, the library API, the key's eager
launch, its capture and a replay, the recorder of utils/profiling.py off),
runs the benchmark's window once, and then:

1. with --cost S: the window again in turns with the recorder off and on
   (off, on, on, off; S seconds each; two frames before each, which capture
   the key again): each turn's Msamples/s and p95 frame ms, the cost of
   recording every frame's spans and counters;
2. the harness's traced passes as they are (ProgramRun.trace: replayed frames
   timed by CUDA events, as many profiled, one eager launch), for the
   benchmark's outside metrics of the same process;
3. the recorder's pass: enable(); two frames (the key captured again, with
   its device spans and lane counters); the traffic's trace_frames frames,
   each followed by a synchronize and collect(), each also timed by CUDA
   events as the harness times a frame (from a mark before the graph replay
   to an event behind render()); as many frames under torch.profiler, whose
   collect(profile) names each idle gap by the innermost program host span
   that holds its midpoint; disable(); export().

Prints one JSON line, also written to DIR/<workload>.json: the export, the
span metrics the benchmark's program-side readers would take from it
(sweep_span_ms: bounce.closest + bounce.shadow; shade_span_ms:
bounce.surface + bounce.bsdf + bounce.nee - bounce.shadow + bounce.next;
order_span_ms: bounce.order + launch.unorder; texture_span_ms:
bounce.texture; sweep_lane_use; device_scene_s; prepare_host_ms; on a
scene with curves the two sweeps of bounce.closest and bounce.shadow,
closest_triangles_ms, closest_curves_ms, shadow_triangles_ms and
shadow_curves_ms; curve_hit_share, each bounce's closest hits on a curve
in % of its hits; curves_load_s, the sum of the usd.curves set-up spans;
scene_counts, the one-shot counters scene.triangles, scene.curve_segments,
scene.cones and cones.tree_levels), the top-level spans' sum beside the
same frames' event time, the harness's outside metrics, and the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "benchmark")


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


CHILD_SWEEPS = ("closest.triangles", "closest.curves", "shadow.triangles", "shadow.curves")  # scenes with curves
SCENE_COUNTS = ("scene.triangles", "scene.curve_segments", "scene.cones", "cones.tree_levels")


def span_metrics(export: dict) -> dict:
    """The per-frame span metrics of an export (None where a span is absent)."""
    dev, host = export["device_ms"], export["host_ms"]

    def total(*names):
        found = [dev[n] for n in names if n in dev]
        return sum(found) if found else None

    shade = total("bounce.surface", "bounce.bsdf", "bounce.nee", "bounce.next")
    setup = [s for s in export["setup"] if s["name"] == "device_scene.build"]
    curves = [s for s in export["setup"] if s["name"] == "usd.curves"]
    lanes = export["lanes"]
    hits = [c + t for c, t in zip(lanes.get("curve_hits", []), lanes.get("triangle_hits", []))]
    return {
        **{name.replace(".", "_") + "_ms": dev.get(name) for name in CHILD_SWEEPS},
        "curve_hit_share": [100.0 * c / h if h else None for c, h in zip(lanes.get("curve_hits", []), hits)],
        "sweep_span_ms": total("bounce.closest", "bounce.shadow"),
        "shade_span_ms": None if shade is None else shade - dev.get("bounce.shadow", 0.0),
        "order_span_ms": total("bounce.order", "launch.unorder"),
        "texture_span_ms": dev.get("bounce.texture"),
        "sweep_lane_use": export["sweep_lane_use"],
        "device_scene_s": (setup[-1]["end_ns"] - setup[-1]["start_ns"]) / 1e9 if setup else None,
        "prepare_host_ms": host.get("render.prepare"),
        "curves_load_s": sum(s["end_ns"] - s["start_ns"] for s in curves) / 1e9 if curves else None,
        "scene_counts": {name: export["counters"].get(name, {}).get("") for name in SCENE_COUNTS},
    }


def cost(prog, P, seconds: float) -> list:
    """The window in turns with the recorder off and on: [(state, Msamples/s, p95 ms)]."""
    turns = []
    for on in (False, True, True, False):
        (P.enable if on else P.disable)()
        prog.frames(2)  # a changed state captures the key again
        prog.sync()
        win = prog.window(seconds)
        P.collect()
        turns.append(("on" if on else "off", win["msamples_per_s"], win.get("p95_ms")))
    P.disable()
    return turns


def recorder_pass(prog, P, n: int) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import harness

    P.enable()
    prog.frames(2)
    prog.sync()
    setup, counters = P.setup_spans(), P.counters()
    P.reset()  # the export holds this pass's frames alone, and what was set up and counted before
    timed = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
    coverage = []
    for _ in range(n):
        marks, end = [], timed()
        with harness.replay_marks(torch, marks):
            prog.frames(1, end_events=[end])
            prog.sync()
        rows = P.collect()["device"]
        coverage.append((marks[0].elapsed_time(end), sum(r["ms"] for r in rows if r["parent"] is None)))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prog.frames(n)
        prog.sync()
    P.collect(prof)
    P.disable()
    export = P.export()
    export["setup"] = setup + export["setup"]
    for name, per in export["counters"].items():
        for label, n in per.items():
            counters.setdefault(name, {})[label] = counters.get(name, {}).get(label, 0) + n
    export["counters"] = counters
    return {"export": export, "coverage": coverage}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0, help="the benchmark's window")
    ap.add_argument("--cost", type=float, default=0.0, help="seconds of each turn off / on (0: no turns)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [REPO, BENCH]
    import torch

    if not torch.cuda.is_available():
        print("torch_bench_spans: no CUDA card", file=sys.stderr)
        return 2
    import harness

    from strelka_tpu_torch.utils import profiling as P

    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        cell = harness.Cell(json.load(f), args.workload)
    torch.cuda.set_device(0)
    prog = harness.ProgramRun(cell, args.seed, "cuda", T_START)
    win = prog.window(args.seconds)
    out = {"workload": args.workload, "seed": args.seed, "card": card(), "torch": torch.__version__,
           "setup_s": prog.setup_s, "window": {k: win.get(k) for k in ("frames", "msamples_per_s", "p95_ms")}}
    if args.cost > 0:
        out["cost_turns"] = cost(prog, P, args.cost)
    traced = prog.trace()
    fams = traced["replayed"]["family_ms_per_launch"]
    sweeps = ("intersect_closest", "intersect_any", "bvh_closest", "bvh_any", "cone_closest", "cone_any", "open_w")
    out["outside"] = {
        "launch_device_ms": traced["frame_device_ms"],
        "shading_device_ms": traced["frame_device_ms"] - sum(fams.values()),
        "texture_device_ms": traced["eager"]["range_ms_per_launch"].get(harness.TEXTURE_RANGE),
        "kernels_per_launch": traced["replayed"]["kernels_per_launch"],
        "sweep_kernels_profiled_ms": sum(v for k, v in fams.items() if k in sweeps),
        "family_ms_per_launch": fams,
        "render_call_ms": win.get("render_call_ms"),
    }
    rec = recorder_pass(prog, P, int(cell.traffic["trace_frames"]))
    export = rec["export"]
    out["spans"] = span_metrics(export)
    out["coverage"] = [{"event_ms": e, "top_level_ms": t, "off": t / e - 1.0} for e, t in rec["coverage"]]
    out["export"] = export
    prog.close()
    line = json.dumps(out)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, args.workload + ".json"), "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
