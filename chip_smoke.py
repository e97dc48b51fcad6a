#!/usr/bin/env python3
"""H100 probe of the PyTorch/CUDA port (strelka_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the CUDA kernels from strelka_tpu_torch/csrc with nvcc (sm_90a,
     one nvcc per source, all started together) into
     strelka_tpu_torch/_build/;
  2. Cornell (flat scene, kernels K1-K4): hold each kernel against its plain
     PyTorch version on the card at every shape the Cornell main path
     gives it (512x512, 4 spp: 2^20 rays a bounce) and time both (CUDA
     events, median; K1 also on the device alone, replayed from a CUDA
     graph, and the wrapper's host time a call); K1 bit for bit at both
     dimension lists of a launch at every depth, and at lists that reach
     every instance of the kernel (unordered and repeated dimensions), and
     its instruction mix from `cuobjdump -sass` (no constant-memory load
     in its fold); K2/K3, culled by the scene's 32-triangle group boxes,
     on the camera, bounce-1, bounce-0 NEE shadow and shadow-style rays (and
     on the camera rays against the table twice over, every hit a tie)
     against the dense plain versions, their cull=False mode and the
     one-ray-a-thread schedule, and their per-ray counts of groups tested
     against the plain copies of their walks; the same for the rays of
     scene/grazing.py that hunt the box test's rounding edge (the grazing
     soup and coplanar grids turned, scaled and moved, rays at their shared
     vertices, edges and overlaps), with K5 and K6 on a BVH of the same
     triangles against their plain versions and the dense sweeps (the
     comparisons with the dense versions on every lane whose hit lies inside
     the box test's margin's domain; the lanes outside it counted); K4 at
     the main path's shape and at edge shapes off its 16-byte paths (odd
     widths and N, a table at an unaligned offset); render the golden
     config through TorchRender and require SSIM >= 0.99 against
     goldens/cornell_golden.png; drive the main path
     at full size (render_launch, depth 4, accumulation: 1 warm-up + 16
     timed launches) with every launch count reset just before and read
     just after;
  3. box_field(grid=12), 25,732 triangles, built flat and with the BVH:
     K2/K3 held as on Cornell at that size (camera, bounce-1 and shadow
     rays), K5 against its three oracles (check_k5: its plain near-to-far
     walk bit for bit with its per-ray counters, the dense sweep K2
     cull=False bit for bit, and the reference's DFS walk wherever that walk
     keeps the dense hit) on the camera and bounce-1 rays and on the tie
     table (the tree's triangles twice over, one copy a half), K6 against
     its plain twin (its near-to-far any-hit walk: occlusion and per-ray
     counters equal) and against K3 in cull=False mode (inside the margin's
     domain; the lanes outside it counted) on the camera, bounce-1 and
     shadow rays, and the two golden-config renders compared;
  4. box_field(grid=48), 411,652 triangles on a BVH (kernels K1, K4, K5,
     K6): K5 against its three oracles on the scene's camera and bounce-1
     rays, K6 against its plain twin and against K3 brute force
     (cull=False, inside the margin's domain) on all three (2^19 lanes
     each), their times and bounds (K5's and K6's rows with the boxes, K6's
     also the child rows, and triangles they test a ray beside what a ray
     needs and beside the DFS walk's, the stack depth, registers and local
     memory; K6's bound counted from the reference's DFS walk with the
     margin, its time also on the device alone), K1 at
     2^19 sample indices, K4 at this scene's
     two tables (attr_table [411776, 68] and light_table [2, 20]); the
     golden config
     against goldens/box_field_golden.png; the main path at 512x512, 2 spp,
     depth 4 (1 warm-up + 4 timed launches), counts reset and read as above;
     after each main path, every (kernel, shape) it launched must be one
     that was held against its plain version before;
  5. hair_patch(n_curves=256), 1,280 cubic B-spline segments as 10,240 round
     cones over a ground quad (kernels K1-K4, K7, K8): K7 and K8, each
     walking the cone tree, against the plain dense sweep (t, cone, y and
     occlusion equal on every lane) and against their own cull=False mode,
     and their counters (inner boxes, leaves, cones) against the plain count
     of their walk, on the scene's camera, bounce-1 and shadow rays
     (384x384x2 = 294,912 lanes each); the boxes, leaves and cones a ray
     tests beside the cones whose own box its final interval enters (the
     roofline's count); K1-K4 at this scene's shapes
     (K2/K3 held as on Cornell on the camera, bounce-1 and shadow rays);
     the golden config (64x64, 4 spp x 16 launches) against
     goldens/hair_patch_golden.png; the main path at 384x384, 2 spp, depth 4
     (1 warm-up + 4 timed launches);
  6. hair_patch(n_curves=20000) ("hair_long"), 100,000 segments as 800,000
     cones under a cone tree of three levels: K7/K8 against cull=False on
     every lane and against the plain sweep and the plain count of their
     walks on a fixed subset of 2^14 lanes, the boxes, leaves and cones a
     ray tests beside what it needs (counted in plain PyTorch); kernel K9,
     off the cone sweeps' path, on the scene's 391 superblocks at tiles of 64
     rays: against its plain version (W and min_tn bit for bit, the open
     flag with the reference's K = 16 nearest superblocks swept, and the
     sweep order sorted in the same launch: order, count and tnear bit for
     bit) on every lane, also with the superblocks three times over (1,173,
     past a block's threads) and rays no multiple of the tile; the main path
     at 384x384, 2 spp, depth 4 (1 warm-up + 2 timed launches); the golden
     config (32x32, 2 spp x 4 launches) against
     goldens/hair_long_golden.png;
  7. coffeetable (data/scenes/coffeetable.usda through the port's
     UsdLoader: 64 triangles padded to 128, flat, 2 lights; kernels K1-K4):
     K1 at its 2^19 sample indices, K2/K3 on its camera, bounce-1 and
     shadow rays (2^19 x 128: 4 groups, one ray a thread) held as on
     Cornell, K4 on both tables ([128, 68] attr, [2, 20] light) bit for
     bit; the golden config (64x64, 4 spp x 16 launches) against
     goldens/coffeetable_golden.png; the main path at 512x512, 2 spp, depth
     4 (1 warm-up + 8 timed launches);
  8. kitchen (data/gen/kitchen/kitchen.usdc through the crate reader and
     UsdLoader: 105,168 triangles on a BVH, 10 materials, 4 textures in a
     u8 atlas, 4 lights; kernels K1, K4, K5, K6 and the texture path): the
     load's seconds and whether the native crate codec decoded; K5 against
     its three oracles on the camera and bounce-1 rays (the dense sweep and
     the DFS walk inside the margin's domain, the lanes outside it
     counted), K6 against its
     plain twin and K3 brute force (inside the margin's domain) on the
     camera, bounce-1 and shadow rays, with the walk counters; K4 on both
     tables ([105,216, 68] attr, [4, 20] light); the golden config (64x64,
     2 spp x 8 launches) against goldens/kitchen_golden.png; the main path
     at 512x512, 2 spp, depth 4 (1 warm-up + 4 timed launches);
  9. the user's entry points, at the sizes their users run: each (kernel,
     shape) they launch held first against its plain version (hold_at),
     then (1) `python -m strelka_tpu_torch.app.cli -s builtin://cornell_box
     -t 16 -f 4` in a subprocess at its defaults (1024x768, depth 4), its
     PNG equal on every pixel to an in-process TorchRender render; the rest
     in-process through main(argv), each with the launch counts set to 0
     just before and read just after: (2) `--upscale 0.5` (traced at
     512x384; the card's resize within 1e-6 of the CPU's on the same traced
     image, the PNG equal to it), (3) `--multichip` (one band on one card,
     its PNG equal to (1)'s), and shard_launch over the card four times
     (192-row bands) bit-equal to the unbanded launch in accum and image,
     no band tensor moved between devices, (4) box_field(grid=48) written
     as a .glb (411,652 triangles on a BVH; its rect light in the sidecar)
     through the CLI, with its load and BVH seconds, (5) the USD runner on
     kitchen and coffeetable at 1024x768, each PNG equal to an in-process
     render of the stage, (6) `--profile` on 2 Cornell frames, the K2/K3
     kernel of Cornell's schedule among summarize_trace's top 10, (7) the
     viewer, 4 frames at 640x480 streamed to a PNG; one JSON line an item
     (wall seconds, ms a frame, FrameStats' Mray/s, TorchRender's ms a
     launch at the same size, the card);
 10. the launch cache (render/render.py: TorchRender caches each static
     config key's launch as one CUDA graph, GraphLaunch), run at the end of
     each main path's phase above (phase_launch_graph): one eager launch
     with its values on the card under set_sync_debug_mode("error"); nine
     TorchRender frames (eager, capture and replay, replays; two camera
     moves; a second, 1-spp key at the budget's end) 0 values off
     render_launch run eagerly from the same start, with equal launch
     counts frame by frame; ms a launch eager against replayed in one call, the capture's
     seconds, the graph's nodes, the peak device memory with the graphs
     held, device ms and idle share of replayed launches; one JSON line a
     path. The golden phases above go through TorchRender, so through the
     graphs;
 11. print the kernels' JSON line, the card's name and power limit, and
     last the {"ok": true, ...} line;
 12. (run before 11) hair_patch(n_curves=256) at 96x96, 2 spp x 2 with
     STRELKA_HAIR_KK=1 in a child process: the Kajiya-Kay fibre lobes on,
     the image finite, its mean beside the default (Chiang) model's;
 13. the accelerator path's wavefront order (ops/integrator.py: Z-order
     pixels, from bounce 1 the sort of box_field, hair_long and kitchen,
     the packed permutes through K4), run before each main path's phase
     (phase_order): K4 held bit for bit and timed at the path's permutes
     ([n, 11] Z-order restore; [N, 21] sort permute and [N, 4] radiance
     restore where the scene sorts) on the launch's own permutations and
     words with small ints and NaN patterns; one eager launch ordered
     against one unordered, 0 values off in image, accum, AOVs and counters
     (kitchen, textured, draws its texels by Z-rank: there the sort on
     against off with Z-order held, 0 off, and ordered against unordered
     counted); K5/K6 boxes, K7 sub-blocks a live ray and K9 superblocks a
     tile with the kernels' times, row-major against the launch's order;
     and after each launch-cache phase the A/B (phase_order_ab):
     TorchRender's replayed launches ordered, unordered and (where the
     scene sorts) Z-order alone, in turns. The golden phases and phase 10
     run the ordered launch (the card's default), so the goldens, the
     replays against eager launches, the sync-debug check and phase 9's
     bands hold it too;
 14. (run before 11) the north-star showcase: scripts/torch_northstar.py
     at 1024x768, 32 spp, cut at 16 spp by --max-seconds in a child process,
     resumed, bit-equal to an uninterrupted run, its PNG written;
 15. (run after 1) kernel K10, the BSDF phase (kernels/shade.py): each of
     its three instances (no fibre, Chiang, Kajiya-Kay) bit for bit against
     the plain phase on random lanes of every material type at depths 0 and
     1 at 1, 1,023 and 2^20 + 3 lanes (tests/torch_lanes.py makes the lanes;
     an instance is selected through ops/bsdf.py's switch, hair_lobes); the
     no-fibre and Chiang instances held and timed at 786,432 and 196,608 lanes (the benchmark's converge
     and viewport wavefronts): ms by events, device_ms replayed from a CUDA
     graph, the plain phase both ways, bound_ms from the bytes a lane must
     move at 3.35 TB/s. Every main path and entry point holds K10 first at
     its own lanes and instance (hold_shade).
 16. (run after 15) kernels K11 and K12, the NEE phase less its shadow sweep
     (kernels/nee.py): K11 at both rect light sampling methods, then K12 on
     K11's handoff at each of its three instances, bit for bit against the
     plain halves on random lanes of every light and material type with NaN
     planted (both canaries) at 1, 1,023 and 2^20 + 3 lanes; K11 (both
     methods) and K12's no-fibre and Chiang instances held and timed alone at
     786,432 and 196,608 lanes (ms by events, device_ms replayed from a CUDA
     graph, the plain half both ways, bound_ms from the bytes a lane must
     move at 3.35 TB/s). Every main path and entry point holds both first at
     its own lanes (hold_nee).
 17. (run after 16) kernel K13, the surface phase less its texture lookups
     (kernels/surface.py): each of its six instances (curves or not, the
     refinement or not, the uv outputs or not) bit for bit against the plain
     phase on random lanes (misses, light hits of every type, triangles from
     both sides, curve hits that converge, graze or are ghosts) at depths 0
     and 1 at 1, 1,023 and 2^20 + 3 lanes, then held and timed alone at
     786,432 and 196,608 lanes (ms by events, device_ms replayed from a CUDA
     graph, the plain phase both ways, bound_ms from the bytes a lane must
     move at 3.35 TB/s). Every main path and entry point holds it first at
     its own lanes and instance (hold_surface).

Since the round-cone closed form follows the JAX package's CPU rounding
(XLA's FMA contraction, ops/curves.py:ray_round_cone), K8 is held against
the plain any-hit sweep (its caps tested on the contracted discriminant),
K7 against the plain closest sweep; phase 6's hair_long golden is held to
the 0.99 bar like the others (ROADMAP C.5, closed). Phase 8 also regenerates
the kitchen stage with the port's generator (scene/kitchen_gen.py) into a
temporary directory and renders its golden config from there. Phase 9
item 3 also replays four bands of the card from their own CUDA graphs
(check_band_graphs): 0 values off the eager bands and the unbanded launch,
no crossings, TorchRender(use_sharding=True) with four bands of the card
equal to TorchRender, and eager against replayed ms a launch.

Since the launch cache, K5, K7, K8 and K9 (with and without its order) carry
`device_ms` as K1-K4 and K6 do: their time replayed from a CUDA graph alone.

It exits non-zero without a result where there is no CUDA device or no
strelka_tpu_torch package beside it. It imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

REPO = os.path.dirname(os.path.abspath(__file__))


class Config(NamedTuple):
    """One row of bench.py's config list: a scene at a launch shape."""

    name: str
    width: int
    height: int
    spp: int
    depth: int
    timed_launches: int
    kernels: tuple  # the kernels its main path runs


# main-path configurations (the cornell and box_field rows of bench.py:231-232)
CORNELL = Config("cornell", 512, 512, 4, 4, 16, ("sobol", "intersect_closest", "intersect_any", "gather_rows_t"))
BOX = Config("box_field", 512, 512, 2, 4, 4, ("sobol", "bvh_closest", "bvh_any", "gather_rows_t"))
_HAIR_KERNELS = ("sobol", "intersect_closest", "intersect_any", "gather_rows_t", "cone_closest", "cone_any")
HAIR = Config("hair_patch", 384, 384, 2, 4, 4, _HAIR_KERNELS)  # bench.py:238
HAIR_LONG = Config("hair_long", 384, 384, 2, 4, 2, _HAIR_KERNELS)  # bench.py:239
COFFEE = Config("coffeetable", 512, 512, 2, 4, 8, CORNELL.kernels)  # bench.py:233
KITCHEN = Config("kitchen", 512, 512, 2, 4, 4, BOX.kernels)  # bench.py:237
COFFEE_GOLDEN = (64, 64, 4, 16)  # bench.GOLDEN_CONFIGS["coffeetable"]
KITCHEN_GOLDEN = (64, 64, 2, 8)  # bench.GOLDEN_CONFIGS["kitchen"]
COFFEETABLE_USD = os.path.join("data", "scenes", "coffeetable.usda")
HAIR_CURVES = {"hair_patch": 256, "hair_long": 20000}  # bench.build_host_scene
HAIR_GOLDEN = (64, 64, 4, 16)  # bench.GOLDEN_CONFIGS["hair_patch"]
HAIR_LONG_GOLDEN = (32, 32, 2, 4)  # bench.GOLDEN_CONFIGS["hair_long"]
PLAIN_SUBSET = 1 << 14  # lanes of hair_long held against the plain dense sweep
BOX_GRID = 48  # bench.build_host_scene("box_field"): 411,652 triangles
BOX_TRIANGLES = 411652
FLAT_GRID = 12  # 25,732 triangles: the range of the TPU's _flat/_mxu_flat kernels
MAX_SAMPLE_COUNT = 100000  # as bench.py's render_launch
EXPOSURE = [6.25e-4] * 3  # as bench.py's build_scene
GOLDEN = (64, 64, 4, 4)  # bench.GOLDEN_CONFIGS of both scenes: w, h, spp, launches

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # non-tensor f32
SAMPLE_RAYS = 2048  # live rays of the cone roofline's count (benchmark/bounds.py samples as many)
# Integer work, per pipe: instructions per SM per clock for compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput) x 132 SMs x 1.98 GHz boost clock.
SM_CLOCKS_PER_S = 132 * 1.98e9
PIPE_RATE = {
    "alu": 64,  # 32-bit integer add, logic (LOP3), shift, compare, f32 min/max
    "fma": 64,  # 32-bit integer multiply(-add) (IMAD); f32 multiply at 128 counted as 1/2
    "xu": 16,  # bit reverse, population count, int -> f32 conversion
}

REPLACES = {
    "sobol": ("strelka_tpu/ops/sampler.py:307", "strelka_tpu_torch/csrc/sobol.cu"),
    "intersect_closest": ("strelka_tpu/ops/pallas_intersect.py:2574", "strelka_tpu_torch/csrc/intersect.cu"),
    "intersect_any": ("strelka_tpu/ops/pallas_intersect.py:2642", "strelka_tpu_torch/csrc/intersect.cu"),
    "gather_rows_t": ("strelka_tpu/ops/pallas_gather.py:53", "strelka_tpu_torch/csrc/gather.cu"),
    "bvh_closest": ("strelka_tpu/ops/pallas_intersect.py:2247", "strelka_tpu_torch/csrc/bvh.cu"),
    "bvh_any": ("strelka_tpu/ops/pallas_intersect.py:2322", "strelka_tpu_torch/csrc/bvh.cu"),
    "cone_closest": ("strelka_tpu/ops/curves.py:895", "strelka_tpu_torch/csrc/cones.cu"),
    "cone_any": ("strelka_tpu/ops/curves.py:895", "strelka_tpu_torch/csrc/cones.cu"),
    "open_w": ("strelka_tpu/ops/pallas_intersect.py:1002", "strelka_tpu_torch/csrc/open_w.cu"),
    "shade_bsdf": ("none: the TPU package leaves the BSDF phase to XLA", "strelka_tpu_torch/csrc/shade.cu"),
    "nee_light": ("none: the TPU package leaves the NEE phase to XLA", "strelka_tpu_torch/csrc/nee.cu"),
    "nee_shade": ("none: the TPU package leaves the NEE phase to XLA", "strelka_tpu_torch/csrc/nee.cu"),
    "shade_surface": ("none: the TPU package leaves the surface phase to XLA", "strelka_tpu_torch/csrc/surface.cu"),
}
OPEN_K = 16  # superblocks a tile has swept when the open flag is asked (the reference's CONE_RESIDUAL_K)
K9_TILE = 64  # rays a tile of K9's sweep order (the cone sweeps took its order at this tile until the cone tree)
# what a walking kernel's entry in the kernels line carries beside the numbers of every entry
# what an entry of a kernel's "shapes" carries beside those numbers where its row has it
SHAPE_KEYS = ("dense_bound_ms", "device_ms", "host_us", "schedule", "order_ms", "order_device_ms", "plain_device_ms")
WALK_KEYS = ("nodes_per_ray", "ideal_nodes_per_ray", "primed_nodes_per_ray", "dfs_nodes_per_ray", "stack_depth",
             "registers", "local_bytes")


# (kernel, shape) pairs held against the plain version so far: a main path
# may launch no kernel at a shape that is not in here
HELD = set()


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def held(fn):
    """fn() launches kernels whose results the caller then compares with
    their plain versions (and raises where they differ): note the
    (kernel, shape) pairs it launched."""
    from strelka_tpu_torch import kernels as K

    before = dict(K.launch_shapes)
    out = fn()
    HELD.update(k for k, v in K.launch_shapes.items() if v > before.get(k, 0))
    return out


def ray_bytes(tmin, tmax, exclude, out_bytes: int) -> int:
    """Bytes an intersection kernel must move for its rays: a live lane reads
    origin, direction, tmin, tmax (8 f32) and its exclude id; a dead lane
    (tmax <= tmin) only tmin and tmax; every lane writes its outputs."""
    n = tmin.shape[0]
    live = int((tmax > tmin).sum())
    return live * (8 * 4 + (4 if exclude is not None else 0)) + (n - live) * 8 + n * out_bytes


def time_ms(fn, samples: int = 20, inner: int = 10, warmup: int = 2) -> float:
    """Device time of one fn() call (CUDA events): the median over `samples`
    of the mean of `inner` back-to-back calls. Calls queued back to back keep
    the host's per-call launch overhead off the device timeline."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn, calls: int = 20, samples: int = 10) -> float:
    """Device time of one fn() call alone: `calls` calls captured in a CUDA
    graph and replayed (CUDA events, median over `samples` replays), so that
    the host's time a call does not set it as it can in time_ms."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def sobol_lane_ops(dims: tuple) -> dict:
    """Instructions one K1 lane needs for the dimension list `dims`
    (csrc/sobol.cu), by the pipe that runs them, each in its fewest sm_90
    instructions: the function's count, not the kernel's. A scramble (of
    the index, then one per distinct dimension) is 2 bit reversals, an add,
    4 multiplies by a constant and 4 xors. The fold of dimension 0, whose
    matrix is the identity read backwards, is one bit reversal; every other
    distinct dimension costs one LOP3 a bit, predicated on that bit of
    the index (acc ^ column, the column an immediate). Where such a
    dimension is drawn, the 32 predicates take ceil(32 / 7) R2P, each
    setting seven, shared by every dimension. Each output row is a
    conversion, a multiply by 2^-32 (f32, half an IMAD slot) and a clamp
    (min)."""
    distinct = set(dims)
    folded = len(distinct - {0})
    scrambles = 1 + len(distinct)
    return {
        "alu": scrambles * (1 + 4) + ((-(-32 // 7)) if folded else 0) + 32 * folded + len(dims),
        "fma": scrambles * 4 + len(dims) / 2,
        "xu": scrambles * 2 + (1 if 0 in distinct else 0) + len(dims),
    }


def sobol_bound_s(n: int, dims: tuple) -> float:
    """K1's operation bound: the busiest pipe's instructions over its rate."""
    ops = sobol_lane_ops(dims)
    return max(n * ops[p] / (PIPE_RATE[p] * SM_CLOCKS_PER_S) for p in ops)


def host_us(fn, calls: int = 200) -> float:
    """Host time of one fn() call in microseconds: `calls` calls queued back
    to back with no synchronize between them (the device keeps up at these
    shapes, so the queue never blocks the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def cornell_scene(device):
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.scene import testscenes as TS

    host = TS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True)
    return host, build_device_scene(host, device=device)


def launch_params(host, width: int, height: int, subframe: int = 0):
    import numpy as np

    from strelka_tpu_torch.ops import integrator as I

    cam = host.get_camera(0)
    cam.update_aspect_ratio(width / height)
    return I.LaunchParams(
        subframe_index=subframe,
        clip_to_view=np.asarray(cam.clip_to_view(), np.float32),
        view_to_world=np.asarray(cam.view_to_world(), np.float32),
        exposure=np.asarray(EXPOSURE, np.float32),
        bg_color=np.zeros(3, np.float32),
    )


def main_path_kw(cfg: Config) -> dict:
    """render_launch's keyword arguments on a main path."""
    return dict(width=cfg.width, height=cfg.height, samples_per_launch=cfg.spp,
                max_sample_count=MAX_SAMPLE_COUNT, max_depth=cfg.depth, enable_accumulation=True)


def main_path_rays(scene, params, device, cfg: Config):
    """Sample indices, camera rays, bounce-1 rays, the bounce-0 NEE shadow
    rays, the camera hits' prims, the sampled light ids and (a scene with
    curves) the material ids of the camera rays' curve hits, of the first
    launch of a main path (the shapes the kernels see there), taken as
    trace_paths makes them (a textured scene's lookups included)."""
    import torch

    from strelka_tpu_torch.kernels import surface as KSF
    from strelka_tpu_torch.ops import bsdf as B
    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.ops import light_sampling as LS
    from strelka_tpu_torch.ops import sampler as S
    from strelka_tpu_torch.ops import vec as V
    from strelka_tpu_torch.ops.intersect import intersect_closest, offset_ray_vec
    from strelka_tpu_torch.render.device_scene import ATTR_LIGHT_ROW, ATTR_MAT_ROW, RAY_MASK_PRIMARY

    n = cfg.width * cfg.height
    idx = torch.arange(n, dtype=torch.int64, device=device)
    px, py = (idx % cfg.width).repeat(cfg.spp), (idx // cfg.width).repeat(cfg.spp)
    s_of_ray = torch.arange(cfg.spp, dtype=torch.int64, device=device).repeat_interleave(n)
    sample_idx = S.make_sample_index(px, py, s_of_ray, MAX_SAMPLE_COUNT)
    dims = S.random_dims(sample_idx, 0, (0, 1, 2, 3, 4))  # the depth-0 draw: rows 0 and 1 are the camera jitter
    origin, direction = I.generate_camera_rays(params, px, py, dims[0], dims[1], cfg.width, cfg.height)
    m = sample_idx.shape[0]
    tmin = torch.zeros(m, dtype=torch.float32, device=device)
    tmax = torch.full((m,), 1e16, dtype=torch.float32, device=device)
    hit = intersect_closest(scene, origin, direction, tmin, tmax, RAY_MASK_PRIMARY)
    # bounce 0 shading, as trace_paths does it, to get the bounce-1 rays
    inside = torch.zeros(m, dtype=torch.bool, device=device)
    position, frame, light_id, rows, uv = KSF.gather_surface(scene.attr_table, hit, inside, scene.textures is not None)
    mat = KSF.material_from_rows(rows[ATTR_MAT_ROW:ATTR_LIGHT_ROW])
    if scene.textures is not None:
        mat, frame = I.shade_textures(scene, mat, frame, tuple(rows[ATTR_MAT_ROW + 12:ATTR_MAT_ROW + 20]), uv,
                                      torch.where(hit.prim >= 0, hit.t, 0.0),
                                      I.ray_cone_spread(params, cfg.height), sample_idx,
                                      torch.arange(m, dtype=torch.int32, device=device), 0)
    is_curve = torch.zeros(m, dtype=torch.bool, device=device)
    seg_mat = None
    if scene.has_curves:
        chit = I.closest_curve_hit(scene, origin, direction, tmin, tmax, None)
        is_curve = (chit.seg >= 0) & (chit.t < hit.t)
        position, frame, mat = KSF.curve_surface(scene.curves, scene.mat_table, chit, is_curve, origin, direction,
                                                 inside, position, frame, mat)
        seg_mat = torch.clamp(scene.curves.material_id[torch.clamp(chit.seg, min=0).to(torch.int64)], min=0)
    smp = B.bsdf_sample(mat, frame, -direction, (dims[0], dims[1], dims[2], dims[3]),
                        torch.ones_like(mat.ior), mat.ior, enable_hair=scene.has_curves or scene.has_hair)
    transmission = (smp.event_type & B.BSDF_EVENT_TRANSMISSION) != 0
    org1 = offset_ray_vec(position, V.where(transmission, -frame.geom_normal, frame.geom_normal))
    alive1 = ((hit.prim >= 0) & (light_id < 0) | is_curve) & (smp.event_type != B.BSDF_EVENT_ABSORB)
    exclude1 = torch.where(is_curve, -1, hit.prim)  # a curve hit excludes no triangle
    camera = dict(o=origin, d=direction, tmin=tmin, tmax=tmax, exclude=torch.full_like(hit.prim, -1))
    bounce1 = dict(o=org1, d=smp.k2, tmin=tmin, tmax=torch.where(alive1, 1e16, 0.0), exclude=exclude1)
    # bounce-0 next-event rays (trace_paths' NEE block, uniform rect sampling)
    nee_able = alive1 & ((smp.event_type & (B.BSDF_EVENT_DIFFUSE | B.BSDF_EVENT_GLOSSY)) != 0)
    lid = torch.clamp((scene.num_lights * dims[int(S.SampleDimension.eLightId) % 5]).to(torch.int32), 0,
                      scene.num_lights - 1)
    lp = LS.gather_light(scene.light_table, lid)
    ls = LS.sample_light(lp, dims[int(S.SampleDimension.eLightPointX) % 5],
                         dims[int(S.SampleDimension.eLightPointY) % 5], position, 0)
    geom_ok = (V.dot(frame.normal, ls.L) > 0.0) & (-V.dot(ls.L, ls.normal) > 0.0) & V.all_nonzero(lp.color)
    shadow = dict(o=offset_ray_vec(position, frame.geom_normal), d=ls.L, tmin=tmin,
                  tmax=torch.where(nee_able & geom_ok, ls.dist_to_light, 0.0), exclude=exclude1)
    return sample_idx, camera, bounce1, shadow, hit.prim, lid, seg_mat


def _contig(rays):
    return tuple(c.contiguous() for c in rays["o"]), tuple(c.contiguous() for c in rays["d"])


def flat_args(scene, rays, ray_mask):
    """K2/K3's arguments for one ray set against a scene's triangle arrays."""
    o, d = _contig(rays)
    return (o, d, rays["tmin"].contiguous(), rays["tmax"].contiguous(), rays["exclude"].contiguous(), scene.v0,
            scene.e1, scene.e2, scene.geom_mask, ray_mask)


def bvh_args(scene, rays, ray_mask):
    """K5/K6's arguments: K2/K3's with the tree before the triangles."""
    a = flat_args(scene, rays, ray_mask)
    return a[:5] + (scene.bvh,) + a[5:]


def timed_once_ms(fn):
    """Host-clock time of one call that ends in a synchronize (for the plain
    versions above 1024 triangles, which take seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def closest_mismatch(t_a, p_a, t_b, p_b):
    """Lanes where two closest-hit results disagree beyond the tie rule:
    hit/miss differs, or both hit other prims with |dt| > 1e-5 t (a tie is
    two prims at the same distance: a shared edge, coplanar faces). Returns
    (bad lanes, tie lanes, max relative t difference over lanes where both hit)."""
    import torch

    both = (p_a >= 0) & (p_b >= 0)
    rel = torch.where(both, torch.abs(t_a - t_b) / torch.abs(t_b), 0.0)
    differ = p_a != p_b
    tie = both & (rel <= 1e-5)
    agree = both & (~differ | tie)
    max_rel = float(rel[agree].max()) if bool(agree.any()) else 0.0
    return int((differ & ~tie).sum()), int((differ & tie).sum()), max_rel


def same_bits(a, b):
    """Lanes where two f32 tensors differ in any bit."""
    import torch

    return a.view(torch.int32) != b.view(torch.int32)


def closest_lanes(a, b):
    """Lanes where two K2 results (t, prim, u, v, ...) differ: prim, or t, u or v in any bit."""
    return (a[1] != b[1]) | same_bits(a[0], b[0]) | same_bits(a[2], b[2]) | same_bits(a[3], b[3])


def closest_off(a, b) -> int:
    """How many lanes two K2 results differ on (closest_lanes)."""
    return int(closest_lanes(a, b).sum())


def outside_domain(args, dense_prim):
    """Lanes of one ray set (K2/K3's arguments) whose hits lie outside the
    box test's margin's domain (ops/slab.py:NU_MIN, PERF.md section 6): for
    the closest hit, the dense winner's (dense_prim: K2's dense plain
    version or cull=False) normalised determinant is below NU_MIN; for
    occlusion, the ray has hits and every one's is. Only a lane whose winner
    lies outside can have no hit inside, so those lanes alone are tested
    against every triangle, a few at a time (box_field has 411,776).
    Returns (closest lanes, occlusion lanes), [R] bool each."""
    import torch

    from strelka_tpu_torch.kernels import intersect as KI
    from strelka_tpu_torch.ops import slab

    o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask = args
    p = dense_prim.clamp(min=0).long()
    closest = (dense_prim >= 0) & (slab.normalised_det(d, e1[p], e2[p], paired=True) < slab.NU_MIN)
    occlusion = torch.zeros_like(closest)
    suspect = torch.nonzero(closest)[:, 0]
    step = max(1, (1 << 24) // v0.shape[0])
    for k in range(0, suspect.shape[0], step):
        lanes = suspect[k:k + step]
        so, sd = tuple(c[lanes] for c in o), tuple(c[lanes] for c in d)
        hit = KI._valid(KI.mt_block(so, sd, v0, e1, e2, tmin[lanes], tmax[lanes])[3], mask, ray_mask, 0,
                        None if exclude is None else exclude[lanes])
        inside = (hit & (slab.normalised_det(sd, e1, e2) >= slab.NU_MIN)).any(dim=1)
        occlusion[lanes] = hit.any(dim=1) & ~inside
    return closest, occlusion


def domain_note(lanes, outside, what: str) -> str:
    """The log's words for the lanes outside the margin's domain: how many,
    and on how many of them `lanes` (a comparison with a dense version) differs."""
    return f"{what} {int(outside.sum())} outside the margin's domain, {int((lanes & outside).sum())} of them off"


def check_intersect(scene, rays, ray_mask, name, domain: bool = False):
    """K2 and K3 on one ray set of a flat scene, culled by the scene's group
    boxes (one ray a warp, as the main path runs them), against the dense
    plain versions, their own cull=False mode and the one-ray-a-thread
    schedule on every lane: prim and occlusion equal, t, u, v bit for bit.
    Their per-ray counts of groups tested must equal the plain copies of
    their walks (kernels/intersect.py:closest_walk_plain, any_walk_plain),
    whose results must equal the dense ones too. With `domain`, the
    comparisons with the dense versions hold on every lane inside the
    margin's domain (outside_domain), and the lanes outside it are counted
    and printed with how many of them differ; the other comparisons still
    hold on every lane. Returns a dict: args, K2's
    (t, prim, u, v, groups), K3's (occluded, groups), the plain K3 walk's
    (occluded, groups, triangles, groups touched), the dense plain versions'
    times (one call each) and K2's largest absolute difference in t, u or v
    against the dense plain version."""
    import torch

    from strelka_tpu_torch.kernels import intersect as KI

    args = flat_args(scene, rays, ray_mask)
    kw = dict(bounds=scene.tri_bounds)
    k2 = held(lambda: KI.intersect_closest(*args, **kw, stats=True))
    dense2, closest_plain_ms = timed_once_ms(lambda: KI.closest_plain(*args))
    walk2 = KI.closest_walk_plain(*args, scene.tri_bounds)
    k3 = held(lambda: KI.intersect_any(*args, **kw, stats=True))
    dense3, any_plain_ms = timed_once_ms(lambda: KI.any_plain(*args))
    walk3 = KI.any_walk_plain(*args, scene.tri_bounds)
    all3 = KI.intersect_any(*args, cull=False)
    out2, out3 = outside_domain(args, dense2[1]) if domain else (torch.zeros_like(dense3),) * 2
    held2 = lambda lanes: int((lanes & ~out2).sum())  # noqa: E731
    held3 = lambda lanes: int((lanes & ~out3).sum())  # noqa: E731
    off2 = dict(plain=held2(closest_lanes(k2, dense2)),
                cull_false=held2(closest_lanes(k2, KI.intersect_closest(*args, cull=False))),
                thread=closest_off(k2, KI.intersect_closest(*args, **kw, schedule="thread")),
                walk=held2(closest_lanes(walk2, dense2)), count=int((k2[4] != walk2[4]).sum()))
    off3 = dict(plain=held3(k3[0] != dense3), cull_false=held3(k3[0] != all3),
                thread=int((k3[0] != KI.intersect_any(*args, **kw, schedule="thread")).sum()),
                walk=held3(walk3[0] != dense3), count=int((k3[1] != walk3[1]).sum()))
    outside = ""
    if domain:
        outside = (f"; lanes {domain_note(closest_lanes(k2, dense2), out2, 'K2')}, "
                   f"{domain_note(k3[0] != dense3, out3, 'K3')} (held inside the domain only)")
    o, d, tmin, tmax = args[:4]
    live = max(int((tmax > tmin).sum()), 1)
    entered = KI.groups_entered(o, d, tmin, tmax, scene.geom_mask, ray_mask, scene.tri_bounds)[0]
    needed = KI.groups_entered(o, d, tmin, torch.minimum(k2[0], tmax), scene.geom_mask, ray_mask,
                               scene.tri_bounds)[0]
    ng = scene.tri_bounds.shape[1]
    log(f"K2/K3 on {name} rays ({tmin.shape[0]} x {scene.v0.shape[0]} triangles in {ng} groups, {live} live): "
        f"{int((k2[1] >= 0).sum())} hits, {int(k3[0].sum())} occluded; lanes off the dense plain version "
        f"{off2['plain']} / {off3['plain']}, off cull=False {off2['cull_false']} / {off3['cull_false']}, off one ray a "
        f"thread {off2['thread']} / {off3['thread']}; the plain walks off the dense version {off2['walk']} / "
        f"{off3['walk']}, groups tested off the plain walks' count {off2['count']} / {off3['count']} (bar: 0 "
        f"everywhere, t, u, v bit for bit); a live ray's interval enters {float(entered.sum()) / live:.2f} groups, "
        f"K2 tests {float(k2[4].sum()) / live:.2f} (its final interval enters {float(needed.sum()) / live:.2f}), "
        f"K3 tests {float(k3[1].sum()) / live:.2f} (ascending up to its first hit){outside}")
    if any(off2.values()) or any(off3.values()):
        raise AssertionError(f"K2 or K3 on {name} rays: lanes off {off2} / {off3}")
    max_abs = max(float(torch.abs(k2[k] - dense2[k]).max()) for k in (0, 2, 3))  # t, u, v
    return dict(args=args, closest=k2, any=k3, walk_any=walk3, plain_ms=(closest_plain_ms, any_plain_ms),
                max_abs_err=max_abs)


def tests_needed(args, any_hit: bool) -> int:
    """Ray-triangle tests these rays need: for each live ray, the triangles
    whose geometry mask matches the ray mask and that are not the ray's own
    prim; for any-hit only those up to its first occluder (K3 exits there)."""
    import torch

    from strelka_tpu_torch.kernels import intersect as KI

    o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask = args
    ntri = v0.shape[0]
    ids = torch.arange(ntri, device=v0.device)
    match = (mask & ray_mask) != 0
    if not any_hit:
        live = tmax > tmin
        own = live & (exclude >= 0) & match[torch.clamp(exclude, min=0).to(torch.int64)]
        return int(live.sum()) * int(match.sum()) - int(own.sum())
    total = 0
    chunk = max(1024, min(65536, (1 << 26) // ntri))  # [chunk, ntri] temporaries of at most 256 MB
    for r0 in range(0, tmin.shape[0], chunk):
        rs = slice(r0, r0 + chunk)
        live = tmax[rs] > tmin[rs]
        candidate = match[None, :] & (ids[None, :] != exclude[rs, None])
        oc, dc = [c[rs] for c in o], [c[rs] for c in d]
        _, _, _, hit = KI.mt_block(oc, dc, v0, e1, e2, tmin[rs], tmax[rs])
        hit = KI._valid(hit, mask, ray_mask, 0, exclude[rs])
        first = torch.where(hit, ids[None, :], ntri).min(dim=1).values
        candidate = candidate & (ids[None, :] <= first[:, None])
        total += int((candidate & live[:, None]).sum())
    return total


def intersect_rows(scene, closest, anys, where: str):
    """K2's row on one ray set (`closest`, a check_intersect result) and K3's
    on each of `anys` ((result, label) pairs), timed as the main path runs
    them (one ray a warp, culled) and with one ray a thread (`thread_ms`).
    bound_ms counts what these rays need of the culled sweep: per live ray
    the slab tests of all G group boxes (SLAB_FLOPS each) and MT_FLOPS for
    every triangle whose mask matches in the groups its final interval
    [tmin, min(t, tmax)] enters (K2), or in the groups an ascending walk
    tests up to and including its first hit (K3, kernels/intersect.py:
    any_walk_plain); bytes: the rays as `ray_bytes` does, the box table once
    and the triangles (40 bytes) of every group some ray needs. dense_bound_ms
    is the dense sweep's count: every mask-matching triangle that is not
    the ray's own prim (K3: up to the first occluder in id order)."""
    import torch

    from strelka_tpu_torch.kernels import intersect as KI
    from strelka_tpu_torch.ops.bvh import SLAB_FLOPS

    ng = scene.tri_bounds.shape[1]
    rows = []
    for kernel, chk, label in (("intersect_closest", closest, "bounce-1"), *(("intersect_any", c, l) for c, l in anys)):
        args = chk["args"]
        o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask = args
        n, ntri = tmin.shape[0], v0.shape[0]
        live = max(int((tmax > tmin).sum()), 1)
        kw = dict(bounds=scene.tri_bounds)
        if kernel == "intersect_closest":
            fn, out_bytes, tested = KI.intersect_closest, 16, chk["closest"][4]
            need, tris, touched = KI.groups_entered(o, d, tmin, torch.minimum(chk["closest"][0], tmax), mask, ray_mask,
                                                    scene.tri_bounds)
            plain_ms = chk["plain_ms"][0]
        else:
            fn, out_bytes, tested = KI.intersect_any, 1, chk["any"][1]
            _, need, tris, touched = chk["walk_any"]
            plain_ms = chk["plain_ms"][1]
        dense_bytes = ray_bytes(tmin, tmax, exclude, out_bytes) + ntri * 40
        dense_ops_s = tests_needed(args, any_hit=kernel == "intersect_any") * KI.MT_FLOPS / F32_OPS_PER_S
        row = dict(
            kernel=kernel, at=f"{where}, {label} rays", shape=(n, ntri), schedule=KI.pick_schedule(ntri, False),
            ms=time_ms(lambda: fn(*args, **kw)), device_ms=graph_ms(lambda: fn(*args, **kw)),
            warp_ms=time_ms(lambda: fn(*args, **kw, schedule="warp")),
            thread_ms=time_ms(lambda: fn(*args, **kw, schedule="thread")),
            warp_device_ms=graph_ms(lambda: fn(*args, **kw, schedule="warp")),
            thread_device_ms=graph_ms(lambda: fn(*args, **kw, schedule="thread")),
            plain_ms=plain_ms,
            bound_bytes=ray_bytes(tmin, tmax, exclude, out_bytes) + ng * 24 + int(touched.sum()) * KI.GROUP * 40,
            bound_ops_s=(live * ng * SLAB_FLOPS + int(tris.sum()) * KI.MT_FLOPS) / F32_OPS_PER_S,
            dense_bound_ms=max(dense_bytes / HBM_BYTES_PER_S, dense_ops_s) * 1e3,
            max_abs_err=chk["max_abs_err"] if kernel == "intersect_closest" else 0.0, library_ms=None,
            live_rays=live, groups=ng, groups_per_ray=float(tested.sum()) / live,
            needed_groups_per_ray=float(need.sum()) / live, needed_tris_per_ray=float(tris.sum()) / live,
            groups_touched=int(touched.sum()),
        )
        log(f"{kernel} on {row['at']}: {row['ms']:.4f} ms, {row['device_ms']:.4f} ms on the device alone (one ray a "
            f"{row['schedule']}; one ray a warp {row['warp_ms']:.4f} / {row['warp_device_ms']:.4f}, one ray a thread "
            f"{row['thread_ms']:.4f} / {row['thread_device_ms']:.4f}); a live ray "
            f"tests {row['groups_per_ray']:.2f} of {ng} groups and needs {row['needed_groups_per_ray']:.2f} "
            f"({row['needed_tris_per_ray']:.1f} triangles whose mask matches); {row['groups_touched']} groups touched")
        rows.append(row)
    return rows


# BOUNCE_DIMS: the list render_launch asks K1 for at every depth (depth 0's rows 0 and 1 are the camera
# jitter); JITTER_DIMS: the jitter's two dimensions drawn alone (K1's instance for the set {0, 1})
JITTER_DIMS, BOUNCE_DIMS = (0, 1), (0, 1, 2, 3, 4)


def sobol_rows(sample_idx, cfg: Config, where: str):
    """K1 against its plain version, bit for bit, at a bounce's 5
    dimensions at every depth (the draw of a launch: depth 0's rows 0 and 1
    are its camera jitter) and at the jitter's 2 dimensions alone (depth
    0); both timed: events, the device alone, the wrapper's host time."""
    import torch

    from strelka_tpu_torch.kernels import sobol as KS

    n = sample_idx.shape[0]
    for dims, depths in ((JITTER_DIMS, (0,)), (BOUNCE_DIMS, range(cfg.depth))):
        for depth in depths:
            a = held(lambda: KS.random_dims(sample_idx, depth, dims))
            b = KS.random_dims_plain(sample_idx, depth, dims)
            torch.cuda.synchronize()
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"K1 differs from its plain version at depth {depth}, dims {dims} ({where})")
    log(f"K1 bit-equal (tolerance: none) on {n} sample indices of {where}: {len(BOUNCE_DIMS)} dimensions at depths "
        f"0..{cfg.depth - 1}, {len(JITTER_DIMS)} at depth 0")
    return [dict(
        kernel="sobol", at=f"{where}, {len(dims)} dimensions", shape=(n, len(dims)),
        ms=time_ms(lambda: KS.random_dims(sample_idx, depth, dims)),
        device_ms=graph_ms(lambda: KS.random_dims(sample_idx, depth, dims)),
        host_us=host_us(lambda: KS.random_dims(sample_idx, depth, dims)),
        plain_ms=time_ms(lambda: KS.random_dims_plain(sample_idx, depth, dims), samples=5, inner=2),
        bound_bytes=n * 8 + len(dims) * n * 4, bound_ops_s=sobol_bound_s(n, dims),
        max_abs_err=0.0, library_ms=None,
    ) for dims, depth in ((BOUNCE_DIMS, 1), (JITTER_DIMS, 0))]


def sobol_lists():
    """Dimension lists that reach every instance of K1 (one per non-empty
    set of dimensions): each set ascending, descending, and with its first
    dimension drawn again (up to 5 rows)."""
    lists = []
    for s in range(1, 32):
        dims = tuple(d for d in range(5) if s >> d & 1)
        lists += [dims, dims[::-1]] + ([dims + dims[:1]] if len(dims) < 5 else [])
    return lists


def check_sobol_lists(dev):
    """K1 bit for bit against its plain version at every list of
    sobol_lists() on 4,099 sample indices (a partial last block) at depths
    0 and 3: every instance of the kernel, unordered and repeated
    dimensions included."""
    import numpy as np
    import torch

    from strelka_tpu_torch.kernels import sobol as KS

    idx = torch.tensor(np.random.default_rng(9).integers(0, 2 ** 32, 4099), dtype=torch.int64, device=dev)
    lists = sobol_lists()
    for dims in lists:
        for depth in (0, 3):
            a = KS.random_dims(idx, depth, dims)
            b = KS.random_dims_plain(idx, depth, dims)
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"K1 differs from its plain version at dims {dims}, depth {depth}")
    log(f"K1 bit-equal (tolerance: none) at {len(lists)} dimension lists reaching all 31 instances, 4,099 indices, "
        f"depths 0 and 3")


SASS_KIND = {  # sm_90 opcode -> the pipe sobol_lane_ops counts it on (others: "other")
    "LOP3": "alu", "SHF": "alu", "IADD3": "alu", "ISETP": "alu", "SEL": "alu", "LEA": "alu", "FMNMX": "alu",
    "IMNMX": "alu", "PLOP3": "alu", "MOV": "alu", "VIADD": "alu", "R2P": "alu", "IMAD": "fma", "FMUL": "fma",
    "BREV": "xu", "I2F": "xu", "I2FP": "xu",
    "LDC": "ldc", "ULDC": "ldc", "LDG": "mem", "STG": "mem",
}


def sobol_sass():
    """K1's instruction mix from `cuobjdump -sass` of the built object, for
    the instances of the main path's list (dimensions 0-4: set 31) and of
    the jitter's alone (0 and 1: set 3): a lane issues each instruction once
    (no loop is left). Fails if
    an LDC reads a __constant__ array (a bank other than the parameters'
    c[0x0]) or any constant word through a register index: the fold's
    columns are immediates. Returns {set: {"ops": opcode counts, "kinds":
    counts by pipe, "ldc": LDC operands}}."""
    import collections
    import re
    import shutil

    from strelka_tpu_torch.kernels import build

    obj = os.path.join(build.BUILD_ROOT, build._digest(), "sobol.o")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", obj], stdout=subprocess.PIPE, text=True, check=True, timeout=120).stdout
    insn = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)\s*([^;]*);")
    out = {}
    for m in re.finditer(r"Function : (\S+)(.*?)(?=Function :|\Z)", sass, re.S):
        inst = re.search(r"random_dims_kernelILj(\d+)E", m.group(1))
        if not inst or int(inst.group(1)) not in (3, 31):
            continue
        ops, ldc, pred_lop3 = collections.Counter(), [], 0
        for addr, pred, op, args in insn.findall(m.group(2)):
            base = op.split(".")[0]
            if base == "NOP" or (base == "BRA" and args.strip() == f"0x{addr.lstrip('0')}"):
                continue  # the end's padding
            ops[base] += 1
            pred_lop3 += base == "LOP3" and bool(pred)
            if base in ("LDC", "ULDC"):
                ldc.append(args.split(",")[-1].strip())
        kinds = collections.Counter(SASS_KIND.get(op, "other") for op in ops.elements())
        bad = [a for a in ldc if not a.startswith("c[0x0]") or re.search(r"\[U?R\d+", a.split("]", 1)[1])]
        out[int(inst.group(1))] = dict(ops=dict(ops), kinds=dict(kinds), ldc=ldc, predicated_lop3=pred_lop3)
        log(f"K1 SASS, instance {inst.group(1)} ({'dimensions 0-4' if inst.group(1) == '31' else 'dimensions 0, 1'}): "
            f"{sum(ops.values())} instructions a lane, by pipe {dict(kinds)}, {pred_lop3} predicated LOP3, "
            f"LDC/ULDC operands {ldc}; by opcode {dict(ops)}")
        if bad:
            raise AssertionError(f"K1 instance {inst.group(1)} loads constant memory in its fold: {bad}")
    if sorted(out) != [3, 31]:
        raise AssertionError(f"K1's instances 3 and 31 are not in {obj}: found {sorted(out)}")
    return out


def twice_over(scene):
    """A flat scene's triangle table twice over, the second copy rolled by
    half a group, with its group boxes: every hit has a twin at equal t and
    a higher id, in a group of other triangles and another box."""
    import types

    import torch

    from strelka_tpu_torch.kernels import intersect as KI

    tables = [torch.cat([a, a.roll(KI.GROUP // 2, 0)]).contiguous()
              for a in (scene.v0, scene.e1, scene.e2, scene.geom_mask)]
    bounds = KI.tri_group_bounds(*(a.cpu().numpy() for a in tables))
    return types.SimpleNamespace(v0=tables[0], e1=tables[1], e2=tables[2], geom_mask=tables[3],
                                 tri_bounds=torch.tensor(bounds, device=scene.device))


# scene/grazing.py:plane_case arguments (seed, scale, offset, nx, nz, overlap, least sine of the rays' angle
# to the plane): coplanar grids turned, scaled and moved, rays at their vertices, edges and overlaps
PLANE_CASES = [(11, 1.0, 0.0, 12, 12, True, 1e-3), (12, 0.01, 3.0, 8, 12, True, 1e-4),
               (13, 300.0, 1000.0, 12, 8, False, 1e-3), (14, 40.0, 20.0, 16, 16, True, 0.085)]


def grazing_scene(tris, dev):
    """A flat scene-like table of numpy triangles (v0, e1, e2, mask) on the
    card, with its group boxes and, on `bvh`, the same triangles on a BVH
    in its leaf order (and the permutation, to map exclude ids)."""
    import types

    import numpy as np
    import torch

    from strelka_tpu_torch.kernels import intersect as KI
    from strelka_tpu_torch.ops.bvh import build_threaded, device_bvh

    t = lambda a: torch.tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    flat = types.SimpleNamespace(v0=t(tris[0]), e1=t(tris[1]), e2=t(tris[2]), geom_mask=t(tris[3]),
                                 tri_bounds=t(KI.tri_group_bounds(*tris)), device=dev)
    threaded, perm, _ = build_threaded(*tris[:3])
    leaf = [t(a[perm]) for a in tris]
    tree = types.SimpleNamespace(v0=leaf[0], e1=leaf[1], e2=leaf[2], geom_mask=leaf[3],
                                 bvh=device_bvh(threaded, dev), device=dev)
    return flat, tree, perm


def grazing_rays(rays, dev, perm=None):
    """numpy (o, d, tmin, tmax, exclude) -> a ray set on the card (exclude
    ids mapped to a BVH's leaf order by `perm`)."""
    import numpy as np
    import torch

    o, d, tmin, tmax, exclude = rays
    if perm is not None:
        inv = np.argsort(perm)
        exclude = np.where(exclude >= 0, inv[np.clip(exclude, 0, len(perm) - 1)], -1).astype(np.int32)
    t = lambda a: torch.tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731
    return dict(o=tuple(t(o[:, k]) for k in range(3)), d=tuple(t(d[:, k]) for k in range(3)), tmin=t(tmin),
                tmax=t(tmax), exclude=t(exclude))


def phase_grazing(dev):
    """The box tests' rounding edge on the card (scene/grazing.py): the
    grazing soup (rays at the shared vertices and edges of a coplanar grid
    and at coplanar overlaps) and the coplanar grids of PLANE_CASES, through
    K2/K3 as check_intersect holds them (0 lanes off the other schedule
    and the plain walks; 0 lanes off the dense versions and cull=False
    inside the margin's domain) and through K5 and K6 on a BVH of the same
    triangles (check_k5: 0 lanes off its plain version; 0 off the dense
    sweep inside the domain; K6: 0 lanes off its plain twin, 0 off K3
    cull=False inside the domain). PLANE_CASES aim rays down to a sine of 1e-4
    to the plane, past the domain (a normalised determinant of
    ops/slab.py:NU_MIN): the lanes whose hits lie outside it are counted
    and printed with how many of them differ, and are not held."""
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW
    from strelka_tpu_torch.scene import grazing as G

    cases = [("grazing soup", G.soup_case("grazing", 2))]
    cases += [(f"plane case {k}", G.plane_case(*c, n=8192)) for k, c in enumerate(PLANE_CASES)]
    for name, (tris, rays) in cases:
        flat, tree, perm = grazing_scene(tris, dev)
        masks = ((RAY_MASK_PRIMARY, "primary"), (RAY_MASK_SHADOW, "shadow")) if name == "grazing soup" else (
            (RAY_MASK_PRIMARY, "primary"),)  # the planes' triangles all have mask 1: both masks take the same
        for mask, label in masks:
            check_intersect(flat, grazing_rays(rays, dev), mask, f"{name}, {label} mask", domain=True)
            check_k5(tree, grazing_rays(rays, dev, perm), mask, f"{name}, {label} mask", domain=True)
            check_bvh_vs_plain(tree, grazing_rays(rays, dev, perm), mask, f"{name}, {label} mask")
            check_bvh_vs_bruteforce(tree, grazing_rays(rays, dev, perm), mask, f"{name}, {label} mask", flat=flat,
                                    flat_rays=grazing_rays(rays, dev))


def phase_kernels(scene, params):
    import torch

    from strelka_tpu_torch.ops import sampler as S
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW

    dev = scene.device
    sample_idx, camera, bounce1, shadow, prims, _, _ = main_path_rays(scene, params, dev, CORNELL)
    where = "cornell 2^20 lanes x 640 triangles"

    # ---- K1: both lists of a launch, every depth of the main path, bit-equal; every instance; its SASS
    rows = sobol_rows(sample_idx, CORNELL, "cornell")
    check_sobol_lists(dev)
    sass = sobol_sass()
    for r in rows:
        r["sass_kinds"] = sass[31 if r["shape"][1] == 5 else 3]["kinds"]

    # ---- K2 / K3: camera, bounce-1 and the bounce-0 NEE shadow rays (2^20 each)
    check_intersect(scene, camera, RAY_MASK_PRIMARY, "camera")
    b1 = check_intersect(scene, bounce1, RAY_MASK_PRIMARY, "bounce-1")
    nee = check_intersect(scene, shadow, RAY_MASK_SHADOW, "NEE shadow")
    # shadow-style any-hit set (the dense K3's row): bounce-1 rays cut to a
    # hashed fraction in [0, 1.5) of their hit distance, so that some are
    # occluded and some not
    frac = S.uniform_hash(sample_idx, 7) * 1.5
    t_b1 = b1["closest"][0]
    style = dict(bounce1, tmax=torch.where(bounce1["tmax"] > 0, torch.clamp(t_b1, max=1e3) * frac, 0.0))
    sh = check_intersect(scene, style, RAY_MASK_SHADOW, "shadow-style")
    # ties: the table twice over, the second copy rolled by half a group, so that
    # every hit is two triangles at equal t in groups with other boxes; the
    # walk may meet the copy first, and the lower id must win (camera rays:
    # they exclude no prim, which the copy would not share)
    check_intersect(twice_over(scene), camera, RAY_MASK_PRIMARY, "Cornell twice over, camera")
    ntri = scene.v0.shape[0]
    log(f"of {ntri} triangles {int(((scene.geom_mask & RAY_MASK_PRIMARY) != 0).sum())} match the primary ray mask, "
        f"{int(((scene.geom_mask & RAY_MASK_SHADOW) != 0).sum())} the shadow mask")
    rows += intersect_rows(scene, b1, ((nee, "NEE shadow"), (sh, "shadow-style")), where)

    # ---- K4: the attr table at the camera hits (2^20 indices), bit-equal
    rows.append(gather_row(scene.attr_table, prims, "cornell attr_table at the camera hits"))
    check_gather_edges(dev)

    # ---- K2/K3 (and K5) at the box tests' rounding edge
    phase_grazing(dev)
    return rows


def gather_row(table, prims, where: str):
    """K4 against its plain version at one table and index set, timed (ms
    back to back, device_ms replayed from a CUDA graph: at the small shapes
    the wrapper's host time sets ms; zeros_ms, from a CUDA graph too, is
    PyTorch writing zeros over an output of the same shape: the stores
    alone, a floor for a copy that must make them). Its bound counts the
    table rows these indices name, not the whole table."""
    import torch

    from strelka_tpu_torch.kernels import gather as KG

    n = prims.shape[0]
    gidx = torch.clamp(prims, min=0).contiguous()
    a = held(lambda: KG.gather_rows_t(table, gidx))
    b = KG.gather_rows_t_plain(table, gidx)
    torch.cuda.synchronize()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError("K4 differs from its plain version")
    rows_named = int(torch.unique(gidx).numel())
    log(f"K4 bit-equal (tolerance: none) on {where}: table {tuple(table.shape)} x {n} indices naming "
        f"{rows_named} rows")
    gidx64 = gidx.to(torch.int64)
    zeros = torch.empty((table.shape[1], n), dtype=torch.float32, device=table.device)
    return dict(
        kernel="gather_rows_t", at=where, shape=(table.shape[0], table.shape[1], n),
        ms=time_ms(lambda: KG.gather_rows_t(table, gidx)),
        device_ms=graph_ms(lambda: KG.gather_rows_t(table, gidx)),
        zeros_ms=graph_ms(lambda: zeros.zero_()),
        plain_ms=time_ms(lambda: KG.gather_rows_t_plain(table, gidx)),
        bound_bytes=n * 4 + rows_named * table.shape[1] * 4 + n * table.shape[1] * 4,
        bound_ops_s=0.0,
        max_abs_err=0.0,
        library_ms=time_ms(lambda: torch.index_select(table, 0, gidx64).t().contiguous()),
    )


def check_gather_edges(dev):
    """K4 bit for bit against its plain version at kernels/gather.py:
    GATHER_EDGES: each word
    path of the table's rows and of the output, the last block's ragged
    edge, streaming stores beside one-word stores; indices out of range on
    both sides (clipped)."""
    import numpy as np
    import torch

    from strelka_tpu_torch.kernels import gather as KG

    rows = 300
    for cols, n, offset in KG.GATHER_EDGES:
        rng = np.random.default_rng(cols * 7 + n % 97 + offset)
        buf = torch.tensor(rng.normal(size=offset + rows * cols).astype(np.float32), device=dev)
        table = buf[offset:].view(rows, cols)
        idx = torch.tensor(rng.integers(-3, rows + 3, n).astype(np.int32), device=dev)
        a = held(lambda: KG.gather_rows_t(table, idx))
        b = KG.gather_rows_t_plain(table, idx)
        torch.cuda.synchronize()
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"K4 differs from its plain version at width {cols}, N {n}, offset {offset}")
    log(f"K4 bit-equal (tolerance: none) at the edge shapes (width, N, table offset in words) {KG.GATHER_EDGES}")


def finish_bounds(rows):
    for r in rows:
        if (r["kernel"], tuple(r["shape"])) not in HELD:
            raise AssertionError(f"{r['kernel']} was timed at {r['shape']} but not held against its plain version")
        bytes_s = r["bound_bytes"] / HBM_BYTES_PER_S
        r["bound_ms"] = max(bytes_s, r["bound_ops_s"]) * 1e3
        r["bound_by"] = "bytes" if bytes_s >= r["bound_ops_s"] else "operations"


def golden_render(host, device, use_bvh=None, config=GOLDEN):
    """A golden config (w, h, spp, launches) through TorchRender -> [H, W, 3] in [0, 1]."""
    import numpy as np

    from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu_torch.render.render import RenderFactory, RenderType
    from strelka_tpu_torch.settings import SharedContext, make_default_settings

    w, h, spp, launches = config
    s = make_default_settings(w, h)
    s.set("render/pt/sppTotal", spp * launches)
    s.set("render/pt/spp", spp)
    r = RenderFactory.create_render(RenderType.eTorch, device=device)
    r.use_bvh = use_bvh
    r.set_scene(host)
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(w, h, BufferFormat.FLOAT4))
    for _ in range(launches):
        r.render(buf)
    img = buf.map()[..., :3]
    if not np.isfinite(img).all():
        raise AssertionError("golden-config render has non-finite pixels")
    return np.clip(img, 0.0, 1.0)


def phase_golden(host, device, golden_png: str, kernels: tuple, config=GOLDEN) -> float:
    """Golden-config render on the card: SSIM >= 0.99 against the golden,
    every kernel of the path launched, no plain version run on CUDA."""
    from strelka_tpu_torch import kernels as K
    from strelka_tpu_torch.utils.image import read_png, ssim

    K.reset_counts()
    img = golden_render(host, device, config=config)
    counts = dict(K.launch_counts)
    golden = read_png(os.path.join(REPO, "goldens", golden_png))[..., :3]
    s = float(ssim(img, golden))
    log(f"golden config {config}: SSIM vs goldens/{golden_png} = {s:.6f}; launches {counts}")
    if s < 0.99:
        raise AssertionError(f"SSIM {s} < 0.99 against goldens/{golden_png}")
    if not all(counts[k] for k in kernels) or any(K.plain_cuda_calls.values()):
        raise AssertionError(f"the golden-config render did not run {kernels} on the card: {counts}, "
                             f"plain versions on CUDA {dict(K.plain_cuda_calls)}")
    return s


def phase_main_path(scene, host, cfg: Config):
    import numpy as np
    import torch

    from strelka_tpu_torch import kernels as K
    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.utils import profiling as P

    dev = scene.device
    kw = main_path_kw(cfg)
    w, h = cfg.width, cfg.height
    hold_surface(dev, w * h * cfg.spp, scene, cfg.name)
    hold_shade(dev, w * h * cfg.spp, scene, cfg.name)
    hold_nee(dev, w * h * cfg.spp, scene, cfg.name)
    state = I.make_frame_state(h, w, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    state, image = I.render_launch(scene, launch_params(host, w, h, 0), state, **kw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(cfg.timed_launches):
        state, image = I.render_launch(scene, launch_params(host, w, h, (i + 1) * cfg.spp), state, **kw)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / cfg.timed_launches
    counts = dict(K.launch_counts)
    shapes = dict(K.launch_shapes)
    plain = dict(K.plain_cuda_calls)
    launches = 1 + cfg.timed_launches
    unheld = sorted(k for k in shapes if k not in HELD)
    if unheld:
        raise AssertionError(f"the {cfg.name} main path launched kernels at shapes that were not held against "
                             f"their plain versions: {unheld}")
    for name in cfg.kernels:
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the {cfg.name} main path")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on CUDA on the {cfg.name} main path: {plain}")
    img = image.cpu().numpy()
    if img.shape != (3, h, w) or not np.isfinite(img).all():
        raise AssertionError(f"{cfg.name} main-path image is {img.shape} with non-finite values")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    # alive-ray accounting: one launch, same config, with the recorder's lane counters on
    P.collect()
    P.enable()
    try:
        I.render_launch(scene, launch_params(host, w, h, launches * cfg.spp), state, **kw)
    finally:
        P.disable()
    lanes = P.collect()["lanes"]
    alive = float(sum(lanes["alive"]) + sum(lanes["shadow"]))
    padded = w * h * cfg.spp * 2 * cfg.depth
    result = dict(
        scene=cfg.name,
        config=f"{w}x{h} spp={cfg.spp} depth={cfg.depth}",
        triangles=scene.num_triangles,
        cones=scene.num_cones,
        ms_per_launch=dt * 1e3,
        padded_mrays_per_s=padded / dt / 1e6,
        alive_mrays_per_s=alive / dt / 1e6,
        alive_ray_frac=alive / padded,
        image_mean=float(img.mean()),
        render_launches=launches,
        launch_counts=counts,
        launch_shapes=[dict(kernel=k, shape=list(s), launches=v) for (k, s), v in sorted(shapes.items())],
        launches_per_render_launch={k: v / launches for k, v in counts.items()},
        plain_cuda_calls=plain,
        peak_device_memory_mb=peak_mb,
    )
    log(f"{cfg.name} {result['config']}: {result['ms_per_launch']:.3f} ms/launch, "
        f"{result['padded_mrays_per_s']:.1f} padded Mrays/s, {result['alive_mrays_per_s']:.1f} alive Mrays/s "
        f"(alive fraction {result['alive_ray_frac']:.3f}), peak device memory {peak_mb:.0f} MB")
    log(f"launch counts over {launches} render launches: {counts} (plain versions on CUDA: {plain}); by shape, "
        f"each held against its plain version before: " +
        ", ".join(f"{k}{list(s)} x {v}" for (k, s), v in sorted(shapes.items())))
    return result


# ---------------------------------------------------------------------------
# BVH scenes: kernels K5 and K6
# ---------------------------------------------------------------------------


def check_k5(scene, rays, ray_mask, name, domain: bool = False):
    """K5 on one ray set against its three oracles, on every lane:
    1. its plain version (ops/bvh.py:intersect_bvh_ordered_plain, the same
       near-to-far walk): t, prim, u, v bit for bit, and the per-ray counts
       of child boxes and triangles tested equal;
    2. the dense sweep, K2 cull=False over the same leaf-ordered triangles:
       t, prim, u, v bit for bit;
    3. the reference's DFS walk (ops/bvh.py:intersect_bvh_plain, which K6
       runs): every lane where K5 differs from it is a lane where that walk
       differs from the dense sweep (the count is printed).
    The main path's instance (stats=False) must equal the one held here
    (stats=True) bit for bit. With `domain`, oracles 2 and 3 hold on every
    lane inside the margin's domain (outside_domain), and the lanes outside
    it are counted and printed with how many of them differ.
    Returns a dict: args, K5's per-ray counters, the DFS walk's
    TraversalCounts, the plain version's ms (one call)."""
    import torch

    from strelka_tpu_torch.kernels import bvh as KB
    from strelka_tpu_torch.kernels import intersect as KI
    from strelka_tpu_torch.ops.bvh import intersect_bvh_plain

    args = bvh_args(scene, rays, ray_mask)
    k5 = held(lambda: KB.bvh_closest(*args, stats=True))
    main = held(lambda: KB.bvh_closest(*args))
    plain, plain_ms = timed_once_ms(lambda: KB.closest_plain(*args, counts=True))
    flat = flat_args(scene, rays, ray_mask)
    dense = KI.intersect_closest(*flat, cull=False)
    dfs = intersect_bvh_plain(*args, counts=True)
    torch.cuda.synchronize()
    off_main = closest_off(main, k5)
    off_plain = closest_off(k5, plain)
    counts_off = int(((k5[4] != plain[4].nodes) | (k5[5] != plain[4].tris)).sum())
    outside = outside_domain(flat, dense[1])[0] if domain else torch.zeros_like(dense[1], dtype=torch.bool)
    k5_off_dense = closest_lanes(k5, dense)
    off_dense = int((k5_off_dense & ~outside).sum())
    dfs_off_dense = (dfs[1] != dense[1]) | same_bits(dfs[0], dense[0])
    k5_off_dfs = (k5[1] != dfs[1]) | same_bits(k5[0], dfs[0])
    unexplained = int((k5_off_dfs & ~dfs_off_dense & ~outside).sum())
    live = max(int((args[3] > args[2]).sum()), 1)
    note = f"; lanes {domain_note(k5_off_dense, outside, 'K5')} (held inside the domain only)" if domain else ""
    log(f"K5 on {name} rays ({k5[1].shape[0]}, {live} live, {int((k5[1] >= 0).sum())} hits): the main path's "
        f"instance off the stats one on {off_main} lanes; lanes off its plain version {off_plain} (t, prim, u, v bit "
        f"for bit), per-ray box and triangle counts off {counts_off}; off the dense sweep (K2 cull=False) "
        f"{off_dense}; off the DFS walk {int(k5_off_dfs.sum())}, of them where that walk keeps the dense hit "
        f"{unexplained} (bar: 0 for all five); the DFS walk off the dense sweep {int(dfs_off_dense.sum())}; a live "
        f"ray tests {float(k5[4].sum()) / live:.2f} boxes and {float(k5[5].sum()) / live:.2f} triangles (DFS walk "
        f"{dfs[4].nodes_visited / live:.2f} and {dfs[4].tri_tests / live:.2f}); plain {plain_ms:.0f} ms{note}")
    if off_main or off_plain or counts_off or off_dense or unexplained:
        raise AssertionError(f"K5 on {name} rays: {off_main} lanes off between its two instances, {off_plain} off "
                             f"its plain version, {counts_off} counts off, {off_dense} off the dense sweep, "
                             f"{unexplained} off the DFS walk where it is right")
    return dict(args=args, prim=k5[1], nodes=k5[4], tris=k5[5], dfs=dfs[4], plain_ms=plain_ms,
                dfs_off_dense=int(dfs_off_dense.sum()), k5_off_dfs=int(k5_off_dfs.sum()))


def check_bvh_vs_plain(scene, rays, ray_mask, name):
    """K6 against its plain twin on one ray set (kernels/bvh.py:any_plain,
    ops/bvh.py:intersect_bvh_ordered_plain with any_hit=True: the same
    near-to-far walk over the child table, box test, order and arithmetic):
    occlusion EQUAL on every lane, and the per-ray counts of child boxes and
    triangles tested equal. The main path's instance (stats=False) must
    equal the one held here (stats=True). Returns (args, the twin's per-ray
    OrderedCounts, plain ms)."""
    import torch

    from strelka_tpu_torch.kernels import bvh as KB

    args = bvh_args(scene, rays, ray_mask)
    (occ_p, walk), plain_ms = timed_once_ms(lambda: KB.any_plain(*args, counts=True))
    occ, boxes, tris = held(lambda: KB.bvh_any(*args, stats=True))
    main = held(lambda: KB.bvh_any(*args))
    torch.cuda.synchronize()
    bad = int((occ != occ_p).sum())
    bad_main = int((main != occ).sum())
    counts_off = int(((boxes != walk.nodes) | (tris != walk.tris)).sum())
    live = max(int((args[3] > args[2]).sum()), 1)
    log(f"K6 on {name} rays ({occ.shape[0]}, {live} live, {int(occ.sum())} occluded): lanes off its plain twin "
        f"{bad}, the main path's instance off the stats one {bad_main}, per-ray box and triangle counts off "
        f"{counts_off} (bar: 0, tolerance: none); a live ray fetches {float(boxes.sum()) / 2 / live:.2f} child rows "
        f"and tests {float(tris.sum()) / live:.2f} triangles; plain {plain_ms:.0f} ms")
    if bad or bad_main or counts_off:
        raise AssertionError(f"K6 on {name}: {bad} lanes off its plain twin, {bad_main} off between its two "
                             f"instances, {counts_off} counts off")
    return args, walk, plain_ms


def check_bvh_vs_bruteforce(scene, rays, ray_mask, name, flat=None, flat_rays=None, cap=None):
    """K6 against K3 sweeping every triangle (cull=False), an independent
    oracle: the same leaf-ordered triangles and rays, or those of `flat`
    (the same triangles in another order) with `flat_rays`. Occlusion equal
    on every lane inside the box test's margin's domain (PERF.md section 6:
    a lane with a hit at a normalised determinant of NU_MIN or more keeps
    it; outside_domain); the lanes outside it are counted and printed with
    how many of them differ, and with `cap` (the main paths' ray sets) at
    most that fraction of all lanes may differ. Returns a dict of those
    counts."""
    import torch

    from strelka_tpu_torch.kernels import bvh as KB
    from strelka_tpu_torch.kernels import intersect as KI

    occ_k = KB.bvh_any(*bvh_args(scene, rays, ray_mask))
    fargs = flat_args(scene if flat is None else flat, rays if flat_rays is None else flat_rays, ray_mask)
    occ_f = KI.intersect_any(*fargs, cull=False)
    outside = outside_domain(fargs, KI.intersect_closest(*fargs, cull=False)[1])[1]
    torch.cuda.synchronize()
    lanes = occ_k != occ_f
    off = int((lanes & ~outside).sum())
    res = dict(lanes=int(occ_k.shape[0]), occluded=int(occ_f.sum()), off=off, outside=int(outside.sum()),
               outside_off=int((lanes & outside).sum()))
    capped = cap is not None and int(lanes.sum()) > cap * res["lanes"]
    bar = "" if cap is None else f", {int(lanes.sum())} in all (bar: at most {cap * res['lanes']:.0f})"
    log(f"K6 vs brute force (K3 over {fargs[5].shape[0]} triangles) on {name} rays ({res['lanes']}, "
        f"{res['occluded']} occluded): occlusion differs on {off} lanes inside the margin's domain (bar: 0); "
        f"lanes {domain_note(lanes, outside, 'K6')}{bar}")
    if off or capped:
        raise AssertionError(f"K6 disagrees with brute force on {name} rays: {off} lanes inside the margin's domain, "
                             f"{int(lanes.sum())} in all")
    return res


def bruteforce_summary(results):
    """The K6 brute-force checks of a scene, summed: lanes, lanes off inside the domain, outside it, and off there."""
    return {k: sum(r[k] for r in results) for k in ("lanes", "off", "outside", "outside_off")}


def kernel_resources(report: str, needle: str) -> dict:
    """Registers, stack frame (local memory) and spills a thread of the first
    compiled kernel whose name holds `needle`, from build.ptxas_report()."""
    import re

    out, fn = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([^' ]+)'?", line)
        if m:
            fn = m.group(1)
            continue
        if fn is None or needle not in fn or out.get("registers") is not None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out.update(stack_frame_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                       spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out["registers"] = int(m.group(1))
    return out


def bvh_rows(scene, b1, sh, where: str):
    """K5/K6 rows: times on the bounce-1 (K5, a check_k5 result) and shadow
    (K6, a check_bvh_vs_plain result) rays, and the bound from what these
    rays need: the nodes whose box overlaps [tmin, final t] and the
    triangles of such leaves that pass mask and exclude (K6: those of the
    reference's DFS walk with the margin, up to its first occluder, whatever
    walk K6 runs). The operations count every such visit
    at the reference's slab test (the margin's operations are the kernel's
    overhead, not the function's work); the bytes count
    each such node row (32 bytes) and triangle (40) once, whatever the
    layout a kernel reads and the number of rays that need it, and the
    rays as `ray_bytes` does. K5's and K6's rows have their own walks' counts
    (boxes, K6 also child rows, and triangles tested a live ray, from their
    per-ray counters, equal to their plain versions'), the DFS walk's beside
    them, the stack depth and the registers and local memory a thread;
    both also their times replayed from a CUDA graph (device_ms)."""
    import torch

    from strelka_tpu_torch.kernels import bvh as KB
    from strelka_tpu_torch.kernels import build
    from strelka_tpu_torch.kernels.intersect import MT_FLOPS
    from strelka_tpu_torch.ops.bvh import SLAB_FLOPS, STACK, intersect_bvh_plain

    b1_args, b1_walk = b1["args"], b1["dfs"]
    sh_args, sh_k6, sh_plain_ms = sh
    # K6's yardstick: the reference's DFS walk with the margin (whatever walk K6 runs)
    sh_walk = intersect_bvh_plain(*sh_args, any_hit=True, counts=True, margin=True)[4]
    n = b1_args[2].shape[0]
    live_b1 = int((b1_args[3] > b1_args[2]).sum())
    live_sh = int((sh_args[3] > sh_args[2]).sum())
    t_final, p_final = KB.bvh_closest(*b1_args)[:2]
    ideal = intersect_bvh_plain(*b1_args, prime_t=t_final, counts=True)[4]
    # K5's own walk given the final t from the start (tmax cut to it): the boxes its layout makes a ray test
    cut = torch.where(p_final >= 0, torch.minimum(t_final, b1_args[3]), b1_args[3])
    primed = float(KB.closest_plain(*b1_args[:3], cut, *b1_args[4:], counts=True)[4].nodes.sum()) / live_b1
    nodes_k5, tris_k5 = float(b1["nodes"].sum()) / live_b1, float(b1["tris"].sum()) / live_b1
    res = kernel_resources(build.ptxas_report(), "bvh_closest_kernelILb0E")
    res6 = kernel_resources(build.ptxas_report(), "bvh_any_kernelILb0E")
    log(f"K5 on the bounce-1 rays ({live_b1} live of {n}): its near-to-far walk tests {nodes_k5:.1f} boxes and "
        f"{tris_k5:.2f} triangles a live ray (the DFS walk of K6 and the reference: "
        f"{b1_walk.nodes_visited / live_b1:.1f} and {b1_walk.tri_tests / live_b1:.2f}); given the final t a ray needs "
        f"{ideal.nodes_overlapped / live_b1:.1f} nodes (boxes overlapping [tmin, t]) and "
        f"{ideal.tri_tests / live_b1:.2f} triangles, and K5's walk given it from the start tests {primed:.1f} boxes; "
        f"stack {scene.bvh.depth} of {STACK} entries deep; {res}")
    k6_rows = float(sh_k6.nodes.sum()) / 2 / max(live_sh, 1)
    k6_tris = float(sh_k6.tris.sum()) / max(live_sh, 1)
    log(f"K6 on the shadow rays ({live_sh} live of {n}): its near-to-far walk fetches {k6_rows:.2f} child rows "
        f"({2 * k6_rows:.1f} boxes) and tests {k6_tris:.2f} triangles a live ray; the DFS walk (the reference's, "
        f"with the margin) visits {sh_walk.nodes_visited / max(live_sh, 1):.1f} nodes and tests "
        f"{sh_walk.tri_tests / max(live_sh, 1):.2f} triangles, {sh_walk.nodes_overlapped / max(live_sh, 1):.1f} of "
        f"its nodes overlapped")
    log(f"tree these rays need: K5 {ideal.nodes_touched} of {scene.bvh.num_nodes} nodes and {ideal.tris_touched} "
        f"of {scene.v0.shape[0]} triangles; K6 (the DFS walk) {sh_walk.nodes_touched} nodes and "
        f"{sh_walk.tris_touched} triangles")
    shape = (n, scene.bvh.num_nodes, scene.v0.shape[0])
    rows = [
        dict(
            kernel="bvh_closest", at=where + ", bounce-1 rays", shape=shape,
            ms=time_ms(lambda: KB.bvh_closest(*b1_args), samples=10, inner=3),
            device_ms=graph_ms(lambda: KB.bvh_closest(*b1_args), calls=10),
            plain_ms=b1["plain_ms"],
            bound_bytes=ray_bytes(*b1_args[2:5], 16) + ideal.nodes_touched * 32 + ideal.tris_touched * 40,
            bound_ops_s=(ideal.nodes_overlapped * SLAB_FLOPS + ideal.tri_tests * MT_FLOPS) / F32_OPS_PER_S,
            max_abs_err=0.0, library_ms=None,
            nodes_per_ray=nodes_k5, ideal_nodes_per_ray=ideal.nodes_overlapped / live_b1,
            dfs_nodes_per_ray=b1_walk.nodes_visited / live_b1, primed_nodes_per_ray=primed,
            tris_per_ray=tris_k5, ideal_tris_per_ray=ideal.tri_tests / live_b1,
            dfs_tris_per_ray=b1_walk.tri_tests / live_b1,
            stack_depth=scene.bvh.depth, stack_entries=STACK, registers=res.get("registers"),
            local_bytes=res.get("stack_frame_bytes"), spill_bytes=res.get("spill_store_bytes"),
            live_rays=live_b1, nodes_needed=ideal.nodes_touched, tris_needed=ideal.tris_touched,
        ),
        dict(
            kernel="bvh_any", at=where + ", shadow rays", shape=shape,
            ms=time_ms(lambda: KB.bvh_any(*sh_args), samples=10, inner=3),
            device_ms=graph_ms(lambda: KB.bvh_any(*sh_args), calls=10),
            plain_ms=sh_plain_ms,
            bound_bytes=ray_bytes(*sh_args[2:5], 1) + sh_walk.nodes_touched * 32 + sh_walk.tris_touched * 40,
            bound_ops_s=(sh_walk.nodes_overlapped * SLAB_FLOPS + sh_walk.tri_tests * MT_FLOPS) / F32_OPS_PER_S,
            max_abs_err=0.0, library_ms=None,
            rows_per_ray=k6_rows, nodes_per_ray=2 * k6_rows, tris_per_ray=k6_tris,
            dfs_nodes_per_ray=sh_walk.nodes_visited / max(live_sh, 1),
            ideal_nodes_per_ray=sh_walk.nodes_overlapped / max(live_sh, 1),
            dfs_tris_per_ray=sh_walk.tri_tests / max(live_sh, 1),
            stack_depth=scene.bvh.depth, stack_entries=STACK, registers=res6.get("registers"),
            local_bytes=res6.get("stack_frame_bytes"), spill_bytes=res6.get("spill_store_bytes"),
            live_rays=live_sh, nodes_needed=sh_walk.nodes_touched, tris_needed=sh_walk.tris_touched,
        ),
    ]
    return rows


def bvh_tie_table(scene):
    """A BVH scene's triangles twice over in a tree whose root has two halves
    with equal boxes (scene/grazing.py:twin_tree): the left half over the
    copies (the higher ids), the right over the originals. Every hit has a
    twin at equal t; K5 meets the higher id first and only the rule "equal t,
    the lower id" gives the dense sweep's answer."""
    import types

    import numpy as np
    import torch

    from strelka_tpu_torch.ops.bvh import device_bvh
    from strelka_tpu_torch.scene import grazing as G

    b = scene.bvh
    threaded = tuple(x.cpu().numpy() for x in (b.bb_min, b.bb_max, b.skip, b.start, b.count))
    ntri = scene.v0.shape[0]
    tables = [torch.cat([a, a]).contiguous() for a in (scene.v0, scene.e1, scene.e2, scene.geom_mask)]
    tree = device_bvh(G.twin_tree(tuple(np.asarray(a) for a in threaded), ntri), scene.device)
    return types.SimpleNamespace(v0=tables[0], e1=tables[1], e2=tables[2], geom_mask=tables[3], bvh=tree,
                                 device=scene.device)


def leaf_boxes(bvh, ntri: int):
    """Each triangle's leaf box in a tree -> [8, ntri] f32 (lo xyz, hi xyz, 0, 0)."""
    import torch

    leaves = torch.nonzero(bvh.count > 0)[:, 0]
    boxes = torch.zeros((8, ntri), dtype=torch.float32, device=bvh.nodes.device)
    for k in range(4):
        at = leaves[bvh.count[leaves] > k]
        prim = (bvh.start[at] + k).long()
        boxes[0:3, prim] = bvh.bb_min[at].T
        boxes[3:6, prim] = bvh.bb_max[at].T
    return boxes


def check_bvh_ties(scene, camera, name):
    """K5 on the tie table of a BVH scene (bvh_tie_table) against its three
    oracles (check_k5), on the camera rays, and on the same rays with tmax
    cut to the lowered tnear of their hit's leaf box (an interval that ends
    where a box begins: no triangle hits, and the walk meets that leaf's
    twin with best t equal to its tnear, which the strict pop still takes:
    the per-ray counters show it)."""
    import torch

    from strelka_tpu_torch.ops import slab
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY

    ties = bvh_tie_table(scene)
    rays = dict(camera)
    rays["exclude"] = torch.full_like(camera["exclude"], -1)  # a ray's own prim would have a twin
    chk = check_k5(ties, rays, RAY_MASK_PRIMARY, f"{name} tie table")
    prim = chk["prim"]
    hit = prim >= 0
    o, d = _contig(rays)
    box = leaf_boxes(ties.bvh, ties.v0.shape[0])[:, prim.clamp(min=0).long()][:, :, None]  # [8, N, 1]
    tn_leaf = slab.slab_tnear(o, d, rays["tmin"], rays["tmax"], box)[:, 0]
    cut = dict(rays, tmax=torch.where(hit & (tn_leaf < float("inf")), tn_leaf, 0.0).contiguous())
    check_k5(ties, cut, RAY_MASK_PRIMARY, f"{name} tie table, tmax at the lowered tnear of the hit's leaf box")
    if chk["dfs_off_dense"] == 0:
        raise AssertionError(f"the {name} tie table made no tie the DFS walk loses")
    return chk


def phase_flat_scene(dev):
    """box_field(grid=12), 25,732 triangles (the size range of the TPU's
    _flat and _mxu_flat kernels), built flat and with the BVH: K2/K3 against
    their plain versions at that size, K5/K6 against the plain traversal and
    against K2/K3, and the two golden-config renders compared."""
    import numpy as np

    from strelka_tpu_torch import kernels as K
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW, build_device_scene
    from strelka_tpu_torch.scene import testscenes as TS
    from strelka_tpu_torch.utils.image import ssim

    host = TS.box_field(grid=FLAT_GRID)
    flat = build_device_scene(host, device=dev, use_bvh=False)
    tree = build_device_scene(TS.box_field(grid=FLAT_GRID), device=dev)
    if flat.bvh is not None or tree.bvh is None:
        raise AssertionError("use_bvh=False must keep the scene flat and the default must build a BVH")
    ntri = flat.v0.shape[0]
    log(f"box_field(grid={FLAT_GRID}): {flat.num_triangles} triangles ({ntri} padded), BVH of "
        f"{tree.bvh.num_nodes} nodes ({tree.bvh.builder} builder, {setup_seconds('bvh.build'):.2f} s), "
        f"{tree.bvh.depth} internal nodes deep")
    params = launch_params(host, BOX.width, BOX.height, 0)

    # ---- K2/K3 at 25,732 triangles, on the flat scene's own rays (2^19 lanes)
    _, camera, bounce1, shadow, _, _, _ = main_path_rays(flat, params, dev, BOX)
    n = camera["tmin"].shape[0]
    where = f"box_field(grid={FLAT_GRID}) 2^19 lanes x {ntri} triangles"
    check_intersect(flat, camera, RAY_MASK_PRIMARY, "flat camera")
    b1 = check_intersect(flat, bounce1, RAY_MASK_PRIMARY, "flat bounce-1")
    sh = check_intersect(flat, shadow, RAY_MASK_SHADOW, "flat shadow")
    rows = intersect_rows(flat, b1, ((sh, "shadow"),), where)
    finish_bounds(rows)

    # ---- K5/K6 on the BVH build of the same scene: K5 against its three
    # oracles, K6 against the plain traversal and K3 over its leaf-ordered
    # triangles; K5 on the tie table of this tree
    _, camera, bounce1, shadow, _, _, _ = main_path_rays(tree, params, dev, BOX)
    check_k5(tree, camera, RAY_MASK_PRIMARY, "grid-12 camera")
    check_k5(tree, bounce1, RAY_MASK_PRIMARY, "grid-12 bounce-1")
    sets = ((camera, RAY_MASK_PRIMARY, "camera"), (bounce1, RAY_MASK_PRIMARY, "bounce-1"),
            (shadow, RAY_MASK_SHADOW, "shadow"))
    for r, mask, label in sets:
        check_bvh_vs_plain(tree, r, mask, f"grid-12 {label}")
    differ = bruteforce_summary([check_bvh_vs_bruteforce(tree, r, mask, f"grid-12 {label}", cap=1e-4)
                                 for r, mask, label in sets])
    check_bvh_ties(tree, camera, "grid-12")

    # ---- the two golden-config renders
    K.reset_counts()
    img_flat = golden_render(TS.box_field(grid=FLAT_GRID), dev, use_bvh=False)
    flat_counts = dict(K.launch_counts)
    K.reset_counts()
    img_tree = golden_render(TS.box_field(grid=FLAT_GRID), dev)
    tree_counts = dict(K.launch_counts)
    if not (flat_counts["intersect_closest"] and flat_counts["intersect_any"] and tree_counts["bvh_closest"]
            and tree_counts["bvh_any"]) or flat_counts["bvh_closest"] or tree_counts["intersect_closest"]:
        raise AssertionError(f"flat render must run K2/K3 and the BVH render K5/K6: {flat_counts}, {tree_counts}")
    diff = np.abs(img_flat - img_tree)
    s = float(ssim(img_flat, img_tree))
    differing = int((diff.max(axis=-1) > 1e-4).sum())
    log(f"box_field(grid={FLAT_GRID}) golden config, flat (K2/K3) against BVH (K5/K6) render: max abs difference "
        f"{float(diff.max()):.3g}, {differing} of {diff.shape[0] * diff.shape[1]} pixels differ by more than 1e-4, "
        f"SSIM {s:.6f} (bar 0.99)")
    if s < 0.99:
        raise AssertionError("the flat and the BVH render of box_field(grid=12) disagree")
    result = dict(triangles=flat.num_triangles, padded_triangles=ntri, rays=n, kernels=rows,
                  launches_golden_render={k: flat_counts[k] for k in ("intersect_closest", "intersect_any")},
                  bvh_any_vs_bruteforce=differ,
                  render_max_abs_diff=float(diff.max()), render_pixels_differing=differing, render_ssim=s)
    return result


def phase_box_kernels(scene, params):
    """Every kernel of the box_field main path at every shape that path
    gives it: K1 on its 2^19 sample indices, K5/K6 on 2^19 lanes a bounce
    against 411,652 triangles, K4 on its two tables (the attr table at the
    hits, the light table at the sampled light ids)."""
    from strelka_tpu_torch.ops.bvh import STACK
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW

    dev = scene.device
    where = f"box_field(grid={BOX_GRID}) 2^19 lanes x {scene.v0.shape[0]} triangles"
    sample_idx, camera, bounce1, shadow, prims, lid, _ = main_path_rays(scene, params, dev, BOX)
    rows = sobol_rows(sample_idx, BOX, "box_field")
    log(f"box_field(grid={BOX_GRID}): tree {scene.bvh.depth} internal nodes deep (K5's stack holds {STACK}), "
        f"{scene.bvh.children.shape[0]} rows of its child table")
    check_k5(scene, camera, RAY_MASK_PRIMARY, "box_field camera")
    b1 = check_k5(scene, bounce1, RAY_MASK_PRIMARY, "box_field bounce-1")
    sets = ((camera, RAY_MASK_PRIMARY, "camera"), (bounce1, RAY_MASK_PRIMARY, "bounce-1"),
            (shadow, RAY_MASK_SHADOW, "shadow"))
    *_, sh = [check_bvh_vs_plain(scene, r, mask, f"box_field {label}") for r, mask, label in sets]  # K6's row: shadow
    differ = bruteforce_summary([check_bvh_vs_bruteforce(scene, r, mask, f"box_field {label}", cap=1e-4)
                                 for r, mask, label in sets])
    rows += bvh_rows(scene, b1, sh, where)
    rows.append(gather_row(scene.attr_table, prims, "box_field attr_table at the camera hits"))
    rows.append(gather_row(scene.light_table, lid, "box_field light_table at the sampled light ids"))
    finish_bounds(rows)
    return rows, differ


# ---------------------------------------------------------------------------
# Curve scenes: kernels K7 and K8
# ---------------------------------------------------------------------------


def cone_args(scene, rays):
    """K7/K8's arguments for one ray set against a scene's packed cones."""
    o, d = _contig(rays)
    return o, d, rays["tmin"].contiguous(), rays["tmax"].contiguous(), scene.packed_cones


def check_open_w(sbounds, o, d, tmin, tmax, t_closest, name):
    """K9 against its plain version on one ray set, at tiles of K9_TILE rays,
    over superblock boxes `sbounds`: W equal and min_tn bit for bit without
    the open flag, and with the open flag too, each tile's OPEN_K nearest
    superblocks taken as swept and the closest sweep's t as the bound (the
    reference's use after phase 1); and the sweep order from the same launch
    (sweep_order: order, count and tnear) equal to the plain twin's
    (sweep_order_plain, computed on the card) bit for bit. K9 is off the
    cone sweeps' path (they walk the cone tree); it stays held as the
    hand-written counterpart of pallas_open_w. Returns (plain ms, mean
    superblocks a tile passes, the comparisons the tiles' orders need:
    c log2 c for the c superblocks a tile passes, a comparison sort's least;
    the others are placed by index)."""
    import torch

    from strelka_tpu_torch.kernels import open_w as KO
    from strelka_tpu_torch.ops import curves as C

    tile, sb = K9_TILE, sbounds
    bits = lambda a, b: a.view(torch.int32) != b.view(torch.int32)  # noqa: E731
    open_k, w_k, tn_k = held(lambda: KO.open_w(o, d, tmin, tmax, sb, tile=tile))
    (open_p, w_p, tn_p), plain_ms = timed_once_ms(lambda: KO.open_w_plain(o, d, tmin, tmax, sb, tile=tile))
    off = int((w_k != w_p).sum()) + int(bits(tn_k, tn_p).sum()) + int(open_k.sum()) + int(open_p.sum())
    _, r2t, d2 = C.tile_sweep_order_k(o, sb, tile, OPEN_K)
    bound = torch.minimum(t_closest, tmax)
    open_k2, w_k2, tn_k2 = held(lambda: KO.open_w(o, d, tmin, bound, sb, d2, r2t, tile=tile))
    open_p2, w_p2, tn_p2 = KO.open_w_plain(o, d, tmin, bound, sb, d2, r2t, tile=tile)
    off2 = int((open_k2 != open_p2).sum()) + int((w_k2 != w_p2).sum()) + int(bits(tn_k2, tn_p2).sum())
    got = held(lambda: KO.sweep_order(o, d, tmin, tmax, sb, tile))
    want = KO.sweep_order_plain(o, d, tmin, tmax, sb, tile)
    off3 = (int((got.order != want.order).sum()) + int((got.count != want.count).sum())
            + int(bits(got.tnear, want.tnear).sum()))
    # entries of a passed head whose key equals the one before: where only "the lower index first" orders them
    key = want.tnear + 0.0
    head = torch.arange(key.shape[1] - 1, device=key.device)[None, :] < (want.count[:, None] - 1)
    ties = int(((key[:, 1:] == key[:, :-1]) & head).sum())
    passed = float(w_k.sum()) / w_k.shape[0]
    c = w_k.sum(dim=1).double()
    sort_ops = float(torch.where(c > 1, c * torch.log2(c.clamp(min=1)), 0.0).sum())
    log(f"K9 on {name} rays ({tmin.shape[0]} in {w_k.shape[0]} tiles of {tile} x {w_k.shape[1]} superblocks): a tile "
        f"passes {passed:.1f} superblocks; W, min_tn differ from the plain version on {off} entries; with the "
        f"{OPEN_K} nearest swept and the closest t as bound {int(open_k2.sum())} rays are open, open, W, min_tn "
        f"differ on {off2} entries; the sweep order (order, count, tnear) differs from the plain twin's on {off3} "
        f"entries, {ties} passed entries tied with the one before (bar: 0, 0 and 0, min_tn and tnear bit for bit); "
        f"plain {plain_ms:.1f} ms")
    if off or off2 or off3:
        raise AssertionError(f"K9 on {name} rays disagrees with its plain version")
    return plain_ms, passed, sort_ops


def check_cones(scene, rays, name, subset=None):
    """K7 and K8 on one ray set, each walking the cone tree, against their
    own cull=False mode on every lane, and against the plain dense sweeps
    (on every lane, or on the lanes `subset` where the dense sweep over the
    scene's cones would take minutes): t bit for bit, cone index and y
    equal, occlusion equal to the plain any-hit sweep's, whose caps are
    tested as the JAX package's compiled any-hit sweep tests them
    (ops/curves.py:ray_round_cone). The kernels' own counters (boxes tested,
    leaves swept, live cones tested) and final t / occlusion must equal the
    plain count of the walk (ops/curves.py:cone_tree_walk) on the same lanes.
    Returns a dict: args, K7's t, the ConeStats of K7 and of K8, plain ms and
    lanes, the largest |difference| in t or y against the plain version."""
    import torch

    from strelka_tpu_torch.kernels import cones as KC
    from strelka_tpu_torch.ops import curves as C

    args = cone_args(scene, rays)
    o, d, tmin, tmax, pc = args
    n = tmin.shape[0]
    lanes = torch.arange(n, device=tmin.device) if subset is None else subset
    sub = lambda a: a[lanes].contiguous()  # noqa: E731
    sub_args = (tuple(sub(c) for c in o), tuple(sub(c) for c in d), sub(tmin), sub(tmax), pc)
    block = 256 if subset is None else 4096  # the result does not depend on it
    t, c, y, st7 = held(lambda: KC.cone_closest(*args, stats=True))
    occ, st8 = held(lambda: KC.cone_any(*args, stats=True))
    t_b, c_b, y_b = KC.cone_closest(*args, cull=False)
    occ_b = KC.cone_any(*args, cull=False)
    (t_p, c_p, y_p), plain_ms = timed_once_ms(lambda: KC.closest_plain(*sub_args, block=block))
    occ_p, plain_any_ms = timed_once_ms(lambda: KC.any_plain(*sub_args, block=block))
    bits = lambda a, b: a.view(torch.int32) != b.view(torch.int32)  # noqa: E731
    differ = lambda a, b, ca, cb, ya, yb: int((bits(a, b) | (ca != cb) | (ya != yb)).sum())  # noqa: E731
    off_cull = differ(t, t_b, c, c_b, y, y_b)
    off_plain = differ(t[lanes], t_p, c[lanes], c_p, y[lanes], y_p)
    occ_off_cull, occ_off_plain = int((occ != occ_b).sum()), int((occ[lanes] != occ_p).sum())
    cap_tests_differ = int(((c_p >= 0) != occ_p).sum())  # the any-hit sweep's cap test against the closest's
    # the walks, counted in plain PyTorch on the same lanes
    off_count = 0
    for st, walk, done in ((st7, C.cone_tree_walk(pc.geom, pc.tree, *sub_args[:4], reach=pc.reach), t),
                           (st8, C.cone_tree_walk(pc.geom, pc.tree, *sub_args[:4], any_hit=True, reach=pc.reach), occ)):
        counts = torch.stack([walk.boxes, walk.leaves, walk.cones])
        off_count += int((st.per_ray[:, lanes] != counts).any(dim=0).sum())
        off_count += int(((done[lanes] != (walk.t < C.MISS_T)) if done.dtype == torch.bool
                          else bits(done[lanes], walk.t)).sum())
    _, ties, _ = closest_mismatch(t[lanes], c[lanes], t_p, c_p)
    same = c[lanes] == c_p
    err = max(float(torch.abs(a[lanes] - b)[same].max()) if bool(same.any()) else 0.0 for a, b in ((t, t_p), (y, y_p)))
    nl = int(lanes.shape[0])
    log(f"K7 on {name} rays ({n}, the cone tree of {len(pc.levels)} levels): {int((c >= 0).sum())} hits; t, cone, y "
        f"differ from cull=False on {off_cull} lanes and from the plain sweep on {off_plain} of {nl} lanes ({ties} of "
        f"them ties, max abs difference in t or y on equal cones {err:.3g}; bar: 0 and 0 lanes, t bit for bit); plain "
        f"sweep {plain_ms:.0f} ms")
    log(f"K8 on {name} rays ({n}): {int(occ.sum())} occluded; differs from cull=False on {occ_off_cull} lanes "
        f"and from the plain any-hit sweep on {occ_off_plain} of {nl} lanes (bar: 0 and 0; that sweep's occlusion "
        f"differs from the plain closest sweep's hit set on {cap_tests_differ} lanes, by the caps' two tests; plain "
        f"any-hit sweep {plain_any_ms:.0f} ms); K7's and K8's counters and results differ from the plain count of "
        f"their walks on {off_count} of {2 * nl} lanes (bar: 0)")
    if off_cull or off_plain or occ_off_cull or occ_off_plain or off_count:
        raise AssertionError(f"K7 or K8 on {name} rays disagrees with its cull=False mode, its plain version or the "
                             f"plain count of its walk")
    return dict(args=args, t=t, stats7=st7, stats8=st8, plain_ms=plain_ms, lanes=nl, err=err)


def cone_rows(scene, b1, sh, where: str):
    """K7/K8 rows: times on the bounce-1 (K7) and shadow (K8) rays, the
    walks' work from the kernels' counters (boxes slab-tested, leaves swept,
    cones tested a live ray; `lane_efficiency` the share of the cone tests'
    lane slots that tested a live cone) and the bound from what these rays
    need, counted in plain PyTorch and not by the kernels. K7: the cones
    with ra >= 0 whose own box the ray's final interval [tmin, t] enters
    (ops/curves.py:cones_entered, the roofline's count, on SAMPLE_RAYS live
    rays scaled to all), and for comparison the cones of the 256-cone
    sub-blocks that interval enters (sub_blocks_entered). K8: the cones with
    ra >= 0 a ray tests up to its first occluder, going through the
    sub-blocks it enters and their cones in ascending order
    (ops/curves.py:any_hit_need). Operations: CONE_FLOPS a test. Bytes: the
    rays as `ray_bytes` does and each needed sub-block's cones (32 bytes
    each) and box (32 bytes) once. Where the scene has 32 superblocks or
    more (K9's order was on its path until the cone tree), K9's row follows
    (bounce-1 rays)."""
    import torch

    from strelka_tpu_torch.kernels import cones as KC
    from strelka_tpu_torch.kernels import open_w as KO
    from strelka_tpu_torch.ops import curves as C

    pc = scene.packed_cones
    n = b1["args"][2].shape[0]
    tblk = pc.geom.shape[0] // scene.cone_bounds.shape[1]
    rows = []
    for kernel, chk, stats, fn, out_bytes, which in (
            ("cone_closest", b1, b1["stats7"], KC.cone_closest, 12, "bounce-1"),
            ("cone_any", sh, sh["stats8"], KC.cone_any, 1, "shadow")):
        args = chk["args"]
        o, d, tmin, tmax, _ = args
        live_mask = tmax > tmin
        live = max(int(live_mask.sum()), 1)
        boxes, leaves, tested = (int(v) for v in stats.per_ray.sum(dim=1))
        issued, slots_tested = (int(v) for v in stats.slots)
        if kernel == "cone_closest":
            tfar = torch.minimum(chk["t"], tmax)
            pick = torch.nonzero(live_mask)[:, 0]
            pick = pick[torch.randperm(pick.numel(), generator=torch.Generator().manual_seed(7))[:SAMPLE_RAYS]
                        .to(pick.device)]
            cut = lambda a: a[pick].contiguous()  # noqa: E731
            own = C.cones_entered(pc.geom, tuple(cut(c) for c in o), tuple(cut(c) for c in d), cut(tmin), cut(tfar))
            own_per_ray = float(own.sum()) / max(int(pick.numel()), 1)
            need = C.sub_blocks_entered(pc.geom, scene.cone_bounds, o, d, tmin, tfar)
            cones_needed = own_per_ray * live
        else:
            need = C.any_hit_need(pc.geom, scene.cone_bounds, o, d, tmin, tmax)
            own_per_ray, cones_needed = None, int(need[1].sum())
        blocks_needed, block_cones, touched = int(need[0].sum()), int(need[1].sum()), int(need[2].sum())
        blocks_per_sm, threads = KC.occupancy(kernel == "cone_any", pc.reach > 0.0, tmin.device)
        log(f"{kernel} on the {which} rays ({live} live of {n}): tests {boxes / live:.1f} boxes, sweeps "
            f"{leaves / live:.2f} leaves and tests {tested / live:.1f} cones a live ray (the kernel's counters); "
            + (f"the cones whose own box the final interval enters {own_per_ray:.2f} a live ray (the roofline's "
               f"count, {SAMPLE_RAYS} rays), those of the 256-cone sub-blocks it enters {block_cones / live:.1f} "
               if own_per_ray is not None else
               f"the ascending sweep of the 256-cone sub-blocks needs {block_cones / live:.1f} cones ")
            + f"(counted in plain PyTorch); lane efficiency {slots_tested / max(issued, 1):.4f} ({slots_tested} "
            f"of {issued} lane slots test a live cone); {blocks_per_sm} blocks of {threads} threads an SM")
        rows.append(dict(
            kernel=kernel, at=f"{where}, {which} rays", shape=KC.launch_shape(n, pc),
            ms=time_ms(lambda: fn(*args), samples=5, inner=2, warmup=1),
            device_ms=graph_ms(lambda: fn(*args), calls=5, samples=5),
            plain_ms=chk["plain_ms"], plain_lanes=chk["lanes"],
            bound_bytes=ray_bytes(tmin, tmax, None, out_bytes) + touched * (tblk * 32 + 32),
            bound_ops_s=cones_needed * C.CONE_FLOPS / F32_OPS_PER_S,
            max_abs_err=chk["err"] if kernel == "cone_closest" else 0.0, library_ms=None,
            boxes_per_ray=boxes / live, leaves_per_ray=leaves / live, cones_per_ray=tested / live,
            needed_cones_per_ray=cones_needed / live, sub_block_cones_per_ray=block_cones / live,
            needed_sub_blocks_per_ray=blocks_needed / live, live_rays=live,
            lane_efficiency=slots_tested / max(issued, 1), blocks_per_sm=blocks_per_sm,
        ))
    nsb = scene.cone_sbounds.shape[1]
    if nsb >= 32:
        o, d, tmin, tmax, _ = b1["args"]
        tile, sb = K9_TILE, scene.cone_sbounds
        n_tiles = -(-n // tile)
        live = int((tmax > tmin).sum())
        plain_ms, passed, sort_ops = check_open_w(sb, o, d, tmin, tmax, b1["t"], f"{where} bounce-1")
        rows.append(dict(
            kernel="open_w", at=f"{where}, bounce-1 rays in tiles of {tile}", shape=(n, nsb, tile, 0),
            ms=time_ms(lambda: KO.open_w(o, d, tmin, tmax, sb, tile=tile)),
            device_ms=graph_ms(lambda: KO.open_w(o, d, tmin, tmax, sb, tile=tile)),
            order_ms=time_ms(lambda: KO.sweep_order(o, d, tmin, tmax, sb, tile)),
            order_device_ms=graph_ms(lambda: KO.sweep_order(o, d, tmin, tmax, sb, tile)),
            plain_ms=plain_ms,
            bound_bytes=ray_bytes(tmin, tmax, None, 1) + nsb * 24 + n_tiles * nsb * 13 + n_tiles * 4,
            bound_ops_s=(live * nsb * KO.SLAB_FLOPS + sort_ops) / F32_OPS_PER_S,
            max_abs_err=0.0, library_ms=None, superblocks_passed_per_tile=passed,
        ))
    return rows


def phase_hair_kernels(scene, params, cfg: Config, subset_lanes=None):
    """Every kernel of a hair main path at every shape that path gives it:
    K1 on its 294,912 sample indices, K2/K3 on the ground quad (2 triangles
    padded to 128), K4 on the attr table at the camera hits and on the
    material table at the curve hits' material ids, K7/K8 on the cones and,
    from 32 superblocks on, K9 on the superblock boxes (off the main path)."""
    import torch

    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW

    dev = scene.device
    sample_idx, camera, bounce1, shadow, prims, _, seg_mat = main_path_rays(scene, params, dev, cfg)
    n = sample_idx.shape[0]
    ntri, ncones = scene.v0.shape[0], scene.cone_geom.shape[0]
    where = f"{cfg.name} {n} lanes x {ncones} cones"
    rows = sobol_rows(sample_idx, cfg, cfg.name)

    # ---- K2/K3 on the ground quad
    check_intersect(scene, camera, RAY_MASK_PRIMARY, f"{cfg.name} camera")
    b1 = check_intersect(scene, bounce1, RAY_MASK_PRIMARY, f"{cfg.name} bounce-1")
    sh = check_intersect(scene, shadow, RAY_MASK_SHADOW, f"{cfg.name} shadow")
    rows += intersect_rows(scene, b1, ((sh, "shadow"),), f"{cfg.name} {n} lanes x {ntri} triangles")

    # ---- K7/K8 on the cones
    subset = None
    if subset_lanes is not None:
        subset = torch.arange(0, n, n // subset_lanes, device=dev)[:subset_lanes]
    check_cones(scene, camera, f"{cfg.name} camera", subset)
    b1 = check_cones(scene, bounce1, f"{cfg.name} bounce-1", subset)
    sh = check_cones(scene, shadow, f"{cfg.name} shadow", subset)
    rows += cone_rows(scene, b1, sh, where)
    if scene.cone_sbounds.shape[1] >= 32:
        # K9 where the boxes are no multiple of 32 and more than a block's threads (the scene's three
        # times over: every key tied with its copies') and the rays no multiple of the tile
        o, d, tmin, tmax, pc = b1["args"]
        cut = lambda a: a[:n - 37].contiguous()  # noqa: E731
        check_open_w(torch.cat([scene.cone_sbounds] * 3, dim=1).contiguous(), tuple(cut(c) for c in o),
                     tuple(cut(c) for c in d), cut(tmin), cut(tmax), cut(b1["t"]),
                     f"{cfg.name} bounce-1 (the first {n - 37}) x its superblocks three times over")

    # ---- K4 on this scene's tables
    rows.append(gather_row(scene.attr_table, prims, f"{cfg.name} attr_table at the camera hits"))
    rows.append(gather_row(scene.mat_table, seg_mat, f"{cfg.name} mat_table at the curve hits' material ids"))
    finish_bounds(rows)
    return rows


def hair_scene(cfg: Config, dev):
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.scene import testscenes as TS

    t0 = time.perf_counter()
    host = TS.hair_patch(n_curves=HAIR_CURVES[cfg.name])
    scene = build_device_scene(host, device=dev)
    log(f"{cfg.name}: hair_patch(n_curves={HAIR_CURVES[cfg.name]}), {scene.num_curve_segments} segments (padded), "
        f"{scene.num_cones} cones ({scene.cone_geom.shape[0]} padded) under a tree of levels "
        f"{[c for _, c in scene.packed_cones.levels]} boxes ({scene.cone_bounds.shape[1]} sub-blocks and "
        f"{scene.cone_sbounds.shape[1]} superblocks for K9), {scene.num_triangles} triangles; host scene and "
        f"device tables built in {time.perf_counter() - t0:.1f} s")
    return host, scene


def phase_hair(dev, t_start):
    """Phases 5 and 6 -> (hair_patch rows, main path, golden SSIM, hair_long rows, main path, golden SSIM)."""
    from strelka_tpu_torch.scene import testscenes as TS

    host, scene = hair_scene(HAIR, dev)
    rows = phase_hair_kernels(scene, launch_params(host, HAIR.width, HAIR.height, 0), HAIR)
    ssim_hair = phase_golden(TS.hair_patch(n_curves=HAIR_CURVES["hair_patch"]), dev, "hair_patch_golden.png",
                             HAIR.kernels, HAIR_GOLDEN)
    rows += phase_order(scene, host, HAIR)
    main_hair = phase_main_path(scene, host, HAIR)
    phase_launch_graph(scene, host, HAIR)
    phase_order_ab(scene, host, HAIR)
    log(f"[{time.perf_counter() - t_start:.0f} s] hair_patch phases done")
    del scene
    long_host, long_scene = hair_scene(HAIR_LONG, dev)
    long_rows = phase_hair_kernels(long_scene, launch_params(long_host, HAIR_LONG.width, HAIR_LONG.height, 0),
                                   HAIR_LONG, subset_lanes=PLAIN_SUBSET)
    long_rows += phase_order(long_scene, long_host, HAIR_LONG)
    main_long = phase_main_path(long_scene, long_host, HAIR_LONG)
    log(f"hair_long image mean {main_long['image_mean']:.6f} (finite)")
    phase_launch_graph(long_scene, long_host, HAIR_LONG)
    phase_order_ab(long_scene, long_host, HAIR_LONG)
    del long_scene
    ssim_long = phase_golden(TS.hair_patch(n_curves=HAIR_CURVES["hair_long"]), dev, "hair_long_golden.png",
                             HAIR_LONG.kernels, HAIR_LONG_GOLDEN)
    log(f"[{time.perf_counter() - t_start:.0f} s] hair_long phases done")
    return rows, main_hair, ssim_hair, long_rows, main_long, ssim_long


# ---------------------------------------------------------------------------
# USD scenes: coffeetable (text stage, flat) and kitchen (crate, BVH, textures)
# ---------------------------------------------------------------------------


def usd_host(path: str):
    """A USD stage through the port's UsdLoader -> (host scene, seconds)."""
    from strelka_tpu_torch.loaders.usd import UsdLoader
    from strelka_tpu_torch.scene.scene import Scene

    t0 = time.perf_counter()
    host = Scene()
    if not UsdLoader().load(path, host):
        raise AssertionError(f"{path} failed to load")
    return host, time.perf_counter() - t0


def phase_coffeetable(dev, t_start):
    """Phase 7 -> (rows, main path, golden SSIM)."""
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW, build_device_scene

    path = os.path.join(REPO, COFFEETABLE_USD)
    host, load_s = usd_host(path)
    scene = build_device_scene(host, device=dev)
    ntri = scene.v0.shape[0]
    log(f"coffeetable: {COFFEETABLE_USD} loaded in {load_s:.3f} s; {scene.num_triangles} triangles ({ntri} padded), "
        f"{scene.num_lights} lights, {scene.mat_table.shape[0]} material rows, flat: {scene.bvh is None}, "
        f"textures: {scene.textures is not None}")
    if scene.bvh is not None or scene.textures is not None or ntri != 128:
        raise AssertionError("coffeetable must build flat, untextured, 128 triangles padded")
    params = launch_params(host, COFFEE.width, COFFEE.height, 0)
    sample_idx, camera, bounce1, shadow, prims, lid, _ = main_path_rays(scene, params, dev, COFFEE)
    n = sample_idx.shape[0]
    rows = sobol_rows(sample_idx, COFFEE, "coffeetable")
    check_intersect(scene, camera, RAY_MASK_PRIMARY, "coffeetable camera")
    b1 = check_intersect(scene, bounce1, RAY_MASK_PRIMARY, "coffeetable bounce-1")
    sh = check_intersect(scene, shadow, RAY_MASK_SHADOW, "coffeetable shadow")
    rows += intersect_rows(scene, b1, ((sh, "shadow"),), f"coffeetable {n} lanes x {ntri} triangles")
    rows.append(gather_row(scene.attr_table, prims, "coffeetable attr_table at the camera hits"))
    rows.append(gather_row(scene.light_table, lid, "coffeetable light_table at the sampled light ids"))
    finish_bounds(rows)
    ssim = phase_golden(usd_host(path)[0], dev, "coffeetable_golden.png", COFFEE.kernels, COFFEE_GOLDEN)
    rows += phase_order(scene, host, COFFEE)
    main = phase_main_path(scene, host, COFFEE)
    main.update(load_seconds=load_s)
    phase_launch_graph(scene, host, COFFEE)
    phase_order_ab(scene, host, COFFEE)
    log(f"[{time.perf_counter() - t_start:.0f} s] coffeetable phases done")
    return rows, main, ssim


def phase_kitchen(dev, t_start):
    """Phase 8 -> (rows, main path, golden SSIM, K6 brute-force summary)."""
    from strelka_tpu_torch import native
    from strelka_tpu_torch.ops.bvh import STACK
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW, build_device_scene
    from strelka_tpu_torch.scene.kitchen import ensure_kitchen

    path = ensure_kitchen()
    host, load_s = usd_host(path)
    native_codec = native.get_library() is not None
    t0 = time.perf_counter()
    scene = build_device_scene(host, device=dev)
    build_s = time.perf_counter() - t0
    build_span = setup_span("bvh.build")
    atlas = scene.textures
    log(f"kitchen: {os.path.relpath(path, REPO)} loaded in {load_s:.3f} s (crate codec: "
        f"{'native' if native_codec else 'Python'}); device tables in {build_s:.2f} s: {scene.num_triangles} "
        f"triangles ({scene.v0.shape[0]} padded), {scene.num_lights} lights, {scene.mat_table.shape[0]} material "
        f"rows, texture columns {scene.tex_columns}, atlas {tuple(atlas.data.shape)} {atlas.data.dtype} with "
        f"{atlas.rects.shape[0]} rects; BVH of {scene.bvh.num_nodes} nodes ({scene.bvh.builder} builder, "
        f"{setup_seconds('bvh.build'):.2f} s), {scene.bvh.depth} internal nodes deep (K5's and K6's stack holds {STACK})")
    if scene.bvh is None or atlas is None or scene.num_triangles != 105168 or scene.num_lights != 4:
        raise AssertionError("kitchen must build on a BVH with a texture atlas: 105,168 triangles, 4 lights")
    params = launch_params(host, KITCHEN.width, KITCHEN.height, 0)
    sample_idx, camera, bounce1, shadow, prims, lid, _ = main_path_rays(scene, params, dev, KITCHEN)
    where = f"kitchen 2^19 lanes x {scene.v0.shape[0]} triangles"
    rows = sobol_rows(sample_idx, KITCHEN, "kitchen")
    # an interior's bounce rays graze its walls: K5 is held to the dense sweep inside the margin's domain
    check_k5(scene, camera, RAY_MASK_PRIMARY, "kitchen camera", domain=True)
    b1 = check_k5(scene, bounce1, RAY_MASK_PRIMARY, "kitchen bounce-1", domain=True)
    sets = ((camera, RAY_MASK_PRIMARY, "camera"), (bounce1, RAY_MASK_PRIMARY, "bounce-1"),
            (shadow, RAY_MASK_SHADOW, "shadow"))
    *_, sh = [check_bvh_vs_plain(scene, r, mask, f"kitchen {label}") for r, mask, label in sets]  # K6's row: shadow
    differ = bruteforce_summary([check_bvh_vs_bruteforce(scene, r, mask, f"kitchen {label}", cap=1e-4)
                                 for r, mask, label in sets])
    rows += bvh_rows(scene, b1, sh, where)
    rows.append(gather_row(scene.attr_table, prims, "kitchen attr_table at the camera hits"))
    rows.append(gather_row(scene.light_table, lid, "kitchen light_table at the sampled light ids"))
    finish_bounds(rows)
    ssim = phase_golden(usd_host(path)[0], dev, "kitchen_golden.png", KITCHEN.kernels, KITCHEN_GOLDEN)
    regen = check_kitchen_regenerated(dev)
    rows += phase_order(scene, host, KITCHEN)
    main = phase_main_path(scene, host, KITCHEN)
    main.update(load_seconds=load_s, native_crate_codec=native_codec, device_tables_seconds=build_s,
                bvh_nodes=scene.bvh.num_nodes, bvh_depth=scene.bvh.depth, bvh_builder=scene.bvh.builder,
                bvh_build_seconds=setup_seconds("bvh.build", build_span), atlas_shape=list(atlas.data.shape),
                regenerated=regen)
    phase_launch_graph(scene, host, KITCHEN)
    phase_order_ab(scene, host, KITCHEN)
    log(f"[{time.perf_counter() - t_start:.0f} s] kitchen phases done")
    return rows, main, ssim, differ


def check_kitchen_regenerated(dev) -> dict:
    """The kitchen stage generated by the port (scene/kitchen_gen.py, through
    scene/kitchen.py:ensure_kitchen) into a temporary directory, loaded
    through the crate reader and UsdLoader, and rendered at its golden
    config: SSIM >= 0.99 against goldens/kitchen_golden.png. Logs the
    generator's seconds and which files are byte-equal to the committed
    data/gen/kitchen/ ones (the committed kitchen.usdc came from an older
    writer and differs; the PNGs depend on the machine's zlib)."""
    import shutil
    import tempfile

    from strelka_tpu_torch.scene.kitchen import KITCHEN_TEXTURES, ensure_kitchen, kitchen_dir

    tmp = tempfile.mkdtemp(prefix="strelka_kitchen_")
    try:
        t0 = time.perf_counter()
        path = ensure_kitchen(tmp)
        gen_s = time.perf_counter() - t0
        same = {}
        for rel in ("kitchen.usdc",) + tuple(os.path.join("textures", t) for t in KITCHEN_TEXTURES):
            with open(os.path.join(tmp, rel), "rb") as a, open(os.path.join(kitchen_dir(), rel), "rb") as b:
                same[rel] = a.read() == b.read()
        host, load_s = usd_host(path)
        s = phase_golden(host, dev, "kitchen_golden.png", KITCHEN.kernels, KITCHEN_GOLDEN)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"kitchen regenerated by the port in {gen_s:.2f} s into a temporary directory, loaded in {load_s:.3f} s; "
        f"byte-equal to the committed files: {same}; golden SSIM {s:.6f} (bar: 0.99)")
    return dict(generate_seconds=gen_s, load_seconds=load_s, byte_equal_to_committed=same, golden_ssim=s)


def phase_hair_kk(dev) -> dict:
    """Phase 12: hair_patch(n_curves=256) rendered with STRELKA_HAIR_KK=1 in a
    child process (the flag is read at import, as the reference reads it),
    the Kajiya-Kay fibre lobes of ops/bsdf.py:_hair_eval: the image finite,
    its mean beside the default (Chiang) render's of the same config here."""
    cfg = (HAIR.width // 4, HAIR.height // 4, HAIR.spp, 2)
    code = ("import json, sys; sys.path.insert(0, {repo!r}); import chip_smoke as S; "
            "from strelka_tpu_torch.ops import bsdf; from strelka_tpu_torch.scene import testscenes as TS; "
            "img = S.golden_render(TS.hair_patch(n_curves={n}), 'cuda', config={cfg!r}); "
            "print(json.dumps(dict(kk=bsdf._HAIR_KAJIYA_KAY, mean=float(img.mean()))))").format(
        repo=REPO, n=HAIR_CURVES["hair_patch"], cfg=cfg)
    env = dict(os.environ, STRELKA_HAIR_KK="1")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, stdout=subprocess.PIPE,
                          stderr=subprocess.PIPE, text=True, timeout=600)
    child_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the STRELKA_HAIR_KK=1 render exited {proc.returncode}: {proc.stderr[-3000:]}")
    kk = json.loads(proc.stdout.strip().splitlines()[-1])
    from strelka_tpu_torch.ops import bsdf
    from strelka_tpu_torch.scene import testscenes as TS

    chiang = float(golden_render(TS.hair_patch(n_curves=HAIR_CURVES["hair_patch"]), dev, config=cfg).mean())
    result = dict(config=list(cfg), kajiya_kay=kk["kk"], kk_mean=kk["mean"], chiang_mean=chiang,
                  chiang_here=not bsdf._HAIR_KAJIYA_KAY, child_seconds=child_s)
    log(f"hair_patch {cfg} with STRELKA_HAIR_KK=1 in a child process ({child_s:.1f} s): the Kajiya-Kay lobes "
        f"{'on' if kk['kk'] else 'OFF'}, image finite, mean {kk['mean']:.6f}; the Chiang model here {chiang:.6f}")
    if not kk["kk"] or bsdf._HAIR_KAJIYA_KAY or kk["mean"] == chiang:
        raise AssertionError(f"the Kajiya-Kay switch did not take effect: {result}")
    return result


# ---------------------------------------------------------------------------
# Phase 9: the user's entry points (app/cli.py, app/usd_runner.py, app/viewer.py)
# ---------------------------------------------------------------------------

ENTRY = Config("entry_points", 1024, 768, 4, 4, 4, CORNELL.kernels)  # the CLI's defaults; -t 16 -f 4
ENTRY_SPP = {"cli": (16, 4), "upscale": (16, 4), "gltf": (8, 2), "usd": (8, 2), "profile": (8, 4), "viewer": (4, 1)}
VIEWER_SIZE = (640, 480)  # app/viewer.py's default
TITLE = r"\[?([0-9.]+) ms\]? \[([0-9]+) spp\]"  # cli.py's and viewer.py's title, usd_runner.py's frame line


def K_reset() -> None:
    import torch

    from strelka_tpu_torch import kernels as K

    torch.cuda.synchronize()
    K.reset_counts()


def K_read():
    """(launch counts, launch shapes) since K_reset; no plain version may have run on CUDA."""
    import torch

    from strelka_tpu_torch import kernels as K

    torch.cuda.synchronize()
    if any(K.plain_cuda_calls.values()):
        raise AssertionError(f"a plain version ran on CUDA: {K.plain_cuda_calls}")
    return dict(K.launch_counts), dict(K.launch_shapes)


def hold_at(scene, host, w: int, h: int, spp: int, where: str) -> None:
    """Every kernel a main path of `scene` launches, held bit for bit against
    its plain version at the shapes a w x h x spp launch gives it (no
    timing): K1 at both dimension lists of a launch; K2/K3 (a flat scene) or
    K5/K6 (a BVH) on the camera, bounce-1 and bounce-0 shadow rays; K4 at the
    attr and light tables and at the launch's packed permutes (order_gathers). K2/K3 are held on every lane against the dense
    plain sweep, K5/K6 against their plain twins (the dense checks of K5/K6
    are phases 3, 4 and 8's)."""
    import torch

    from strelka_tpu_torch.kernels import bvh as KB
    from strelka_tpu_torch.kernels import gather as KG
    from strelka_tpu_torch.kernels import intersect as KI
    from strelka_tpu_torch.kernels import sobol as KS
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW

    from strelka_tpu_torch.ops import integrator as I

    t0 = time.perf_counter()
    cfg = Config(where, w, h, spp, ENTRY.depth, 0, ())
    sample_idx, camera, bounce1, shadow, prims, lid, _ = main_path_rays(scene, launch_params(host, w, h, 0),
                                                                        scene.device, cfg)
    order_gathers(scene, cfg, where, I.pixel_zorder(w, h, scene.device)[1], launch_lanes(scene, cfg, bounce1)[2], False)
    hold_surface(scene.device, sample_idx.shape[0], scene, where)
    hold_shade(scene.device, sample_idx.shape[0], scene, where)
    hold_nee(scene.device, sample_idx.shape[0], scene, where)
    for dims, depths in ((JITTER_DIMS, (0,)), (BOUNCE_DIMS, range(cfg.depth))):
        for depth in depths:
            a = held(lambda: KS.random_dims(sample_idx, depth, dims))
            if not torch.equal(a.view(torch.int32), KS.random_dims_plain(sample_idx, depth, dims).view(torch.int32)):
                raise AssertionError(f"K1 differs from its plain version at depth {depth}, dims {dims} ({where})")
    off = {}
    for rays, mask, label in ((camera, RAY_MASK_PRIMARY, "camera"), (bounce1, RAY_MASK_PRIMARY, "bounce-1"),
                              (shadow, RAY_MASK_SHADOW, "shadow")):
        if scene.bvh is None:
            args = flat_args(scene, rays, mask)
            k2 = held(lambda: KI.intersect_closest(*args, bounds=scene.tri_bounds))
            k3 = held(lambda: KI.intersect_any(*args, bounds=scene.tri_bounds))
            off[label] = (int(closest_lanes(k2, KI.closest_plain(*args)).sum()), int((k3 != KI.any_plain(*args)).sum()))
        else:
            args = bvh_args(scene, rays, mask)
            k5 = held(lambda: KB.bvh_closest(*args))
            k6 = held(lambda: KB.bvh_any(*args))
            off[label] = (closest_off(k5, KB.closest_plain(*args)), int((k6 != KB.any_plain(*args)).sum()))
    for table, idx in ((scene.attr_table, prims), (scene.light_table, lid)):
        idx = torch.clamp(idx, min=0).contiguous()
        a = held(lambda: KG.gather_rows_t(table, idx))
        off[f"K4 {tuple(table.shape)}"] = int(same_bits(a, KG.gather_rows_t_plain(table, idx)).sum())
    torch.cuda.synchronize()
    pair = "K2/K3" if scene.bvh is None else "K5/K6"
    log(f"held at {where} ({w}x{h}, {spp} spp: {sample_idx.shape[0]} lanes x {scene.v0.shape[0]} triangles): K1 "
        f"bit-equal at both dimension lists; lanes off the plain versions ({pair} by ray set, K4 by table): {off} "
        f"(bar: 0, tolerance: none) in {time.perf_counter() - t0:.1f} s")
    if any(v if isinstance(v, int) else any(v) for v in off.values()):
        raise AssertionError(f"a kernel differs from its plain version at {where}: {off}")


def frame_times(stdout: str):
    """(ms, spp) of each frame line an app printed."""
    import re

    return [(float(ms), int(spp)) for ms, spp in re.findall(TITLE, stdout)]


class AppRun(NamedTuple):
    code: int
    stdout: str
    log: str
    wall_s: float
    counts: dict
    shapes: dict


def run_app(module: str, argv: list) -> AppRun:
    """`module`.main(argv) in this process, its standard output and log
    captured, with the launch counts set to 0 just before and read just after."""
    import contextlib
    import importlib
    import io
    import logging

    import torch

    from strelka_tpu_torch import kernels as K

    main_fn = importlib.import_module(module).main
    out, logs = io.StringIO(), io.StringIO()
    handler = logging.StreamHandler(logs)
    logger = logging.getLogger("Strelka")
    logger.addHandler(handler)
    try:
        torch.cuda.synchronize()
        K.reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            code = main_fn(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, shapes, plain = dict(K.launch_counts), dict(K.launch_shapes), dict(K.plain_cuda_calls)
    finally:
        logger.removeHandler(handler)
    if code != 0:
        raise AssertionError(f"{module} {argv} exited {code}: {logs.getvalue()[-2000:]}")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on CUDA in {module} {argv}: {plain}")
    return AppRun(code, out.getvalue(), logs.getvalue(), wall, counts, shapes)


def check_launches(run_counts: dict, shapes: dict, kernels: tuple, what: str) -> None:
    """Every kernel of the path launched, each at a shape held before."""
    missing = [k for k in kernels if not run_counts.get(k)]
    unheld = sorted(k for k in shapes if k not in HELD)
    if missing or unheld:
        raise AssertionError(f"{what}: kernels not launched {missing}; launched at shapes not held against their "
                             f"plain versions {unheld}")


def setup_span(name: str) -> dict:
    """The newest of the recorder's set-up spans of that name (utils/profiling.py)."""
    from strelka_tpu_torch.utils import profiling as P

    return [s for s in P.setup_spans() if s["name"] == name][-1]


def setup_seconds(name: str, span=None) -> float:
    """The seconds of a set-up span: `span`, else the newest of that name."""
    span = span or setup_span(name)
    return (span["end_ns"] - span["start_ns"]) / 1e9


def card_name_and_power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    return smi.stdout.strip()


def app_line(item: str, argv: list, wall_s: float, frames, w: int, h: int, depth: int = 4, **extra) -> dict:
    """One item's JSON line: wall seconds, ms a frame (the app's own frame
    lines: render and the copy of the frame to the host), and FrameStats'
    Mray/s over those frames (2 x depth rays a sample of a w x h frame), all
    of them and all but the first (which builds the device scene)."""
    from strelka_tpu_torch.utils.profiling import FrameStats

    stats, later = FrameStats(window=len(frames) or 1), FrameStats(window=len(frames) or 1)
    prev = 0
    for i, (ms, spp) in enumerate(frames):
        for s in (stats, later) if i else (stats,):
            s.add_frame(ms / 1e3, w * h * max(spp - prev, 0) * 2 * depth)
        prev = spp
    line = dict(entry_point=item, argv=argv, wall_s=wall_s, frames=len(frames), ms_per_frame=[ms for ms, _ in frames],
                ms_per_frame_after_first=later.avg_ms or None, mrays_per_s=stats.mrays_per_sec,
                mrays_per_s_after_first=later.mrays_per_sec, **extra)
    print(json.dumps(line), flush=True)
    return line


def reference_frames(host, w, h, spp_total, spp, *, search_path=None, upscale=None, frames=None):
    """An in-process TorchRender render with the apps' settings -> (the last
    frame [h, w, 4] on the card, ms a launch of each frame: render() to a
    synchronize, no copy to the host, the TorchRender)."""
    import torch

    from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu_torch.render.render import RenderFactory
    from strelka_tpu_torch.settings import SharedContext, make_default_settings

    s = make_default_settings(w, h)
    s.set("render/pt/sppTotal", spp_total)
    s.set("render/pt/spp", spp)
    s.set("render/pt/depth", ENTRY.depth)
    if upscale:
        s.set("render/pt/enableUpscale", True)
        s.set("render/pt/upscaleFactor", upscale)
    if search_path:
        s.set("resource/searchPath", search_path)
    r = RenderFactory.create_render()
    r.set_scene(host)
    ctx = SharedContext(s)
    r.set_shared_context(ctx)
    r.init()
    buf = r.create_buffer(BufferDesc(w, h, BufferFormat.FLOAT4))
    ms = []
    while ctx.subframe_index < spp_total and (frames is None or len(ms) < frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render(buf)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return buf.device(), ms, r


def png_u8(path: str):
    import numpy as np

    from strelka_tpu_torch.utils.image import read_png

    return np.round(read_png(path) * 255.0).astype(np.uint8)


def same_png(path: str, image, what: str) -> None:
    """The PNG an app wrote equals to_uint8 of `image` ([H, W, 4] on the card), flipped as write_png writes it."""
    import numpy as np

    from strelka_tpu_torch.utils.image import to_uint8

    want = to_uint8(image.cpu().numpy()[..., :3])[::-1]
    got = png_u8(path)
    off = int((got != want).any(axis=-1).sum()) if got.shape == want.shape else -1
    log(f"{what}: {os.path.basename(path)} {got.shape} against the in-process render: {off} pixels off (bar: 0)")
    if off:
        raise AssertionError(f"{what}: the app's PNG differs from the in-process render on {off} pixels")


def write_glb(host, path: str) -> int:
    """A host scene as a binary glTF, as GltfLoader reads it: one mesh a
    (geometry, material) pair with POSITION, NORMAL, TEXCOORD_0 and u32
    indices, one node an instance (its matrix), one pbrMetallicRoughness
    material a scene material (base colour, metallic, roughness), the camera
    on a node of its own; the rect lights go to <name>_light.json (the
    loader's sidecar; it has no other light). Returns the triangles written."""
    import struct

    import numpy as np

    from strelka_tpu_torch.scene.scene import InstanceType
    from strelka_tpu_torch.utils import math3d as m3

    blob, views, accessors, meshes, nodes, prims = bytearray(), [], [], [], [], {}

    def add(arr, comp, kind):
        arr = np.ascontiguousarray(arr)
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": arr.nbytes})
        blob.extend(arr.tobytes() + b"\0" * (-arr.nbytes % 4))
        accessors.append({"bufferView": len(views) - 1, "componentType": comp, "count": arr.shape[0], "type": kind})
        return len(accessors) - 1

    tris = 0
    for inst in host.instances:
        if inst.type != InstanceType.eMesh:
            continue
        g = inst.geom_id
        if g not in prims:
            prims[g] = ({"POSITION": add(host.positions[g], 5126, "VEC3"), "NORMAL": add(host.normals[g], 5126, "VEC3"),
                         "TEXCOORD_0": add(host.uvs[g], 5126, "VEC2")},
                        add(host.indices[g].astype(np.uint32), 5125, "SCALAR"))
        key = (g, inst.material_id)
        if key not in prims:
            attrs, idx = prims[g]
            prims[key] = len(meshes)
            meshes.append({"primitives": [{"attributes": attrs, "indices": idx, "material": inst.material_id}]})
        nodes.append({"mesh": prims[key], "matrix": np.asarray(inst.transform, np.float64).T.reshape(-1).tolist()})
        tris += len(host.indices[g]) // 3
    cam = host.get_camera(0)
    w, x, y, z = m3.quat_conjugate(cam.orientation)  # the loader conjugates a camera node's rotation back
    nodes.append({"camera": 0, "translation": [float(v) for v in cam.position],
                  "rotation": [float(x), float(y), float(z), float(w)]})
    materials = []
    for m in host.materials:
        base = m.params.get("diffuse_color_constant", m.color if m.has_color else [0.8, 0.8, 0.8])
        materials.append({"name": m.name, "alphaMode": "OPAQUE", "pbrMetallicRoughness": {
            "baseColorFactor": [float(c) for c in base] + [1.0],
            "metallicFactor": float(m.params.get("metallic_constant", 0.0)),
            "roughnessFactor": float(m.params.get("reflection_roughness_constant", 1.0))}})
    doc = {"asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": list(range(len(nodes)))}], "nodes": nodes,
           "meshes": meshes, "materials": materials, "accessors": accessors, "bufferViews": views,
           "buffers": [{"byteLength": len(blob)}],
           "cameras": [{"type": "perspective", "name": cam.name,
                        "perspective": {"yfov": float(np.radians(cam.fov)), "znear": 0.1, "zfar": 100000.0}}]}
    js = json.dumps(doc).encode()
    js += b" " * (-len(js) % 4)
    with open(path, "wb") as f:
        f.write(struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(js) + 8 + len(blob)))
        f.write(struct.pack("<II", len(js), 0x4E4F534A) + js + struct.pack("<II", len(blob), 0x004E4942) + blob)
    lights = [{"position": [float(v) for v in d.position], "orientation": [float(v) for v in d.orientation],
               "width": float(d.width), "height": float(d.height), "color": [float(v) for v in d.color],
               "intensity": float(d.intensity)} for d in host.light_descs if d.type == 0]
    with open(os.path.splitext(path)[0] + "_light.json", "w") as f:
        json.dump({"lights": lights}, f)
    return tris


def check_band_graphs(scene, host, dev, w: int, h: int, spp: int, depth: int) -> dict:
    """Four bands of one card, each replayed from its own CUDA graph
    (shard_launch(graph_launch=GraphLaunch), as TorchRender(use_sharding=True)
    runs them on a card): BAND_LAUNCHES launches (the first eager, the second
    captured, then replays) against the same bands run eagerly and against
    the unbanded launch, from the same start: every value of the image and
    of each band's state equal to the eager bands', image and accum equal to
    the unbanded launch's, the same kernels at the same shapes launch by
    launch, no band tensor moved between devices on any eager launch. Then
    TorchRender(use_sharding=True, band_devices=[card] * 4) against
    TorchRender on the card, frame by frame, and ms a launch of the eager
    and the replayed bands in turns (eager, graph, graph, eager;
    GRAPH_TIMED launches each, host clock, one synchronize a turn)."""
    import numpy as np
    import torch

    from strelka_tpu_torch import kernels as K
    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.parallel.sharding import make_band_state, shard_launch
    from strelka_tpu_torch.render import render as R
    from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu_torch.settings import SharedContext, make_default_settings

    kw = dict(width=w, samples_per_launch=spp, max_sample_count=MAX_SAMPLE_COUNT, max_depth=depth,
              enable_accumulation=True)
    bh = h // 4

    def make_launch(local_h, full_h):
        def launch(scene, params, state, py_offset):
            state, planar = I.render_launch(scene, params, state, height=local_h, py_offset=py_offset,
                                            full_height=full_h, **kw)
            return state, planar.permute(1, 2, 0)
        return launch

    def off(a, b) -> int:
        return int(same_bits(a.contiguous(), b.contiguous()).sum())

    pool = torch.cuda.graph_pool_handle()
    graphed = shard_launch(make_launch, [dev] * 4, check_devices=True,
                           graph_launch=lambda launch, d: R.GraphLaunch(launch, d, pool))
    eager = shard_launch(make_launch, [dev] * 4, check_devices=True)
    g_state, e_state = make_band_state(h, w, graphed.devices), make_band_state(h, w, eager.devices)
    whole = I.make_frame_state(h, w, dev)
    values_off = dict(eager_bands_image=0, eager_bands_state=0, unbanded_image=0, unbanded_accum=0)
    crossings, counts_off = 0, 0
    for i in range(BAND_LAUNCHES):
        p = launch_params(host, w, h, i * spp)
        p = p._replace(cone_spread=I.ray_cone_spread(p, h))
        (g_state, g_img), g_counts = K.take_counts(lambda: graphed(scene, p, g_state))
        crossings += len(graphed.crossings)
        (e_state, e_img), e_counts = K.take_counts(lambda: eager(scene, p, e_state))
        crossings += len(eager.crossings)
        whole, w_planar = I.render_launch(scene, p, whole, height=h, **kw)
        counts_off += int(g_counts[:2] != e_counts[:2])
        values_off["eager_bands_image"] += off(g_img, e_img)
        values_off["eager_bands_state"] += sum(off(a, b) for gb, eb in zip(g_state.bands, e_state.bands)
                                               for a, b in zip(gb, eb))
        values_off["unbanded_image"] += off(g_img, w_planar.permute(1, 2, 0))
        values_off["unbanded_accum"] += sum(off(b.accum, whole.accum[:, j * bh:(j + 1) * bh])
                                            for j, b in enumerate(g_state.bands))
    captured = sum(fn.graph is not None for fn in graphed.bands[bh])

    # TorchRender, banded on the card, against TorchRender unbanded
    s = make_default_settings(w, h)
    s.set("render/pt/spp", spp)
    s.set("render/pt/sppTotal", spp * BAND_LAUNCHES)
    s.set("render/pt/depth", depth)
    renders = []
    for sharded in (False, True):
        r = R.TorchRender(device=dev, use_sharding=sharded, band_devices=[dev] * 4 if sharded else None)
        r.set_scene(host)
        r.set_shared_context(SharedContext(s))
        r.init()
        renders.append((r, r.create_buffer(BufferDesc(w, h, BufferFormat.FLOAT4))))
    torchrender_off = 0
    for _ in range(BAND_LAUNCHES):
        for r, buf in renders:
            r.render(buf)
        torchrender_off += off(renders[0][1].device(), renders[1][1].device())
    (banded_fn,) = renders[1][0]._launch_cache.values()
    tr_graphs = sum(getattr(fn, "graph", None) is not None for fn in banded_fn.bands[bh])

    # ms a launch, eager bands against replayed bands, in turns
    sub = BAND_LAUNCHES * spp
    turns = []
    for kind in ("eager", "graph", "graph", "eager"):
        fn, st = (eager, e_state) if kind == "eager" else (graphed, g_state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_TIMED):
            p = launch_params(host, w, h, sub)
            st, _ = fn(scene, p._replace(cone_spread=I.ray_cone_spread(p, h)), st)
            sub += spp
        torch.cuda.synchronize()
        turns.append((kind, (time.perf_counter() - t0) / GRAPH_TIMED * 1e3))
        if kind == "eager":
            e_state = st
        else:
            g_state = st
    eager_ms = statistics.mean(t for k, t in turns if k == "eager")
    graph_ms = statistics.mean(t for k, t in turns if k == "graph")
    result = dict(bands=4, band_rows=bh, launches=BAND_LAUNCHES, values_off=values_off, crossings=crossings,
                  launch_counts_off=counts_off, band_graphs_captured=captured, torchrender_values_off=torchrender_off,
                  torchrender_band_graphs=tr_graphs, eager_ms_per_launch=eager_ms, graph_ms_per_launch=graph_ms,
                  turns=[(k, round(t, 3)) for k, t in turns], card=card_name_and_power_limit())
    log(f"3. four bands of {bh} rows replayed from their own graphs, {BAND_LAUNCHES} launches {w}x{h} {spp} spp: "
        f"values off {values_off}, crossings {crossings}, launches with other counts {counts_off}, band graphs "
        f"captured {captured} of 4 (bar: 0, 0, 0, 4); TorchRender 4 bands against unbanded: {torchrender_off} values "
        f"off, {tr_graphs} of 4 band graphs; ms a launch eager {eager_ms:.3f}, replayed {graph_ms:.3f} "
        f"(turns {result['turns']})")
    if any(values_off.values()) or crossings or counts_off or captured != 4 or torchrender_off or tr_graphs != 4:
        raise AssertionError(f"band graphs: {result}")
    if not np.isfinite(g_img.cpu().numpy()).all():
        raise AssertionError("band graphs: non-finite image")
    return result


BAND_LAUNCHES = 4  # launches of the band-graph check (eager, capture, replays)


def phase_entry_points(dev, t_start):
    """Phase 9 -> (the JSON lines' items, the summed launch counts of the apps' counted runs)."""
    import re
    import shutil
    import tempfile

    import torch

    from strelka_tpu_torch.app.cli import load_scene
    from strelka_tpu_torch.loaders.usd import UsdLoader
    from strelka_tpu_torch.parallel.sharding import make_band_state, shard_launch
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.render.render import resize_bilinear
    from strelka_tpu_torch.scene import testscenes as TS
    from strelka_tpu_torch.scene.kitchen import ensure_kitchen
    from strelka_tpu_torch.scene.scene import Scene
    from strelka_tpu_torch.kernels.intersect import pick_schedule
    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.utils.profiling import summarize_trace

    t_phase = time.perf_counter()
    card = card_name_and_power_limit()
    log(f"entry points on {card}")
    tmp = tempfile.mkdtemp(prefix="strelka_entry_")
    w, h = ENTRY.width, ENTRY.height
    size = [] if (w, h) == (1024, 768) else ["--width", str(w), "--height", str(h)]  # the apps' default size
    items, total = [], {}

    def line(*args, **kw):  # an item's JSON line, the card beside its numbers
        items.append(app_line(*args, card=card, **kw))

    def shown(argv):  # an item's arguments as its JSON line gives them: files in the temporary directory by name
        return [a.replace(tmp, "<tmp>") if a.startswith(tmp) else os.path.relpath(a, REPO) if a.startswith(REPO) else a
                for a in argv]

    def counted(run: AppRun, kernels: tuple, what: str) -> None:
        check_launches(run.counts, run.shapes, kernels, what)
        for k, v in run.counts.items():
            total[k] = total.get(k, 0) + v

    try:
        # ---- Cornell through the CLI: the kernels held at every shape the items give them
        cornell = load_scene("builtin://cornell_box")
        cscene = build_device_scene(cornell, device=dev)
        for cw, ch, spp, where in ((w, h, 4, "the CLI's Cornell"),
                                   (w // 2, h // 2, 4, "the CLI's Cornell at upscale 0.5 and in 4 bands"),
                                   (*VIEWER_SIZE, 1, "the viewer's Cornell")):
            hold_at(cscene, cornell, cw, ch, spp, where)

        # 1. python -m strelka_tpu_torch.app.cli, Cornell, the defaults (1024x768, depth 4), 16 spp in 4 frames
        png1 = os.path.join(tmp, "cli_cornell.png")
        argv1 = ["-s", "builtin://cornell_box", "-t", "16", "-f", "4", "-o", png1, *size]
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "strelka_tpu_torch.app.cli", *argv1], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=600)
        wall1 = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"the CLI exited {proc.returncode}: {proc.stderr[-3000:]}")
        sub_counts = json.loads(re.search(r"Kernel launches: (\{.*\})", proc.stderr).group(1))
        check_launches(sub_counts, {}, CORNELL.kernels, "1. the CLI's subprocess (its shapes: the in-process render's)")
        K_reset()
        ref1, ref1_ms, _ = reference_frames(load_scene("builtin://cornell_box"), w, h, 16, 4)
        check_launches(*K_read(), CORNELL.kernels, "the in-process Cornell render")
        same_png(png1, ref1, f"1. CLI (python -m, a subprocess), Cornell {w}x{h} 16 spp in 4 frames")
        for k, v in sub_counts.items():
            total[k] = total.get(k, 0) + v
        line("cli_cornell", shown(argv1), wall1, frame_times(proc.stdout), w, h,
             launch_counts=sub_counts, schedule=pick_schedule(cscene.v0.shape[0], False),
             torchrender_ms_per_launch=ref1_ms, image_mean=float(ref1[..., :3].mean()))

        # 2. --upscale 0.5: traced at 512x384, resized to 1024x768
        png2 = os.path.join(tmp, "cli_upscale.png")
        argv2 = ["-s", "builtin://cornell_box", "-t", "16", "-f", "4", "--upscale", "0.5", "-o", png2, *size]
        run = run_app("strelka_tpu_torch.app.cli", argv2)
        counted(run, CORNELL.kernels, "2. CLI --upscale 0.5")
        traced, traced_ms, _ = reference_frames(load_scene("builtin://cornell_box"), w // 2, h // 2, 16, 4)
        on_card = resize_bilinear(traced, h, w)
        resize_err = float((on_card.cpu() - resize_bilinear(traced.cpu(), h, w)).abs().max())
        log(f"2. upscale: the card's resize of the {w // 2}x{h // 2} trace against the CPU's: max abs {resize_err:.3e} "
            f"(bar: 1e-6)")
        if resize_err > 1e-6 or tuple(traced.shape) != (h // 2, w // 2, 4):
            raise AssertionError(f"upscale: resize off the CPU's by {resize_err}, traced {tuple(traced.shape)}")
        same_png(png2, on_card, "2. CLI --upscale 0.5 (in-process)")
        line("cli_upscale", shown(argv2), run.wall_s, frame_times(run.stdout), w, h,
             launch_counts=run.counts, traced=[w // 2, h // 2], resize_max_abs_err=resize_err,
             torchrender_ms_per_launch=traced_ms)

        # 3. --multichip: one band on one card equals item 1; then 4 bands of 192 rows on the card repeated
        png3 = os.path.join(tmp, "cli_multichip.png")
        argv3 = ["-s", "builtin://cornell_box", "-t", "16", "-f", "4", "--multichip", "-o", png3, *size]
        run = run_app("strelka_tpu_torch.app.cli", argv3)
        counted(run, CORNELL.kernels, "3. CLI --multichip")
        off3 = int((png_u8(png3) != png_u8(png1)).any(axis=-1).sum())
        log(f"3. CLI --multichip on {torch.cuda.device_count()} card(s): {off3} pixels off item 1's PNG (bar: 0)")
        if off3:
            raise AssertionError(f"--multichip's image differs from the unbanded CLI's on {off3} pixels")
        kw = dict(width=w, samples_per_launch=4, max_sample_count=16, max_depth=ENTRY.depth, enable_accumulation=True)
        params = launch_params(cornell, w, h, 0)

        def make_launch(local_h, full_h):
            def launch(scene, params, state, py_offset):
                state, planar = I.render_launch(scene, params, state, height=local_h, py_offset=py_offset,
                                                full_height=full_h, **kw)
                return state, planar.permute(1, 2, 0)
            return launch

        K_reset()
        whole_state, whole = I.render_launch(cscene, params, I.make_frame_state(h, w, dev), height=h, **kw)
        banded = shard_launch(make_launch, [dev] * 4, check_devices=True)
        bands, image = banded(cscene, params, make_band_state(h, w, banded.devices))
        torch.cuda.synchronize()
        counts3, shapes3 = K_read()
        check_launches(counts3, shapes3, CORNELL.kernels, "3. four bands")
        off_img = int(same_bits(image, whole.permute(1, 2, 0)).sum())
        off_acc = sum(int(same_bits(b.accum, whole_state.accum[:, i * (h // 4):(i + 1) * (h // 4)]).sum())
                      for i, b in enumerate(bands.bands))
        log(f"3. shard_launch over the card 4 times ({h // 4}-row bands, one launch {w}x{h} 4 spp): values off the "
            f"unbanded launch: image {off_img}, accum {off_acc}; band tensors moved between devices "
            f"{len(banded.crossings)} (bar: 0 for all three)")
        if off_img or off_acc or banded.crossings:
            raise AssertionError(f"four bands: image {off_img}, accum {off_acc} values off, "
                                 f"crossings {banded.crossings}")
        band_graphs = check_band_graphs(cscene, cornell, dev, w, h, 4, ENTRY.depth)
        line("cli_multichip", shown(argv3), run.wall_s, frame_times(run.stdout), w, h,
             launch_counts=run.counts, torchrender_ms_per_launch=ref1_ms,
             bands_off=dict(image=off_img, accum=off_acc, crossings=len(banded.crossings)), band_graphs=band_graphs)

        # 4. the CLI on a glTF: box_field(grid=48) as a .glb, 411,652 triangles on a BVH
        glb = os.path.join(tmp, "box_field.glb")
        t0 = time.perf_counter()
        written = write_glb(TS.box_field(grid=BOX_GRID), glb)
        write_s = time.perf_counter() - t0
        gl_ref, gl_ms, rg = reference_frames(load_scene(glb), w, h, 8, 2, search_path=tmp, frames=2)
        gscene = rg._device_scene
        if gscene.bvh is None or gscene.num_triangles != BOX_TRIANGLES:
            raise AssertionError(f"the glTF must build {BOX_TRIANGLES} triangles on a BVH: {gscene.num_triangles}")
        hold_at(gscene, rg.get_scene(), w, h, 2, "the glTF box_field")
        png4 = os.path.join(tmp, "cli_gltf.png")
        argv4 = ["-s", glb, "-t", "8", "-f", "2", "-o", png4, *size]
        run = run_app("strelka_tpu_torch.app.cli", argv4)
        counted(run, BOX.kernels, "4. CLI on box_field.glb")
        img4 = png_u8(png4)
        load_s = float(re.search(r"Scene loaded in ([0-9.]+)s", run.log).group(1))
        bvh_s = setup_seconds("bvh.build")  # the CLI's build, in this process
        log(f"4. CLI on box_field.glb ({os.path.getsize(glb)} bytes, {written} triangles written in {write_s:.2f} s): "
            f"loaded in {load_s:.3f} s, BVH built in {bvh_s:.2f} s; K5 {run.counts['bvh_closest']} and K6 "
            f"{run.counts['bvh_any']} launches; PNG mean {img4.mean():.3f}")
        if not img4.mean() > 0 or not bool(torch.isfinite(gl_ref).all()):
            raise AssertionError("the glTF render is black or not finite")
        line("cli_gltf", shown(argv4), run.wall_s, frame_times(run.stdout), w, h, launch_counts=run.counts,
             triangles=gscene.num_triangles, load_s=load_s, bvh_build_s=bvh_s,
             torchrender_ms_per_launch=gl_ms, png_mean=float(img4.mean()))
        del gscene, rg, gl_ref

        # 5. the USD runner (through the Hydra delegate): kitchen and coffeetable at 1024x768, 8 spp in 4 frames
        for name, path, kernels in (("kitchen", ensure_kitchen(), BOX.kernels),
                                    ("coffeetable", os.path.join(REPO, COFFEETABLE_USD), CORNELL.kernels)):
            stage = Scene()
            if not UsdLoader().load(path, stage):
                raise AssertionError(f"{path} failed to load")
            ref5, ms5, r5 = reference_frames(stage, w, h, 8, 2, search_path=os.path.dirname(os.path.abspath(path)))
            hold_at(r5._device_scene, stage, w, h, 2, f"the USD runner's {name}")
            png5 = os.path.join(tmp, f"usd_{name}.png")
            argv5 = ["-s", path, "-t", "8", "-f", "2", "-o", png5, *size]
            run = run_app("strelka_tpu_torch.app.usd_runner", argv5)
            counted(run, kernels, f"5. usd_runner {name}")
            same_png(png5, ref5, f"5. usd_runner {name} {w}x{h} 8 spp in 4 frames")
            line(f"usd_runner_{name}", shown(argv5), run.wall_s, frame_times(run.stdout), w, h,
                 launch_counts=run.counts, torchrender_ms_per_launch=ms5, image_mean=float(ref5[..., :3].mean()))
            del r5, ref5

        # 6. --profile on a 2-frame Cornell CLI run
        trace = os.path.join(tmp, "profile")
        argv6 = ["-s", "builtin://cornell_box", "-t", "8", "-f", "4", *size, "--profile", trace]
        run = run_app("strelka_tpu_torch.app.cli", argv6)
        counted(run, CORNELL.kernels, "6. CLI --profile")
        top = summarize_trace(trace, top=10)
        want = f"tri_{pick_schedule(cscene.v0.shape[0], False)}_kernel"
        log(f"6. CLI --profile: summarize_trace's top 10: " + "; ".join(f"{n[:60]} {ms:.3f} ms" for n, ms in top))
        if not any(want in name for name, _ in top):
            raise AssertionError(f"the profile's top 10 does not name {want}: {top}")
        line("cli_profile", shown(argv6), run.wall_s, frame_times(run.stdout), w, h,
             launch_counts=run.counts, torchrender_ms_per_launch=ref1_ms,
             profile_top10=[[n, ms] for n, ms in top], names=want)

        # 7. the viewer: 4 frames at its 640x480 default, headless, the frame streamed to a PNG
        png7 = os.path.join(tmp, "view.png")
        argv7 = ["-s", "builtin://cornell_box", "--width", str(VIEWER_SIZE[0]), "--height", str(VIEWER_SIZE[1]),
                 "--frames", "4", "--png-stream", png7]
        from strelka_tpu_torch.display.display import HeadlessDisplay

        title = HeadlessDisplay.set_window_title
        HeadlessDisplay.set_window_title = lambda self, text: (title(self, text), print(text))  # its frame lines
        try:
            run = run_app("strelka_tpu_torch.app.viewer", argv7)
        finally:
            HeadlessDisplay.set_window_title = title
        counted(run, CORNELL.kernels, "7. viewer")
        if not os.path.exists(png7) or png_u8(png7).shape != (VIEWER_SIZE[1], VIEWER_SIZE[0], 3):
            raise AssertionError("the viewer wrote no 640x480 PNG")
        _, ref7_ms, _ = reference_frames(load_scene("builtin://cornell_box"), *VIEWER_SIZE, 512, 1, frames=4)
        line("viewer", shown(argv7), run.wall_s, frame_times(run.stdout), *VIEWER_SIZE,
             launch_counts=run.counts, torchrender_ms_per_launch=ref7_ms,
             png_mean=float(png_u8(png7).mean()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[{time.perf_counter() - t_start:.0f} s] entry-point phase done in {time.perf_counter() - t_phase:.1f} s")
    return items, dict(scene="entry_points", launch_counts=total)


# ---------------------------------------------------------------------------
# Phase 13: the accelerator path's wavefront order (ops/integrator.py)
# ---------------------------------------------------------------------------

ORDER = []  # one result a main path: the values off, the per-ray counts, K4's permutes
ORDER_AB = []  # one result a main path: TorchRender's replayed launches, ordered against unordered
AB_TIMED = 8  # replayed launches in each turn of the A/B


class order_patched:
    """Within the block, render_launch takes another wavefront order: "unordered"
    (row-major, no sort: integrator.accelerated answers False, as on the
    CPU), "zorder" (Z-order, no sort: sort_by_default answers False) or
    "ordered" (the card's defaults, nothing patched)."""

    def __init__(self, variant: str):
        self.variant = variant

    def __enter__(self):
        from strelka_tpu_torch.ops import integrator as I

        self.saved = (I.accelerated, I.sort_by_default)
        if self.variant == "unordered":
            I.accelerated = lambda scene: False
        elif self.variant == "zorder":
            I.sort_by_default = lambda scene: False
        elif self.variant != "ordered":
            raise ValueError(self.variant)
        return self

    def __exit__(self, *exc):
        from strelka_tpu_torch.ops import integrator as I

        I.accelerated, I.sort_by_default = self.saved
        return False


def permute_rays(rays: dict, lanes):
    """A ray set (main_path_rays' dicts) with its lanes in the order `lanes` gives."""
    return {k: type(v)(*(c[lanes] for c in v)) if isinstance(v, tuple) else v[lanes] for k, v in rays.items()}


def launch_lanes(scene, cfg: Config, bounce1: dict):
    """The lane orders of the card's launch over main_path_rays' row-major
    lanes: (Z-order: lane k of the ordered wavefront is row-major lane
    z[k]; the bounce-1 order: after the sort of bounce 1 where the scene
    sorts, as integrator._sort_wavefront orders these rays, else z; the
    sort's permutation of the Z-ordered lanes, or None)."""
    import torch

    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.ops.vec import Vec3

    n = cfg.width * cfg.height
    zorder, _ = I.pixel_zorder(cfg.width, cfg.height, scene.device)
    z = (zorder[None, :] + n * torch.arange(cfg.spp, device=scene.device)[:, None]).reshape(-1)
    if not I.sort_by_default(scene):
        return z, z, None
    b1 = permute_rays(bounce1, z)
    key = torch.where(b1["tmax"] > b1["tmin"], I._ray_sort_key(scene, Vec3(*b1["o"]), Vec3(*b1["d"])), I.DEAD_KEY)
    perm = torch.sort(key, stable=True).indices
    return z, z[perm], perm


def order_tables(n: int, cols: int, dev, seed: int):
    """An [n, cols] int32 table of the words a packed permute carries: f32
    bits, int values under 2^23 (f32 subnormals when read as floats), NaN
    patterns of both signs, 0/1 flags."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    words = rng.integers(-(2**31), 2**31, (n, cols), dtype=np.int64).astype(np.int32)
    words[:, 0::4] = rng.integers(-(2**23), 2**23, (n, len(range(0, cols, 4))))
    words[:, 1::4] = rng.integers(0x7F800001, 0x7FFFFFFF, (n, len(range(1, cols, 4)))) | (rng.integers(0, 2, (n, 1)) << 31)
    words[:, 2::4] = rng.integers(0, 2, (n, len(range(2, cols, 4))))
    return torch.tensor(words, device=dev)


def order_gathers(scene, cfg_like, where: str, z_inv, sort_perm, timed: bool):
    """K4 at the packed permutes of a launch of `cfg_like`'s size: the
    Z-order restore [n, 11] by the inverse Z-order, and where the scene
    sorts the sort's permute [N, 21] by `sort_perm` and the radiance
    restore [N, 4] by its inverse; each held bit for bit against the plain
    gather on order_tables' words. timed: gather_row's rows (times, bound,
    index_select), else only held."""
    import torch

    from strelka_tpu_torch.kernels import gather as KG

    n = cfg_like.width * cfg_like.height
    m = n * cfg_like.spp
    jobs = [(order_tables(n, 11, scene.device, 11), z_inv.to(torch.int32), "Z-order restore [n, 11]")]
    if sort_perm is not None:
        inv = torch.empty_like(sort_perm).scatter_(0, sort_perm, torch.arange(m, device=scene.device))
        jobs += [(order_tables(m, 21, scene.device, 21), sort_perm.to(torch.int32), "sort permute [N, 21]"),
                 (order_tables(m, 4, scene.device, 4), inv.to(torch.int32), "radiance restore [N, 4]")]
    rows = []
    for table, perm, what in jobs:
        table = table.view(torch.float32)
        if timed:
            rows.append(gather_row(table, perm, f"{where} {what}"))
        else:
            a = held(lambda: KG.gather_rows_t(table, perm))
            if same_bits(a, KG.gather_rows_t_plain(table, perm)).any():
                raise AssertionError(f"K4 differs from its plain version at {where} {what}")
    return rows


def warp_max_mean(counts, live) -> float:
    """The mean over 32-lane warps that hold a live lane of the warp's most
    work (a one-ray-a-thread kernel runs each warp for its longest walk)."""
    import torch

    m = counts.shape[0] // 32 * 32
    c = torch.where(live, counts, 0)[:m].view(-1, 32).to(torch.float32)
    busy = live[:m].view(-1, 32).any(1)
    return float(c.max(1).values[busy].mean())


def order_counts(scene, cfg: Config, rays: dict, lanes) -> dict:
    """The walks' work a live ray (a tile for K9) and the kernels' times, on
    the bounce-1 and bounce-0 shadow rays in row-major order (`row`) and in
    the card's launch order (`ordered`: the bounce-1 rays as sorted, the
    shadow rays, bounce 0's, in Z-order): K5 boxes and K6 boxes (child rows
    x 2) a live ray, their mean per-warp maxima; K7 boxes and cones a live
    ray, their mean per-warp maxima."""
    from strelka_tpu_torch.kernels import bvh as KB
    from strelka_tpu_torch.kernels import cones as KC
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW

    z, b1_lanes = lanes
    out = {}
    for label, b1, sh in (("row", rays["bounce1"], rays["shadow"]),
                          ("ordered", permute_rays(rays["bounce1"], b1_lanes), permute_rays(rays["shadow"], z))):
        res = {}
        if scene.bvh is not None:
            a5, a6 = bvh_args(scene, b1, RAY_MASK_PRIMARY), bvh_args(scene, sh, RAY_MASK_SHADOW)
            live5, live6 = a5[3] > a5[2], a6[3] > a6[2]
            nodes5 = KB.bvh_closest(*a5, stats=True)[4]
            nodes6 = KB.bvh_any(*a6, stats=True)[1]
            res.update(k5_boxes_per_live_ray=float(nodes5[live5].float().mean()),
                       k5_warp_max_boxes=warp_max_mean(nodes5, live5),
                       k5_ms=time_ms(lambda: KB.bvh_closest(*a5), samples=10, inner=3),
                       k6_boxes_per_live_ray=float(nodes6[live6].float().mean()),
                       k6_warp_max_boxes=warp_max_mean(nodes6, live6),
                       k6_ms=time_ms(lambda: KB.bvh_any(*a6), samples=10, inner=3))
        if scene.has_curves:
            o, d, tmin, tmax, pc = cone_args(scene, b1)
            st = KC.cone_closest(o, d, tmin, tmax, pc, stats=True)[3]
            live = tmax > tmin
            res.update(k7_boxes_per_live_ray=float(st.per_ray[0][live].float().mean()),
                       k7_cones_per_live_ray=float(st.per_ray[2][live].float().mean()),
                       k7_warp_max_cones=warp_max_mean(st.per_ray[2], live),
                       k7_ms=time_ms(lambda: KC.cone_closest(o, d, tmin, tmax, pc), samples=10, inner=3))
        out[label] = res
    return out


def launch_values_off(scene, host, cfg: Config, a: str, b: str, sort_a=None, sort_b=None) -> dict:
    """One eager launch of the main path in order `a` against one in order
    `b` (order_patched's variants; sort_a / sort_b render_launch's
    sort_rays), from the same empty state: the f32 words and counters that
    differ in the image and each FrameState field."""
    from strelka_tpu_torch.ops import integrator as I

    kw = main_path_kw(cfg)
    params = launch_params(host, cfg.width, cfg.height, 0)
    outs = []
    for variant, sort_rays in ((a, sort_a), (b, sort_b)):
        with order_patched(variant):
            st, img = I.render_launch(scene, params, I.make_frame_state(cfg.height, cfg.width, scene.device),
                                      sort_rays=sort_rays, **kw)
        outs.append((img, *st))
    names = ("image",) + I.FrameState._fields
    return {name: int(same_bits(x, y).sum()) if x.is_floating_point() else int((x != y).sum())
            for name, x, y in zip(names, *outs)}


def phase_order(scene, host, cfg: Config):
    """Phase 13 on one main path, before its main-path phase: (1) K4 held and
    timed at the path's packed permutes (Z-order restore, and where the
    scene sorts, the sort's permute and the radiance restore), on the
    permutations the launch makes of its real rays; (2) one eager launch
    ordered (Z-order, and the sort where sort_by_default) against one
    unordered (row-major, no sort): 0 values off on an untextured scene; on
    a textured one (kitchen) the sort on against off with Z-order held: 0
    off, and ordered against unordered counted (the texels are keyed by
    Z-rank); (3) order_counts. -> K4's rows (bounds finished)."""
    import torch

    from strelka_tpu_torch.ops import integrator as I

    t0 = time.perf_counter()
    rays = dict(zip(("sample_idx", "camera", "bounce1", "shadow"),
                    main_path_rays(scene, launch_params(host, cfg.width, cfg.height, 0), scene.device, cfg)[:4]))
    z, b1_lanes, sort_perm = launch_lanes(scene, cfg, rays["bounce1"])
    _, z_inv = I.pixel_zorder(cfg.width, cfg.height, scene.device)
    rows = order_gathers(scene, cfg, f"{cfg.name} {cfg.width}x{cfg.height} {cfg.spp} spp", z_inv, sort_perm, True)
    finish_bounds(rows)
    sorts = I.sort_by_default(scene)
    result = dict(scene=cfg.name, sorts=sorts, textured=scene.textures is not None)
    if scene.textures is None:
        result["ordered_vs_unordered_off"] = launch_values_off(scene, host, cfg, "ordered", "unordered")
        bar = result["ordered_vs_unordered_off"]
    else:
        result["sort_on_vs_off_off"] = launch_values_off(scene, host, cfg, "ordered", "ordered", True, False)
        result["ordered_vs_unordered_off"] = launch_values_off(scene, host, cfg, "ordered", "unordered")
        bar = result["sort_on_vs_off_off"]
    if sorts and scene.textures is None:
        result["zorder_vs_unordered_off"] = launch_values_off(scene, host, cfg, "zorder", "unordered")
        bar = {k: bar[k] + result["zorder_vs_unordered_off"][k] for k in bar}
    torch.cuda.synchronize()
    result["counts"] = order_counts(scene, cfg, rays, (z, b1_lanes))
    result["k4_permutes"] = [dict(at=r["at"], shape=list(r["shape"]), ms=r["ms"], device_ms=r["device_ms"],
                                  bound_ms=r["bound_ms"], plain_ms=r["plain_ms"], library_ms=r["library_ms"])
                             for r in rows]
    result["phase_seconds"] = time.perf_counter() - t0
    ORDER.append(result)
    log(f"wavefront order on {cfg.name} (sorts: {sorts}, textured: {result['textured']}): values off "
        f"{ {k: v for k, v in result.items() if k.endswith('_off')} } (bar: 0 for "
        f"{'sort on against off, Z-order held' if result['textured'] else 'ordered against unordered'}); "
        f"work a live ray {result['counts']}; K4 " +
        "; ".join(f"{r['at']}: {r['ms']:.4f} ms (alone {r['device_ms']:.4f}), bound {r['bound_ms']:.4f}, "
                  f"index_select {r['library_ms']:.4f}" for r in rows) + f"; {result['phase_seconds']:.1f} s")
    if any(bar.values()):
        raise AssertionError(f"{cfg.name}: the ordered launch differs: {bar}")
    return rows


def phase_order_ab(scene, host, cfg: Config):
    """The A/B of the order on one main path, after its launch-cache phase:
    TorchRender's replayed launches (the path's config, sample budget
    MAX_SAMPLE_COUNT) ordered, unordered and, where the scene sorts,
    Z-order alone, each variant its own renderer (its first launch eager,
    its second captured, under the variant's order), timed in turns A B C
    C B A, AB_TIMED replays a turn, host clock, one synchronize a turn."""
    import torch

    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.render import render as R
    from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu_torch.settings import SharedContext, make_default_settings

    t0 = time.perf_counter()
    w, h = cfg.width, cfg.height
    variants = ["ordered", "unordered"] + (["zorder"] if I.sort_by_default(scene) else [])
    renders = {}
    for v in variants:
        s = make_default_settings(w, h)
        s.set("render/pt/spp", cfg.spp)
        s.set("render/pt/sppTotal", MAX_SAMPLE_COUNT)
        s.set("render/pt/depth", cfg.depth)
        r = R.TorchRender(device=scene.device)
        r.set_scene(host)
        r._device_scene, host.dirty = scene, False  # the path's device scene, as set_scene builds it
        r.set_shared_context(SharedContext(s))
        r.init()
        buf = r.create_buffer(BufferDesc(w, h, BufferFormat.FLOAT4))
        with order_patched(v):
            r.render(buf)  # eager
            r.render(buf)  # captured and replayed
        renders[v] = (r, buf)
    turns = []
    for v in variants + variants[::-1]:
        r, buf = renders[v]
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(AB_TIMED):
            r.render(buf)
        torch.cuda.synchronize()
        turns.append((v, (time.perf_counter() - t1) / AB_TIMED * 1e3))
    ms = {v: statistics.mean(t for k, t in turns if k == v) for v in variants}
    result = dict(scene=cfg.name, config=f"{w}x{h} spp={cfg.spp} depth={cfg.depth}", replayed_ms_per_launch=ms,
                  turns=turns, card=card_name_and_power_limit(), phase_seconds=time.perf_counter() - t0)
    ORDER_AB.append(result)
    log(f"order A/B {cfg.name} {result['config']}: replayed ms a launch " +
        ", ".join(f"{v} {t:.3f}" for v, t in ms.items()) + f" (turns {[(k, round(t, 3)) for k, t in turns]}); "
        f"{result['phase_seconds']:.1f} s")
    del renders
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 14: the north-star showcase (scripts/torch_northstar.py), cut and resumed
# ---------------------------------------------------------------------------

SHOWCASE_SPP = 32  # a 1024x768 kitchen of 32 spp, cut at 16 by --max-seconds at its checkpoint
SHOWCASE_ARGS = ["--w", "1024", "--h", "768", "--spl", "2", "--depth", "4", "--ckpt-every", "8"]


def phase_showcase(t_start) -> dict:
    """scripts/torch_northstar.py at 1024x768, depth 4, SHOWCASE_SPP spp, 2 a
    launch, a checkpoint every 8 launches: (1) in a child process with
    --max-seconds 1e-9, which stops at its first checkpoint (16 spp) and
    exits 0; (2) resumed through its main(argv) in this process, to the end;
    (3) an uninterrupted run through main(argv). The resumed accumulator,
    AOVs, counters and sample count equal the uninterrupted run's bit for
    bit; both PNGs are written."""
    import shutil
    import tempfile

    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_northstar as NS

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="strelka_northstar_")
    try:
        def argv(name):
            return [*SHOWCASE_ARGS, "--spp", str(SHOWCASE_SPP), "--ckpt", os.path.join(tmp, f"{name}.npz"),
                    "--image", os.path.join(tmp, f"{name}.png"), "--out-json", os.path.join(tmp, f"{name}.json")]

        script = os.path.join(REPO, "scripts", "torch_northstar.py")
        proc = subprocess.run([sys.executable, script, *argv("cut"), "--max-seconds", "1e-9"], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"torch_northstar.py (cut) exited {proc.returncode}: {proc.stderr[-3000:]}")
        with np.load(os.path.join(tmp, "cut.npz")) as data:
            cut_spp = int(data["subframe_index"])
        cut_s = time.perf_counter() - t0
        if cut_spp != SHOWCASE_SPP // 2 or os.path.exists(os.path.join(tmp, "cut.png")):
            raise AssertionError(f"the cut run stopped at {cut_spp} spp, not {SHOWCASE_SPP // 2}, or wrote an image")
        t1 = time.perf_counter()
        if NS.main(argv("cut")) != 0:
            raise AssertionError("torch_northstar.py did not resume")
        resume_s = time.perf_counter() - t1
        t1 = time.perf_counter()
        if NS.main(argv("full")) != 0:
            raise AssertionError("torch_northstar.py (uninterrupted) failed")
        full_s = time.perf_counter() - t1
        arrays = []
        for name in ("cut", "full"):
            with np.load(os.path.join(tmp, f"{name}.npz")) as data:
                arrays.append({k: data[k].copy() for k in data.files if k.startswith("state_") or k == "subframe_index"})
        off = {k: int((arrays[0][k] != arrays[1][k]).sum()) for k in arrays[1]}
        with open(os.path.join(tmp, "full.json")) as f:
            row = json.load(f)
        pngs = {name: os.path.getsize(os.path.join(tmp, f"{name}.png")) for name in ("cut", "full")}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    result = dict(config=row["config"], cut_at_spp=cut_spp, values_off=off, png_bytes=pngs,
                  cut_run_s=cut_s, resume_s=resume_s, uninterrupted_s=full_s, uninterrupted_row=row,
                  phase_seconds=time.perf_counter() - t0)
    log(f"showcase: torch_northstar.py {row['config']} cut at {cut_spp} spp in a child ({cut_s:.1f} s), resumed "
        f"({resume_s:.1f} s): values off the uninterrupted run ({full_s:.1f} s, {row['value']:.2f} s by its own "
        f"clock, {row['padded_mrays_per_s']:.1f} padded Mrays/s) {off} (bar: 0); PNGs {pngs} bytes; "
        f"[{time.perf_counter() - t_start:.0f} s]")
    if any(off.values()) or not row["complete"] or not all(pngs.values()):
        raise AssertionError(f"the resumed showcase differs from the uninterrupted one: {off}, row {row}")
    return result


# ---------------------------------------------------------------------------
# Phase 15: kernel K10, the BSDF phase
# ---------------------------------------------------------------------------

SHADE_EDGES = (1, 1023, 2 ** 20 + 3)  # one lane, a short last block, a ragged edge past 2^20
SHADE_TIMED = (786432, 196608)  # the benchmark's wavefronts: 1024x768 and 512x384 at 1 spp
# bytes K10 moves a lane: a lane that hit a surface reads 39 f32 words, its
# type, first event (int32) and sample index (int64) and four flags; one
# that did not reads its state (8 words, 2 flags); every lane writes 15
# words and 3 flags
SHADE_HIT_BYTES = 39 * 4 + 4 + 4 + 8 + 4
SHADE_DEAD_BYTES = 7 * 4 + 2
SHADE_OUT_BYTES = 15 * 4 + 3


@contextlib.contextmanager
def hair_lobes(variant: int):
    """ops/bsdf.py's hair lobes set to those of a kernel instance (K10, K12)
    while inside: the wrappers then launch that instance, and the plain
    versions take the same lobes."""
    from strelka_tpu_torch.kernels import lanes as L
    from strelka_tpu_torch.ops import bsdf as B

    kk = B._HAIR_KAJIYA_KAY
    B._HAIR_KAJIYA_KAY = variant == L.KAJIYA_KAY
    try:
        yield
    finally:
        B._HAIR_KAJIYA_KAY = kk


def hold_shade(dev, n: int, variant, where: str) -> None:
    """K10 held bit for bit against its plain version at n lanes of one
    kernel instance (`variant`, or a scene: the instance its launch takes),
    on random lanes of every material type (tests/torch_lanes.py:
    random_bsdf_lanes) at depths 0 and 1."""
    import torch_lanes as TL

    from strelka_tpu_torch.kernels import lanes as L
    from strelka_tpu_torch.kernels import shade as KS

    if not isinstance(variant, int):
        variant = L.fibre_variant(variant.has_curves or variant.has_hair)
    if ("shade_bsdf", (n, variant)) in HELD:
        return
    hair = variant != L.NO_FIBRE
    for depth in (0, 1):
        lanes = TL.random_bsdf_lanes(n, 3 * n + 2 * variant + depth, dev)
        with hair_lobes(variant):
            got = held(lambda: KS.shade_bsdf(**lanes, depth=depth, enable_hair=hair))
            off = TL.lanes_off(got, KS.shade_bsdf_plain(**lanes, depth=depth, enable_hair=hair),
                               {"smp": lanes["hit_surface"]})
        if any(off.values()):
            raise AssertionError(f"K10 differs from its plain version at {n} lanes, instance {variant}, depth "
                                 f"{depth} ({where}): {off}")
    log(f"K10 bit-equal (tolerance: none) at {n} lanes, instance {variant}, depths 0 and 1 ({where})")


def phase_shade(dev):
    """Phase 15 -> K10's rows (timed at SHADE_TIMED)."""
    import torch
    import torch_lanes as TL

    from strelka_tpu_torch.kernels import lanes as L
    from strelka_tpu_torch.kernels import shade as KS

    t0 = time.perf_counter()
    for variant in (L.NO_FIBRE, L.CHIANG, L.KAJIYA_KAY):
        for n in SHADE_EDGES:
            hold_shade(dev, n, variant, "edge")
    rows = []
    for n in SHADE_TIMED:
        for variant, label in ((L.NO_FIBRE, "no fibre"), (L.CHIANG, "Chiang fibre")):
            hold_shade(dev, n, variant, "timed")
            lanes = TL.random_bsdf_lanes(n, n + variant, dev)
            hit = int(lanes["hit_surface"].sum())

            def kern():
                return KS.shade_bsdf(**lanes, depth=1, enable_hair=variant != L.NO_FIBRE)

            def plain():
                return KS.shade_bsdf_plain(**lanes, depth=1, enable_hair=variant != L.NO_FIBRE)

            with hair_lobes(variant):
                rows.append(dict(
                    kernel="shade_bsdf", at=f"random lanes, {label}", shape=(n, variant),
                    ms=time_ms(kern), device_ms=graph_ms(kern),
                    plain_ms=time_ms(plain, samples=5, inner=2), plain_device_ms=graph_ms(plain, calls=2, samples=5),
                    bound_bytes=hit * SHADE_HIT_BYTES + (n - hit) * SHADE_DEAD_BYTES + n * SHADE_OUT_BYTES,
                    bound_ops_s=0.0, max_abs_err=0.0, library_ms=None))
    torch.cuda.synchronize()
    finish_bounds(rows)
    for r in rows:
        log(f"K10 at {r['shape'][0]} lanes ({r['at']}): {r['device_ms']:.4f} ms alone (events {r['ms']:.4f}), "
            f"the plain phase {r['plain_device_ms']:.3f} ms alone (events {r['plain_ms']:.3f}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_bytes']} bytes)")
    log(f"K10 phase in {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 16: kernels K11 and K12, the NEE phase less its shadow sweep
# ---------------------------------------------------------------------------

# bytes a lane moves: K11 reads 12 f32 words, event_type and prim (int32) and
# two flags, and writes 8 words, exclude and light_id (int32) and two flags;
# K12 reads on a nee_able lane 29 f32 words, light_id and the type (int32) and
# five flags, on the others 6 words and 2 flags, and writes 6 words and a flag
NEE_LIGHT_BYTES = 12 * 4 + 4 + 4 + 2 + 8 * 4 + 4 + 4 + 2
NEE_SHADE_ABLE_BYTES = 29 * 4 + 4 + 4 + 5
NEE_SHADE_OTHER_BYTES = 6 * 4 + 2
NEE_SHADE_OUT_BYTES = 6 * 4 + 1


def hold_nee(dev, n: int, variant, where: str) -> None:
    """K11 at both rect light sampling methods and K12 at one instance
    (`variant`, or a scene: the instance its launch takes) held bit for bit
    against their plain halves at n lanes, on random lanes of every light and
    material type with NaN planted (tests/torch_lanes.py:random_nee_lanes)."""
    import torch_lanes as TL

    from strelka_tpu_torch.kernels import lanes as L
    from strelka_tpu_torch.kernels import nee as KN

    if not isinstance(variant, int):
        variant = L.fibre_variant(variant.has_curves or variant.has_hair)
    if {("nee_light", (n, m)) for m in KN.METHODS} | {("nee_shade", (n, variant))} <= HELD:
        return
    hair = variant != L.NO_FIBRE
    for method in KN.METHODS:
        lanes = TL.random_nee_lanes(n, 5 * n + 2 * variant + method, dev, nan_share=0.01)
        nl = held(lambda: KN.nee_light(**TL.light_args(lanes), method=method))
        off = TL.lanes_off(nl, KN.nee_light_plain(**TL.light_args(lanes), method=method))
        with hair_lobes(variant):
            got = held(lambda: KN.nee_shade(nl, **TL.shade_args(lanes), enable_hair=hair))
            off.update(TL.lanes_off(got, KN.nee_shade_plain(nl, **TL.shade_args(lanes), enable_hair=hair)))
        if any(off.values()):
            raise AssertionError(f"K11/K12 differ from their plain halves at {n} lanes, method {method}, instance "
                                 f"{variant} ({where}): {off}")
    log(f"K11 and K12 bit-equal (tolerance: none) at {n} lanes, both methods, instance {variant} ({where})")


def phase_nee(dev):
    """Phase 16 -> K11's and K12's rows (timed at SHADE_TIMED)."""
    import torch
    import torch_lanes as TL

    from strelka_tpu_torch.kernels import lanes as L
    from strelka_tpu_torch.kernels import nee as KN

    t0 = time.perf_counter()
    for variant in (L.NO_FIBRE, L.CHIANG, L.KAJIYA_KAY):
        for n in SHADE_EDGES:
            hold_nee(dev, n, variant, "edge")
    rows = []
    for n in SHADE_TIMED:
        for variant in (L.NO_FIBRE, L.CHIANG):
            hold_nee(dev, n, variant, "timed")
        lanes = TL.random_nee_lanes(n, n + 1, dev)
        for method in KN.METHODS:
            def light():
                return KN.nee_light(**TL.light_args(lanes), method=method)

            def light_plain():
                return KN.nee_light_plain(**TL.light_args(lanes), method=method)

            rows.append(dict(
                kernel="nee_light", at=f"random lanes, rect method {method}", shape=(n, method),
                ms=time_ms(light), device_ms=graph_ms(light),
                plain_ms=time_ms(light_plain, samples=5, inner=2),
                plain_device_ms=graph_ms(light_plain, calls=2, samples=5),
                bound_bytes=n * NEE_LIGHT_BYTES, bound_ops_s=0.0, max_abs_err=0.0, library_ms=None))
        nl = KN.nee_light(**TL.light_args(lanes), method=0)
        able = int(nl.nee_able.sum())
        for variant, label in ((L.NO_FIBRE, "no fibre"), (L.CHIANG, "Chiang fibre")):
            def shade():
                return KN.nee_shade(nl, **TL.shade_args(lanes), enable_hair=variant != L.NO_FIBRE)

            def shade_plain():
                return KN.nee_shade_plain(nl, **TL.shade_args(lanes), enable_hair=variant != L.NO_FIBRE)

            with hair_lobes(variant):
                rows.append(dict(
                    kernel="nee_shade", at=f"random lanes, {label}", shape=(n, variant),
                    ms=time_ms(shade), device_ms=graph_ms(shade),
                    plain_ms=time_ms(shade_plain, samples=5, inner=2),
                    plain_device_ms=graph_ms(shade_plain, calls=2, samples=5),
                    bound_bytes=able * NEE_SHADE_ABLE_BYTES + (n - able) * NEE_SHADE_OTHER_BYTES
                    + n * NEE_SHADE_OUT_BYTES, bound_ops_s=0.0, max_abs_err=0.0, library_ms=None))
    torch.cuda.synchronize()
    finish_bounds(rows)
    for r in rows:
        log(f"{r['kernel']} at {r['shape'][0]} lanes ({r['at']}): {r['device_ms']:.4f} ms alone (events "
            f"{r['ms']:.4f}), the plain half {r['plain_device_ms']:.3f} ms alone (events {r['plain_ms']:.3f}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_bytes']} bytes)")
    log(f"K11/K12 phase in {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 17: kernel K13, the surface phase less its texture lookups
# ---------------------------------------------------------------------------

# bytes a lane moves at least: every lane reads alive, inside (flags), hit_t,
# prim and its radiance and throughput (8 words); a live lane that hit a
# cone its segment id; every lane writes 35 f32 words, the type (int32) and
# 3 flags, and a textured scene's lanes 12 words more; the triangle rows a
# lane reads (columns 0-47) count once a row
SURFACE_IN_BYTES = 8 * 4 + 2
SURFACE_OUT_BYTES = 35 * 4 + 4 + 3
SURFACE_UV_OUT_BYTES = 12 * 4
SURFACE_ROW_BYTES = 48 * 4
# (curves, refine, uv): the kernel's instances
SURFACE_INSTANCES = ((False, False, False), (False, False, True), (True, False, False), (True, True, False),
                     (True, False, True), (True, True, True))


def surface_instance(scene) -> tuple:
    """The K13 instance a launch of the scene takes (kernels/surface.py:shade_surface)."""
    return scene.has_curves, scene.has_curves and bool(scene.curve_refine), scene.textures is not None


def hold_surface(dev, n: int, instance, where: str) -> None:
    """K13 held bit for bit against its plain version at n lanes of one
    kernel instance (`instance`, or a scene: the instance its launch takes),
    on random lanes (tests/torch_lanes.py:random_surface_lanes) at depths 0
    and 1."""
    import torch_lanes as TL

    from strelka_tpu_torch.kernels import surface as KSF

    if not isinstance(instance, tuple):
        instance = surface_instance(instance)
    curves, refine, uv = instance
    if ("shade_surface", (n, int(curves), int(refine), int(uv))) in HELD:
        return
    for depth in (0, 1):
        lanes = TL.random_surface_lanes(n, 7 * n + 2 * depth + 4 * curves + 2 * refine + uv, dev, curves=curves,
                                        refine=refine, uv=uv)
        got = held(lambda: KSF.shade_surface(**lanes, depth=depth))
        off = TL.lanes_off(got, KSF.shade_surface_plain(**lanes, depth=depth))
        if any(off.values()):
            raise AssertionError(f"K13 differs from its plain version at {n} lanes, instance {instance}, depth "
                                 f"{depth} ({where}): {off}")
    log(f"K13 bit-equal (tolerance: none) at {n} lanes, instance {instance}, depths 0 and 1 ({where})")


def phase_surface(dev):
    """Phase 17 -> K13's rows (timed at SHADE_TIMED)."""
    import torch
    import torch_lanes as TL

    from strelka_tpu_torch.kernels import surface as KSF

    t0 = time.perf_counter()
    for instance in SURFACE_INSTANCES:
        for n in SHADE_EDGES:
            hold_surface(dev, n, instance, "edge")
    rows = []
    for n in SHADE_TIMED:
        for instance in SURFACE_INSTANCES:
            hold_surface(dev, n, instance, "timed")
            curves, refine, uv = instance
            lanes = TL.random_surface_lanes(n, n + 1, dev, curves=curves, refine=refine, uv=uv)

            def kern():
                return KSF.shade_surface(**lanes, depth=1)

            def plain():
                return KSF.shade_surface_plain(**lanes, depth=1)

            seg_lanes = int((lanes["alive"] & (lanes["chit"].seg >= 0)).sum()) if curves else 0
            row_count = int(torch.unique(torch.clamp(lanes["hit"].prim, min=0)).numel())
            rows.append(dict(
                kernel="shade_surface", at=f"random lanes, curves {curves}, refine {refine}, uv {uv}",
                shape=(n, int(curves), int(refine), int(uv)), ms=time_ms(kern), device_ms=graph_ms(kern),
                plain_ms=time_ms(plain, samples=5, inner=2), plain_device_ms=graph_ms(plain, calls=2, samples=5),
                bound_bytes=n * (SURFACE_IN_BYTES + SURFACE_OUT_BYTES + uv * SURFACE_UV_OUT_BYTES) + 4 * seg_lanes
                + row_count * SURFACE_ROW_BYTES, bound_ops_s=0.0, max_abs_err=0.0, library_ms=None))
    torch.cuda.synchronize()
    finish_bounds(rows)
    for r in rows:
        log(f"K13 at {r['shape'][0]} lanes ({r['at']}): {r['device_ms']:.4f} ms alone (events {r['ms']:.4f}), the "
            f"plain phase {r['plain_device_ms']:.3f} ms alone (events {r['plain_ms']:.3f}), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_bytes']} bytes)")
    log(f"K13 phase in {time.perf_counter() - t0:.1f} s")
    return rows


# ---------------------------------------------------------------------------
# Phase 10: the launch cache (render/render.py: one CUDA graph a config key)
# ---------------------------------------------------------------------------

GRAPH_TIMED = 4  # launches in each of the four timed turns (eager, graph, graph, eager)
GRAPH_PROFILED = 2  # replayed launches traced under the profiler (and one eager launch)
LAUNCH_GRAPH = []  # one result a main path, printed with the results


def device_busy(spans):
    """(busy us, window us) of device events' (start, end) spans in us:
    the length of their union, and first start to last end."""
    if not spans:
        return 0.0, 0.0
    spans = sorted(spans)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, max(e for _, e in spans) - spans[0][0]


def profile_launches(fn, n: int) -> dict:
    """fn() n times under torch.profiler (CPU and CUDA activities): the
    device's events a launch (kernels, memsets, copies), their time a
    launch and the device's idle share over the traced window, counted as
    scripts/torch_profile_cornell.py counts them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy, window = device_busy(spans)
    return dict(device_events_per_launch=len(spans) / n, device_ms_per_launch=busy / n / 1e3,
                device_idle_share=(1.0 - busy / window) if window > 0 else None)


def phase_launch_graph(scene, host, cfg: Config):
    """Phase 10 on one main path: TorchRender's launch cache (one CUDA graph
    a config key) against render_launch run eagerly. (1) One eager launch
    with its values on the card raises nothing under
    torch.cuda.set_sync_debug_mode("error"). (2) Nine TorchRender frames
    (a key's first launch eager, its second captured and replayed, then
    replays; a camera move twice, the subframe back to 0; the budget's last
    sample a second, 1-spp key) equal render_launch run eagerly from the
    same start on every value of the image, accum, diffuse, specular and
    both counters, and (3) launch, frame by frame, the same kernels at the
    same shapes, as kernels.launch_counts count them. (4) ms a launch in turns (eager,
    graph, graph, eager; GRAPH_TIMED launches each, host clock, one
    synchronize a turn), the capture's seconds, the peak device memory with
    the graphs held, the graph's node count, and GRAPH_PROFILED replayed
    launches and one eager launch traced: device events, device ms and idle
    share a launch. The renderer is handed the
    path's device scene; the host scene's camera is moved."""
    import numpy as np
    import torch

    from strelka_tpu_torch import kernels as K
    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.ops import tonemap as TM
    from strelka_tpu_torch.render import render as R
    from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu_torch.settings import SharedContext, make_default_settings
    from strelka_tpu_torch.utils import profiling as P

    t_phase = time.perf_counter()
    setup_before = time.time_ns()  # the recorder's set-up spans from here on are this phase's
    dev = scene.device
    w, h, spp = cfg.width, cfg.height, cfg.spp
    kw = main_path_kw(cfg)

    # (1) no host sync inside an eager launch whose values are on the card
    hp = launch_params(host, w, h, spp)
    on_card = I.LaunchParams(*(torch.as_tensor(np.asarray(v), device=dev) for v in hp[:5]),
                             cone_spread=torch.tensor(I.ray_cone_spread(hp, h), device=dev))
    state = I.make_frame_state(h, w, dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        I.render_launch(scene, on_card, state, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    del state

    # (2), (3) replays against eager launches from the same start
    total = 2 * spp + 1  # two launches of spp, then the budget's last sample: a second key
    s = make_default_settings(w, h)
    s.set("render/pt/spp", spp)
    s.set("render/pt/sppTotal", total)
    s.set("render/pt/depth", cfg.depth)
    torch.cuda.reset_peak_memory_stats()
    r = R.TorchRender(device=dev)
    r.set_scene(host)
    r._device_scene, host.dirty = scene, False  # the path's device scene, as set_scene builds it
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(w, h, BufferFormat.FLOAT4))
    exposure = TM.compute_exposure_value(s)
    tm_type, gamma = s.get_int("render/pt/tonemapperType"), s.get_float("render/post/gamma")
    cam = host.get_camera(0)

    def eager(st, sub, spl, max_spp):
        cam.update_aspect_ratio(w / h)
        p = I.LaunchParams(sub, np.asarray(cam.clip_to_view(), np.float32), np.asarray(cam.view_to_world(), np.float32),
                           np.asarray(exposure, np.float32), np.asarray(s.get("render/bgColor"), np.float32))
        st, planar = I.render_launch(scene, p, st, width=w, height=h, samples_per_launch=spl,
                                     max_sample_count=max_spp, max_depth=cfg.depth, enable_accumulation=True)
        return st, R._post(planar, 0, tm_type, exposure, gamma)

    def off(a, b) -> int:
        if a.dtype == torch.float32:
            a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
        return int((a != b).sum())

    e_state = I.make_frame_state(h, w, dev)
    counts_graph, counts_eager = [], []  # each frame's launch counts and shapes
    values_off = {name: 0 for name in ("image",) + I.FrameState._fields}
    frames = []
    for i in range(9):
        if i in (3, 6):
            cam.rotate(1.0, 0.5)  # a camera move: the subframe goes back to 0
        sub = (i % 3) * spp
        spl = spp if i % 3 < 2 else 1
        counts_graph.append(K.take_counts(lambda: r.render(buf))[1][:2])
        (e_state, e_image), added = K.take_counts(lambda: eager(e_state, sub, spl, total))
        counts_eager.append(added[:2])
        if s.get_int("render/pt/sppTotal") != total or r.get_shared_context().subframe_index != sub + spl:
            raise AssertionError(f"{cfg.name} launch graph frame {i}: subframe {r.get_shared_context().subframe_index}, "
                                 f"expected {sub + spl}")
        values_off["image"] += off(buf.device(), e_image)
        for name, a, b in zip(I.FrameState._fields, r._state, e_state):
            values_off[name] += off(a, b)
        frames.append(dict(subframe=sub, spp=spl))
    graphs = [fn for fn in r._launch_cache.values() if isinstance(fn, R.GraphLaunch)]
    captured = [g for g in graphs if g.graph is not None]
    if len(graphs) != 2 or len(captured) != 2:
        raise AssertionError(f"{cfg.name}: {len(graphs)} GraphLaunch entries, {len(captured)} captured; expected 2 and 2")
    if any(values_off.values()):
        raise AssertionError(f"{cfg.name}: the replayed launches differ from the eager ones: {values_off}")
    if counts_graph != counts_eager:
        raise AssertionError(f"{cfg.name}: launch counts differ, replayed {counts_graph} against eager {counts_eager}")
    launches = collections.Counter()
    for per_name, _ in counts_graph:
        launches.update(per_name)
    for name in cfg.kernels:
        if not launches[name]:
            raise AssertionError(f"{cfg.name}: kernel {name} was not launched by the replayed frames")

    # (4) time in turns, from a third key (the main path's sample budget)
    s.set("render/pt/sppTotal", MAX_SAMPLE_COUNT)  # a watched key: the subframe goes back to 0
    r.render(buf)  # eager
    r.render(buf)  # captured and replayed
    main_entry = [fn for fn in r._launch_cache.values() if isinstance(fn, R.GraphLaunch)][-1]
    e_state = I.make_frame_state(h, w, dev)
    e_sub = 0

    def eager_launch():
        nonlocal e_state, e_sub
        e_state, _ = eager(e_state, e_sub, spp, MAX_SAMPLE_COUNT)
        e_sub += spp

    eager_launch()
    turns = []
    for kind in ("eager", "graph", "graph", "eager"):
        fn = eager_launch if kind == "eager" else (lambda: r.render(buf))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(GRAPH_TIMED):
            fn()
        torch.cuda.synchronize()
        turns.append((kind, (time.perf_counter() - t0) / GRAPH_TIMED * 1e3))
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    reserved_mb = torch.cuda.memory_reserved() / 2**20
    prof_graph = profile_launches(lambda: r.render(buf), GRAPH_PROFILED)
    prof_eager = profile_launches(eager_launch, 1)
    eager_ms = statistics.mean(t for k, t in turns if k == "eager")
    replay_ms = statistics.mean(t for k, t in turns if k == "graph")
    if replay_ms < 0.9 * prof_graph["device_ms_per_launch"]:
        raise AssertionError(f"{cfg.name}: {replay_ms:.3f} ms a replayed launch is below its device work "
                             f"{prof_graph['device_ms_per_launch']:.3f} ms: the timing does not wait for the card")
    result = dict(
        scene=cfg.name, config=f"{w}x{h} spp={spp} depth={cfg.depth}",
        sync_debug_mode_error="no sync", frames=frames, values_off=values_off,
        launch_counts_equal=True,
        launches_per_render_launch={k: v / len(frames) for k, v in launches.items()},
        graph_nodes=P.counters()["graph.nodes"][main_entry.key],
        eager_ms_per_launch=eager_ms, graph_ms_per_launch=replay_ms, turns=turns,
        capture_seconds=[setup_seconds("launch.capture", s) for s in P.setup_spans()
                         if s["name"] == "launch.capture" and s["start_ns"] >= setup_before],
        peak_device_memory_mb=peak_mb, reserved_device_memory_mb=reserved_mb,
        graph_profile=prof_graph, eager_profile=prof_eager, card=card_name_and_power_limit(),
        phase_seconds=time.perf_counter() - t_phase,
    )
    LAUNCH_GRAPH.append(result)
    log(f"launch graph {cfg.name} {result['config']}: replays equal the eager launches over {len(frames)} frames "
        f"({values_off}), launch counts equal; eager {eager_ms:.3f} ms a launch, graph {replay_ms:.3f} "
        f"(turns {[(k, round(t, 3)) for k, t in turns]}); captures {result['capture_seconds']} s; graph nodes "
        f"{result['graph_nodes']}, device events a launch replayed {prof_graph['device_events_per_launch']:.0f} / "
        f"eager {prof_eager['device_events_per_launch']:.0f}; device ms a launch {prof_graph['device_ms_per_launch']:.3f}"
        f" / {prof_eager['device_ms_per_launch']:.3f}, idle share {prof_graph['device_idle_share']:.3f} / "
        f"{prof_eager['device_idle_share']:.3f}; peak device memory {peak_mb:.0f} MB, reserved {reserved_mb:.0f} MB; "
        f"{result['phase_seconds']:.1f} s")
    return result


def print_kernel_lines(rows, main=None):
    """One JSON line per (kernel, shape) row; `main` is the result of the main
    path whose launches at that shape are given beside it."""
    for r in rows:
        line = {"kernel": r["kernel"], "at": r["at"], "replaces": REPLACES[r["kernel"]][0]}
        line.update({k: v for k, v in r.items() if k not in ("kernel", "at", "bound_ops_s")})
        if main is not None:
            line["launches"] = shape_launches(main, r)
        print(json.dumps(line), flush=True)


def shape_launches(main, row) -> int:
    """Launches of a row's kernel at its shape on a main path."""
    return sum(e["launches"] for e in main["launch_shapes"]
               if e["kernel"] == row["kernel"] and tuple(e["shape"]) == tuple(row["shape"]))


def main() -> int:
    if sys.argv[1:]:
        print("usage: python3 chip_smoke.py", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this probe runs on the card only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "strelka_tpu_torch")):
        print("chip_smoke: no strelka_tpu_torch package beside this script; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    sys.path.append(os.path.join(REPO, "tests"))  # torch_lanes: the lane kernels' random lanes (phases 15-17)
    from strelka_tpu_torch import kernels as K
    from strelka_tpu_torch.kernels import build
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.scene import testscenes as TS
    from strelka_tpu_torch.utils import profiling as P

    K.count_replays = True  # the phases read launch_counts after graph replays
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    # ---- 1. build
    t0 = time.perf_counter()
    build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {'ran' if P.counters().get('kernels.built') else 'skipped: cached build'})")
    for line in build.ptxas_report().splitlines():
        if "registers" in line or "==" in line or "error" in line.lower():
            log("  " + line.strip())

    # ---- 15. kernel K10, the BSDF phase
    shade_rows = phase_shade(dev)
    # ---- 16. kernels K11 and K12, the NEE phase less its shadow sweep
    shade_rows += phase_nee(dev)
    # ---- 17. kernel K13, the surface phase less its texture lookups
    shade_rows += phase_surface(dev)

    # ---- 2. Cornell: kernels K1-K4, fidelity through the library API, main path
    host, scene = cornell_scene(dev)
    rows = phase_kernels(scene, launch_params(host, CORNELL.width, CORNELL.height, 0))
    finish_bounds(rows)
    ssim_cornell = phase_golden(TS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True), dev,
                                "cornell_golden.png", CORNELL.kernels)
    rows += phase_order(scene, host, CORNELL)
    main_cornell = phase_main_path(scene, host, CORNELL)
    phase_launch_graph(scene, host, CORNELL)
    phase_order_ab(scene, host, CORNELL)
    log(f"[{time.perf_counter() - t_start:.0f} s] Cornell phases done")

    # ---- 3. flat kernels above 1024 triangles
    flat = phase_flat_scene(dev)
    log(f"[{time.perf_counter() - t_start:.0f} s] box_field(grid={FLAT_GRID}) phase done")

    # ---- 4. box_field on the BVH: kernels K5/K6, golden, main path
    box_host = TS.box_field(grid=BOX_GRID)
    box = build_device_scene(box_host, device=dev)
    box_build_span = setup_span("bvh.build")
    log(f"box_field(grid={BOX_GRID}): {box.num_triangles} triangles ({box.v0.shape[0]} padded), BVH of "
        f"{box.bvh.num_nodes} nodes built by the {box.bvh.builder} builder in {setup_seconds('bvh.build'):.2f} s")
    box_rows, box_differ = phase_box_kernels(box, launch_params(box_host, BOX.width, BOX.height, 0))
    ssim_box = phase_golden(TS.box_field(grid=BOX_GRID), dev, "box_field_golden.png", BOX.kernels)
    box_rows += phase_order(box, box_host, BOX)
    main_box = phase_main_path(box, box_host, BOX)
    main_box.update(bvh_nodes=box.bvh.num_nodes, bvh_builder=box.bvh.builder,
                    bvh_build_seconds=setup_seconds("bvh.build", box_build_span))
    phase_launch_graph(box, box_host, BOX)
    phase_order_ab(box, box_host, BOX)
    log(f"[{time.perf_counter() - t_start:.0f} s] box_field(grid={BOX_GRID}) phases done")

    # ---- 5, 6. the hair scenes: kernels K7/K8, golden, main paths
    del box
    hair_rows, main_hair, ssim_hair, long_rows, main_long, ssim_long = phase_hair(dev, t_start)

    # ---- 7, 8. the USD scenes: coffeetable (K1-K4), kitchen (K1, K4, K5/K6, textures)
    coffee_rows, main_coffee, ssim_coffee = phase_coffeetable(dev, t_start)
    kitchen_rows, main_kitchen, ssim_kitchen, kitchen_differ = phase_kitchen(dev, t_start)

    # ---- 9. the user's entry points: the CLI, the USD runner, the viewer
    entry_items, main_entry = phase_entry_points(dev, t_start)

    # ---- 10. the launch cache: one CUDA graph a config key, on each main path (run inside the phases above)
    launch_graph_s = sum(g["phase_seconds"] for g in LAUNCH_GRAPH)
    log(f"launch graph phase: {len(LAUNCH_GRAPH)} main paths in {launch_graph_s:.1f} s")
    if len(LAUNCH_GRAPH) != 6:
        raise AssertionError(f"the launch graph phase ran on {len(LAUNCH_GRAPH)} main paths, not 6")

    # ---- 12. the Kajiya-Kay hair switch in a child process
    hair_kk = phase_hair_kk(dev)

    # ---- 13. the wavefront order (run inside the main-path phases above); 14. the north-star showcase
    if len(ORDER) != 6 or len(ORDER_AB) != 6:
        raise AssertionError(f"the order phase ran on {len(ORDER)} main paths and its A/B on {len(ORDER_AB)}, not 6")
    showcase = phase_showcase(t_start)

    # ---- 11. results
    print(json.dumps({"hair_kajiya_kay": hair_kk}), flush=True)
    print(json.dumps({"main_path": main_cornell, "golden_ssim": ssim_cornell}), flush=True)
    print(json.dumps({"main_path": main_box, "golden_ssim": ssim_box, "bvh_any_vs_bruteforce": box_differ}),
          flush=True)
    print(json.dumps({"flat_scene": {k: v for k, v in flat.items() if k != "kernels"}}), flush=True)
    print_kernel_lines(rows, main_cornell)
    print_kernel_lines(flat["kernels"])
    print_kernel_lines(box_rows, main_box)
    print(json.dumps({"main_path": main_hair, "golden_ssim": ssim_hair}), flush=True)
    print(json.dumps({"main_path": main_long, "golden_ssim": ssim_long}), flush=True)
    print_kernel_lines(hair_rows, main_hair)
    print_kernel_lines(long_rows, main_long)
    print(json.dumps({"main_path": main_coffee, "golden_ssim": ssim_coffee}), flush=True)
    print(json.dumps({"main_path": main_kitchen, "golden_ssim": ssim_kitchen,
                      "bvh_any_vs_bruteforce": kitchen_differ}), flush=True)
    print_kernel_lines(coffee_rows, main_coffee)
    print_kernel_lines(kitchen_rows, main_kitchen)
    print_kernel_lines(shade_rows)
    for g in LAUNCH_GRAPH:
        print(json.dumps({"launch_graph": g}), flush=True)
    for o in ORDER:
        print(json.dumps({"order": o}), flush=True)
    for o in ORDER_AB:
        print(json.dumps({"order_ab": o}), flush=True)
    print(json.dumps({"showcase": showcase}), flush=True)
    print(json.dumps({"entry_points": [{k: e[k] for k in ("entry_point", "wall_s", "ms_per_frame_after_first",
                                                          "mrays_per_s", "mrays_per_s_after_first")}
                                       for e in entry_items]}), flush=True)

    # one entry per kernel: its numbers at the first shape it was timed at
    # (K1-K4 at Cornell's, K5/K6 at box_field's, K7/K8 at hair_patch's, K9 at hair_long's) and
    # launches over the six main-path runs and the entry points' runs; "shapes" lists every shape a
    # main path or the flat scene gave it, each with its own numbers and its launches there
    from strelka_tpu_torch.kernels import KERNEL_NAMES

    numbers = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    tagged = ([(r, main_cornell) for r in rows] + [(r, None) for r in flat["kernels"]]
              + [(r, main_box) for r in box_rows] + [(r, main_hair) for r in hair_rows]
              + [(r, main_long) for r in long_rows] + [(r, main_coffee) for r in coffee_rows]
              + [(r, main_kitchen) for r in kitchen_rows] + [(r, None) for r in shade_rows])
    mains = (main_cornell, main_box, main_hair, main_long, main_coffee, main_kitchen, main_entry)
    kernels = []
    for name in KERNEL_NAMES:
        mine = [(r, m) for r, m in tagged if r["kernel"] == name]
        entry = {
            "name": name, "route": "cuda", "source": REPLACES[name][1], "replaces": REPLACES[name][0],
            "launches": sum(m["launch_counts"].get(name, 0) for m in mains),
            **{f"launches_{m['scene']}": m["launch_counts"].get(name, 0) for m in mains},
        }
        entry.update({k: mine[0][0][k] for k in numbers})
        entry.update({k: mine[0][0][k] for k in ("device_ms", "order_ms", "order_device_ms") if k in mine[0][0]})
        entry.update({k: mine[0][0][k] for k in WALK_KEYS if k in mine[0][0]})
        # plain_lanes: the lanes the plain version ran on, where they are fewer than the kernel's
        entry["shapes"] = [dict(at=r["at"], shape=list(r["shape"]), launches=shape_launches(m, r) if m else 0,
                                **{k: r[k] for k in numbers},
                                **{k: r[k] for k in SHAPE_KEYS if k in r},
                                **{k: r[k] for k in ("plain_lanes",) if r.get(k, r["shape"][0]) != r["shape"][0]})
                           for r, m in mine]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"total {time.perf_counter() - t_start:.0f} s")
    for line in card_name_and_power_limit().splitlines():
        print(line.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
