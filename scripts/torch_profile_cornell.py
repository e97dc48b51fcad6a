#!/usr/bin/env python3
"""Where the time goes in one of the port's main paths on a CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_profile_cornell.py [--scene cornell|box_field|hair_patch|hair_long] [--launches 2]
                                             [--out build/profile]

Builds a scene of chip_smoke.py's main paths on the card (its scene, launch
parameters and render_launch arguments: cornell at 512x512, 4 spp, depth 4,
box_field(grid=48) on its BVH at 512x512, 2 spp, depth 4, or
hair_patch(n_curves=256) / hair_patch(n_curves=20000) at 384x384, 2 spp,
depth 4), runs one
warm-up render_launch, then traces --launches more under torch.profiler
(CPU and CUDA activities). Prints one JSON line: wall time per launch,
device kernel time per launch split into the hand-written kernels and
everything else (the plain PyTorch shading), the device's idle share over
the traced window, the CUDA kernel launches per render launch, and the
card's name and power limit. Writes the top of the kernel table and a
Chrome trace under --out/<scene>.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = {
    "random_dims_kernel": "sobol",
    "closest_kernel": "intersect_closest",
    "any_kernel": "intersect_any",
    "gather_rows_t_kernel": "gather_rows_t",
    "bvh_kernel<false>": "bvh_closest",
    "bvh_kernelILb0E": "bvh_closest",  # the same, where the profiler keeps the mangled name
    "bvh_kernel<true>": "bvh_any",
    "bvh_kernelILb1E": "bvh_any",
    "cone_kernel<false>": "cone_closest",
    "cone_kernelILb0E": "cone_closest",
    "cone_kernel<true>": "cone_any",
    "cone_kernelILb1E": "cone_any",
    "open_w_kernel": "open_w",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("cornell", "box_field", "hair_patch", "hair_long"), default="cornell")
    ap.add_argument("--launches", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile_cornell: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as C
    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.scene import testscenes as TS

    if args.scene == "cornell":
        cfg = C.CORNELL
        host, scene = C.cornell_scene(torch.device("cuda"))
    elif args.scene == "box_field":
        cfg = C.BOX
        host = TS.box_field(grid=C.BOX_GRID)
        scene = build_device_scene(host, device=torch.device("cuda"))
    else:
        cfg = C.HAIR if args.scene == "hair_patch" else C.HAIR_LONG
        host = TS.hair_patch(n_curves=C.HAIR_CURVES[cfg.name])
        scene = build_device_scene(host, device=torch.device("cuda"))
    kw = C.main_path_kw(cfg)
    state = I.make_frame_state(cfg.height, cfg.width, scene.device)
    state, _ = I.render_launch(scene, C.launch_params(host, cfg.width, cfg.height, 0), state, **kw)  # warm-up, build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.launches):
            params = C.launch_params(host, cfg.width, cfg.height, cfg.spp * (i + 1))
            state, _ = I.render_launch(scene, params, state, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    per_kernel = {name: 0.0 for name in cfg.kernels}
    other_us, n_kernels = 0.0, 0
    spans = []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = ev.time_range.elapsed_us()
        spans.append((ev.time_range.start, ev.time_range.end))
        n_kernels += 1
        short = next((v for k, v in KERNELS.items() if k in ev.name), None)
        if short:
            per_kernel[short] = per_kernel.get(short, 0.0) + dur
        else:
            other_us += dur
    busy_us = 0.0
    if spans:
        spans.sort()
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy_us += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy_us += cur_e - cur_s
        window_us = max(e for _, e in spans) - spans[0][0]
    else:
        window_us = 0.0
    n = args.launches
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    result = {
        "config": f"{cfg.name} {cfg.width}x{cfg.height} spp={cfg.spp} depth={cfg.depth}",
        "triangles": scene.num_triangles,
        "cones": scene.num_cones,
        "device": torch.cuda.get_device_name(0),
        "card_and_power_limit": smi.stdout.strip(),
        "wall_ms_per_launch": wall / n * 1e3,
        "device_ms_per_launch": {k: v / n / 1e3 for k, v in per_kernel.items()},
        "device_other_ms_per_launch": other_us / n / 1e3,
        "cuda_kernels_per_launch": n_kernels / n,
        "device_idle_share": (1.0 - busy_us / window_us) if window_us > 0 else None,
        "traced_device_events": n_kernels,
    }
    out = os.path.join(args.out, args.scene)
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
