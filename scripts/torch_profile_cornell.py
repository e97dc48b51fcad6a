#!/usr/bin/env python3
"""Where the time goes in one of the port's main paths on a CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_profile_cornell.py [--scene cornell|box_field|hair_patch|hair_long|coffeetable|kitchen]
                                             [--launches 2] [--out build/profile]

Builds a scene of chip_smoke.py's main paths on the card (its scene, launch
parameters and render_launch arguments: cornell at 512x512, 4 spp, depth 4,
box_field(grid=48) on its BVH at 512x512, 2 spp, depth 4,
hair_patch(n_curves=256) / hair_patch(n_curves=20000) at 384x384, 2 spp,
depth 4, or the USD stages through the port's UsdLoader: coffeetable at
512x512, 2 spp, depth 4, kitchen (the crate reader, a BVH, textures) at
512x512, 2 spp, depth 4), runs one
warm-up render_launch, then traces --launches more under torch.profiler
(CPU and CUDA activities). Prints one JSON line: wall time per launch,
device kernel time per launch split into the hand-written kernels and
everything else (the plain PyTorch shading), the device's idle share over
the traced window, the CUDA kernel launches per render launch, and the
card's name and power limit. On a textured scene each bounce's texture
block (ops/integrator.py:shade_textures) runs under a profiler range, and
the device time of the kernels it launched is given per launch
(`texture_device_ms_per_launch`, a part of the "everything else"). Writes the top of the kernel table and a
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
TEXTURE_RANGE = "texture_path"
KERNELS = {
    "random_dims_kernel": "sobol",
    "tri_warp_kernel<false": "intersect_closest",
    "tri_warp_kernelILb0E": "intersect_closest",
    "tri_warp_kernel<true": "intersect_any",
    "tri_warp_kernelILb1E": "intersect_any",
    "tri_thread_kernel<false": "intersect_closest",
    "tri_thread_kernelILb0E": "intersect_closest",
    "tri_thread_kernel<true": "intersect_any",
    "tri_thread_kernelILb1E": "intersect_any",
    "gather_rows_t_kernel": "gather_rows_t",
    "bvh_closest_kernel": "bvh_closest",
    "bvh_any_kernel": "bvh_any",
    "cone_kernel<false": "cone_closest",
    "cone_kernelILb0E": "cone_closest",
    "cone_kernel<true": "cone_any",
    "cone_kernelILb1E": "cone_any",
    "open_w_kernel": "open_w",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("cornell", "box_field", "hair_patch", "hair_long", "coffeetable", "kitchen"),
                    default="cornell")
    ap.add_argument("--launches", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "profile"))
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

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
    elif args.scene in ("coffeetable", "kitchen"):
        from strelka_tpu_torch.scene.kitchen import ensure_kitchen

        cfg = C.COFFEE if args.scene == "coffeetable" else C.KITCHEN
        host, _ = C.usd_host(os.path.join(REPO, C.COFFEETABLE_USD) if args.scene == "coffeetable" else ensure_kitchen())
        scene = build_device_scene(host, device=torch.device("cuda"))
    elif args.scene == "box_field":
        cfg = C.BOX
        host = TS.box_field(grid=C.BOX_GRID)
        scene = build_device_scene(host, device=torch.device("cuda"))
    else:
        cfg = C.HAIR if args.scene == "hair_patch" else C.HAIR_LONG
        host = TS.hair_patch(n_curves=C.HAIR_CURVES[cfg.name])
        scene = build_device_scene(host, device=torch.device("cuda"))
    kw = C.main_path_kw(cfg)
    shade_textures = I.shade_textures

    def traced_textures(*a, **k):
        with record_function(TEXTURE_RANGE):
            return shade_textures(*a, **k)

    I.shade_textures = traced_textures  # trace_paths looks it up in the module at each bounce
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
    texture_us = 0.0
    for ev in prof.events():
        if ev.name == TEXTURE_RANGE:
            if ev.device_type == torch.autograd.DeviceType.CPU:
                texture_us += ev.device_time_total  # the kernels its ops launched
            continue
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
    busy_us, window_us = C.device_busy(spans)
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
        "texture_device_ms_per_launch": texture_us / n / 1e3 if scene.textures is not None else None,
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
