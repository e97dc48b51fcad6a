#!/usr/bin/env python3
"""Where the time goes in the port's Cornell main path on a CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 scripts/torch_profile_cornell.py [--launches 2] [--out build/profile]

Builds the Cornell box of chip_smoke.py's main path on the card (its scene,
launch parameters and render_launch arguments: 512x512, 4 spp, depth 4),
runs one warm-up render_launch, then traces --launches more under
torch.profiler (CPU and CUDA activities). Prints one JSON line: wall time per
launch, device kernel time per launch split into the four hand-written
kernels and everything else (the plain PyTorch shading), the device's idle
share over the traced window, and the CUDA kernel launches per render
launch. Writes the top of the kernel table and a Chrome trace under --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = {
    "random_dims_kernel": "sobol",
    "closest_kernel": "intersect_closest",
    "any_kernel": "intersect_any",
    "gather_rows_t_kernel": "gather_rows_t",
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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

    host, scene = C.cornell_scene(torch.device("cuda"))
    kw = C.main_path_kw()
    state = I.make_frame_state(C.HEIGHT, C.WIDTH, scene.device)
    state, _ = I.render_launch(scene, C.launch_params(host, C.WIDTH, C.HEIGHT, 0), state, **kw)  # warm-up, build
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.launches):
            params = C.launch_params(host, C.WIDTH, C.HEIGHT, C.SPP * (i + 1))
            state, _ = I.render_launch(scene, params, state, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    per_kernel = {name: 0.0 for name in KERNELS.values()}
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
            per_kernel[short] += dur
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
    result = {
        "config": f"cornell {C.WIDTH}x{C.HEIGHT} spp={C.SPP} depth={C.DEPTH}",
        "device": torch.cuda.get_device_name(0),
        "wall_ms_per_launch": wall / n * 1e3,
        "device_ms_per_launch": {k: v / n / 1e3 for k, v in per_kernel.items()},
        "device_other_ms_per_launch": other_us / n / 1e3,
        "cuda_kernels_per_launch": n_kernels / n,
        "device_idle_share": (1.0 - busy_us / window_us) if window_us > 0 else None,
        "traced_device_events": n_kernels,
    }
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "kernels.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))
    prof.export_chrome_trace(os.path.join(args.out, "trace.json"))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
