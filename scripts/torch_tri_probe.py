#!/usr/bin/env python3
"""Kernels K2/K3 on the card at the shapes the main paths give them, both schedules.

Run on a machine with one CUDA card, from the root of a checkout:

    python3 scripts/torch_tri_probe.py

Builds the kernels, makes the ray sets of chip_smoke.py (Cornell 512x512 at
4 spp: bounce-1 and bounce-0 NEE shadow rays and the shadow-style set;
hair_patch(n_curves=256) 384x384 at 2 spp: bounce-1 and shadow rays over the
2-triangle ground; box_field(grid=12) built flat at 512x512, 2 spp) and, per
set, times K2 (bounce-1) or K3 (shadow sets) culled by the group boxes with
one ray a warp and with one ray a thread (CUDA events, median), after
checking that both equal cull=False on every lane. Each time is taken two
ways: `*_ms` as chip_smoke.py times a kernel (CUDA events around calls
queued back to back, so a call whose host work outlasts its kernel is timed
by the host), `*_graph_ms` by replaying the calls captured in a CUDA graph
(chip_smoke.graph_ms: the device's time alone); `*_host_us` is the
wrapper's host time a call.
Prints one JSON line per set and last the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_us(fn, calls: int = 200) -> float:
    """Host time of one fn() call (enqueue only), in microseconds."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_tri_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as CS
    from strelka_tpu_torch.kernels import build
    from strelka_tpu_torch.kernels import intersect as KI
    from strelka_tpu_torch.ops import sampler as S
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW, build_device_scene
    from strelka_tpu_torch.scene import testscenes as TS

    dev = torch.device("cuda")
    build.load()
    for line in build.ptxas_report().splitlines():
        if "registers" in line or "==" in line:
            print(line.strip(), flush=True)

    def sets(name, host, scene, cfg):
        idx, camera, bounce1, shadow, *_ = CS.main_path_rays(scene, CS.launch_params(host, cfg.width, cfg.height, 0),
                                                              dev, cfg)
        out = [(f"{name} bounce-1", scene, bounce1, RAY_MASK_PRIMARY, False),
               (f"{name} NEE shadow", scene, shadow, RAY_MASK_SHADOW, True)]
        if name == "cornell":
            t = KI.intersect_closest(*CS.flat_args(scene, bounce1, RAY_MASK_PRIMARY), bounds=scene.tri_bounds)[0]
            frac = S.uniform_hash(idx, 7) * 1.5
            style = dict(bounce1, tmax=torch.where(bounce1["tmax"] > 0, torch.clamp(t, max=1e3) * frac, 0.0))
            out.append((f"{name} shadow-style", scene, style, RAY_MASK_SHADOW, True))
        return out

    cases = []
    host, scene = CS.cornell_scene(dev)
    cases += sets("cornell", host, scene, CS.CORNELL)
    host = TS.hair_patch(n_curves=CS.HAIR_CURVES["hair_patch"])
    cases += sets("hair_patch", host, build_device_scene(host, device=dev), CS.HAIR)
    host = TS.box_field(grid=CS.FLAT_GRID)
    cases += sets(f"box_field(grid={CS.FLAT_GRID}) flat", host, build_device_scene(host, device=dev, use_bvh=False),
                  CS.BOX)
    for name, scene, rays, mask, any_hit in cases:
        args = CS.flat_args(scene, rays, mask)
        fn = KI.intersect_any if any_hit else KI.intersect_closest
        ref = fn(*args, cull=False)
        out = fn(*args, bounds=scene.tri_bounds, stats=True)
        warp, groups = (out[0], out[1]) if any_hit else (out[:4], out[4])
        thread = fn(*args, bounds=scene.tri_bounds, schedule="thread")
        if any_hit:
            off = int((warp != ref).sum()) + int((thread != ref).sum())
        else:
            off = CS.closest_off(warp, ref) + CS.closest_off(thread, ref)
        live = max(int((args[3] > args[2]).sum()), 1)
        rec = dict(set=name, kernel=fn.__name__, rays=args[2].shape[0], triangles=scene.v0.shape[0],
                   groups=scene.tri_bounds.shape[1], live=live, groups_per_live_ray=float(groups.sum()) / live,
                   lanes_off_cull_false=off,
                   warp_ms=CS.time_ms(lambda: fn(*args, bounds=scene.tri_bounds, schedule="warp")),
                   thread_ms=CS.time_ms(lambda: fn(*args, bounds=scene.tri_bounds, schedule="thread")),
                   warp_graph_ms=CS.graph_ms(lambda: fn(*args, bounds=scene.tri_bounds, schedule="warp")),
                   thread_graph_ms=CS.graph_ms(lambda: fn(*args, bounds=scene.tri_bounds, schedule="thread")),
                   warp_host_us=host_us(lambda: fn(*args, bounds=scene.tri_bounds, schedule="warp")),
                   thread_host_us=host_us(lambda: fn(*args, bounds=scene.tri_bounds, schedule="thread")))
        print(json.dumps(rec), flush=True)
        if off:
            return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
