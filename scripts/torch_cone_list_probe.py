#!/usr/bin/env python3
"""How many superblocks should a ray of K7's near-to-far walk list at a time?

Run on a machine with one CUDA card, from the root of a checkout:

    python3 scripts/torch_cone_list_probe.py

Builds hair_patch(n_curves=256) and hair_patch(n_curves=20000) ("hair_long",
800,000 round cones in 391 superblocks), takes the bounce-1 rays of the
384x384, 2 spp main path as chip_smoke.py makes them, and for lists of 4, 8,
16, 32 and 64 (tnear, superblock) entries a ray (4 to 64 KB of shared memory
a block of 128 threads) prints one JSON line per scene: K7's blocks per SM,
its time, the sub-blocks it sweeps a live ray and the share of its cone
loop's lane slots that test a cone. `ops/curves.py:CONE_LIST` is chosen from
these lines; every list size gives the same result (checked here).
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    import torch

    import chip_smoke as S
    from strelka_tpu_torch.kernels import build
    from strelka_tpu_torch.kernels import cones as KC
    from strelka_tpu_torch.ops import curves as C
    from strelka_tpu_torch.ops.intersect import cone_sweep_order

    if not torch.cuda.is_available():
        print("torch_cone_list_probe: no CUDA device", file=sys.stderr)
        return 2
    build.load()
    dev = torch.device("cuda")
    kept = C.CONE_LIST
    for cfg in (S.HAIR, S.HAIR_LONG):
        host, scene = S.hair_scene(cfg, dev)
        params = S.launch_params(host, cfg.width, cfg.height, 0)
        _, _, bounce1, *_ = S.main_path_rays(scene, params, dev, cfg)
        o, d, tmin, tmax, pc = S.cone_args(scene, bounce1)
        order = cone_sweep_order(pc, o, d, tmin, tmax)
        live = int((tmax > tmin).sum())
        first = None
        try:
            for cap in (4, 8, 16, 32, 64):
                C.CONE_LIST = cap
                t, c, y, st = KC.cone_closest(o, d, tmin, tmax, pc, stats=True, order=order)
                first = first or (t, c, y)
                if not all(torch.equal(a, b) for a, b in zip(first, (t, c, y))):
                    raise AssertionError(f"K7 with a list of {cap} differs from the first list size")
                print(json.dumps(dict(
                    scene=cfg.name, list_cap=cap, live_rays=live,
                    blocks_per_sm=KC.occupancy(False, True, True, dev)[0],
                    k7_ms=S.time_ms(lambda: KC.cone_closest(o, d, tmin, tmax, pc, order=order), samples=5, inner=2,
                                    warmup=1),
                    sub_blocks_per_ray=float(st.per_ray[0].sum()) / live,
                    lane_efficiency=float(st.slots[1]) / float(st.slots[0]),
                )), flush=True)
        finally:
            C.CONE_LIST = kept
        del scene
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
