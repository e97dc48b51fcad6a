#!/usr/bin/env python3
"""How many rays should share one sweep order of the cone kernels?

Run on a machine with one CUDA card, from the root of a checkout:

    python3 scripts/torch_cone_tile_probe.py

Builds hair_patch(n_curves=20000) (800,000 round cones in 391 superblocks),
takes the camera, bounce-1 and shadow rays of the 384x384, 2 spp main path
as chip_smoke.py makes them, and for tiles of 32, 64, 128 and 256 rays
prints one JSON line per ray set: the time of kernel K9 alone and of the
whole order (K9, the sort, the count), the times of K7 and K8 swept in that
order, the sub-blocks each sweeps a live ray and the superblocks a tile
passes. `ops/curves.py:CONE_ORDER_TILE` is chosen from these lines.
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
    from strelka_tpu_torch.kernels import open_w as KO

    if not torch.cuda.is_available():
        print("torch_cone_tile_probe: no CUDA device", file=sys.stderr)
        return 2
    build.load()
    dev = torch.device("cuda")
    host, scene = S.hair_scene(S.HAIR_LONG, dev)
    params = S.launch_params(host, S.HAIR_LONG.width, S.HAIR_LONG.height, 0)
    _, camera, bounce1, shadow, *_ = S.main_path_rays(scene, params, dev, S.HAIR_LONG)
    for name, rays in (("bounce-1", bounce1), ("shadow", shadow), ("camera", camera)):
        o, d, tmin, tmax, pc = S.cone_args(scene, rays)
        live = int((tmax > tmin).sum())
        for tile in (32, 64, 128, 256):
            order = KO.sweep_order(o, d, tmin, tmax, pc.sbounds, tile)
            st7 = KC.cone_closest(o, d, tmin, tmax, pc, stats=True, order=order)[3].per_ray
            st8 = KC.cone_any(o, d, tmin, tmax, pc, stats=True, order=order)[1].per_ray
            few = dict(samples=5, inner=2, warmup=1)
            print(json.dumps(dict(
                rays=name, tile=tile, live_rays=live,
                k9_ms=S.time_ms(lambda: KO.open_w(o, d, tmin, tmax, pc.sbounds, tile=tile)),
                order_ms=S.time_ms(lambda: KO.sweep_order(o, d, tmin, tmax, pc.sbounds, tile)),
                k7_ms=S.time_ms(lambda: KC.cone_closest(o, d, tmin, tmax, pc, order=order), **few),
                k8_ms=S.time_ms(lambda: KC.cone_any(o, d, tmin, tmax, pc, order=order), **few),
                k7_sub_blocks_per_ray=float(st7[0].sum()) / live, k8_sub_blocks_per_ray=float(st8[0].sum()) / live,
                superblocks_passed_per_tile=float(order.count.sum()) / order.count.shape[0],
            )), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
