"""Where the wavefront order's time goes on the card: the pieces of one
bounce's sort (ops/integrator.py:_sort_wavefront) and of the launch's two
restores, timed alone from CUDA graphs on a main path's own rays.

  python3 scripts/torch_order_probe.py [--scene box_field|kitchen|hair_long]

The pieces, at the main path's wavefront (box_field and kitchen 512x512
2 spp: 2^19 lanes; hair_long 384x384 2 spp): the sort key (_ray_sort_key
and the dead lanes' key), the stable sort of the int32 keys, the packing
of the 21 state columns into an int32 table, K4's [N, 21] gather, the
unpacking of its rows, and _sort_wavefront whole; the radiance restore
(the inverse permutation's scatter and the [N, 4] permute) and the Z-order
restore ([n, 11]) whole. The state columns are the bounce-1 rays of
chip_smoke.py:main_path_rays and zeros of each column's dtype. Prints one
line a piece (ms replayed from a CUDA graph of 20 calls, median of 10) and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("box_field", "kitchen", "hair_long"), default="box_field")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_order_probe: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as C
    from strelka_tpu_torch.kernels import build
    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.ops import vec as V
    from strelka_tpu_torch.ops.vec import Vec3
    from strelka_tpu_torch.render.device_scene import build_device_scene

    build.load()
    dev = torch.device("cuda")
    if args.scene == "hair_long":
        cfg = C.HAIR_LONG
        host, scene = C.hair_scene(cfg, dev)
    else:
        if args.scene == "box_field":
            from strelka_tpu_torch.scene import testscenes as TS

            cfg, host = C.BOX, TS.box_field(grid=C.BOX_GRID)
        else:
            from strelka_tpu_torch.scene.kitchen import ensure_kitchen

            cfg, host = C.KITCHEN, C.usd_host(ensure_kitchen())[0]
        scene = build_device_scene(host, device=dev)
    _, _, b1, _, _, _, _ = C.main_path_rays(scene, C.launch_params(host, cfg.width, cfg.height, 0), dev, cfg)
    n = cfg.width * cfg.height
    m = n * cfg.spp
    o, d = Vec3(*b1["o"]), Vec3(*b1["d"])
    alive = b1["tmax"] > b1["tmin"]
    f32 = [*o, *d] + [torch.zeros(m, dtype=torch.float32, device=dev) for _ in range(8)]
    bits = [torch.zeros(m, dtype=torch.int64, device=dev), torch.zeros(m, dtype=torch.int32, device=dev),
            torch.zeros(m, dtype=torch.int32, device=dev), torch.zeros(m, dtype=torch.bool, device=dev),
            torch.zeros(m, dtype=torch.bool, device=dev), alive, torch.arange(m, dtype=torch.int32, device=dev)]
    key = torch.where(alive, I._ray_sort_key(scene, o, d), I.DEAD_KEY)
    perm = torch.sort(key, stable=True).indices.to(torch.int32)
    table = torch.stack([I._as_i32(c) for c in f32 + bits], dim=1)
    rows = V.gather_rows_t(table.view(torch.float32), perm).view(torch.int32)
    zorder, z_inv = I.pixel_zorder(cfg.width, cfg.height, dev)
    per_pixel = [torch.zeros(n, dtype=torch.float32, device=dev) for _ in range(9)]
    counts = [torch.zeros(n, dtype=torch.int32, device=dev) for _ in range(2)]

    def restore():
        inv = torch.empty(m, dtype=torch.int32, device=dev).scatter_(0, bits[6].to(torch.int64),
                                                                      torch.arange(m, dtype=torch.int32, device=dev))
        return I._permute_packed(inv, f32[6:9], bits[1:2])

    pieces = [
        ("sort key (_ray_sort_key, dead lanes)", lambda: torch.where(alive, I._ray_sort_key(scene, o, d), I.DEAD_KEY)),
        ("torch.sort, stable, int32 keys", lambda: torch.sort(key, stable=True)),
        ("pack 21 columns into an int32 table", lambda: torch.stack([I._as_i32(c) for c in f32 + bits], dim=1)),
        ("K4 gather [N, 21]", lambda: V.gather_rows_t(table.view(torch.float32), perm)),
        ("unpack 21 rows", lambda: [I._from_i32(rows[i], c) for i, c in enumerate(f32 + bits)]),
        ("_sort_wavefront whole (one bounce)", lambda: I._sort_wavefront(scene, o, d, alive, f32, bits)),
        ("radiance restore whole (scatter, [N, 4])", restore),
        ("Z-order restore whole ([n, 11])", lambda: I._permute_packed(z_inv, per_pixel, counts)),
    ]
    card = C.card_name_and_power_limit()
    out = []
    for name, fn in pieces:
        ms = C.graph_ms(fn, calls=20)
        out.append(dict(scene=args.scene, lanes=m, piece=name, device_ms=ms, card=card))
        print(json.dumps(out[-1]), flush=True)
    sorts = cfg.depth - 1
    whole = next(r["device_ms"] for r in out if r["piece"].startswith("_sort_wavefront"))
    ends = sum(r["device_ms"] for r in out if "restore whole" in r["piece"])
    print(json.dumps(dict(scene=args.scene, sorts_a_launch=sorts, order_ms_a_launch=sorts * whole + ends, card=card)),
          flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
