#!/usr/bin/env python3
"""K7 and K8 of two trees on one card, in turns: A, B, B, A.

Run on a machine with one CUDA card, from the root of a checkout:

    python3 scripts/torch_cone_ab.py --a build/parent [--b .]

`--a` and `--b` are checkouts (B defaults to this one). Each turn is a
process in its tree that builds that tree's kernels, makes the first launch's
rays of hair_patch(n_curves=256) and hair_long (hair_patch(n_curves=20000))
at 384x384, 2 spp as that tree's chip_smoke.py makes them, and times K7 on
the bounce-1 rays and K8 on the shadow rays, swept as that tree's main path
sweeps them (a tree with `ops/intersect.py:cone_sweep_order` over kernel
K9's order per ray tile on hair_long, whose time is then `order_ms`; one
with the cone tree walks the tree): `ms` by CUDA events
(chip_smoke.py:time_ms) and `device_ms` replayed alone from a CUDA graph
(chip_smoke.py:graph_ms), with the live rays and the hits. One JSON line per
turn, kernel and scene, then the card's name and power limit. Exits non-zero
if a turn fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke as S
from strelka_tpu_torch.kernels import build
from strelka_tpu_torch.kernels import cones as KC
from strelka_tpu_torch.ops import curves as C
try:
    from strelka_tpu_torch.ops.intersect import cone_sweep_order
except ImportError:  # the cone tree: no sweep order
    cone_sweep_order = None

torch.backends.cuda.matmul.allow_tf32 = False
build.load()
dev = torch.device("cuda")
for cfg in (S.HAIR, S.HAIR_LONG):
    host, scene = S.hair_scene(cfg, dev)
    params = S.launch_params(host, cfg.width, cfg.height, 0)
    _, camera, bounce1, shadow, *_ = S.main_path_rays(scene, params, dev, cfg)
    for kernel, rays in (("cone_closest", bounce1), ("cone_any", shadow)):
        args = S.cone_args(scene, rays)
        o, d, tmin, tmax, pc = args
        order = None if cone_sweep_order is None else cone_sweep_order(pc, o, d, tmin, tmax)
        kw = {} if cone_sweep_order is None else {"order": order}
        fn = KC.cone_closest if kernel == "cone_closest" else KC.cone_any
        out = fn(*args, **kw)
        hits = int((out[1] >= 0).sum()) if kernel == "cone_closest" else int(out.sum())
        row = dict(kernel=kernel, scene=cfg.name, rays=int(tmin.shape[0]), live_rays=int((tmax > tmin).sum()),
                   hits=hits, order=order is not None,
                   ms=S.time_ms(lambda: fn(*args, **kw), samples=7, inner=3, warmup=1),
                   device_ms=S.graph_ms(lambda: fn(*args, **kw), calls=5, samples=7))
        if order is not None:
            row["order_ms"] = S.graph_ms(lambda: cone_sweep_order(pc, o, d, tmin, tmax), calls=5, samples=7)
        else:  # the tree walk's counters a live ray, and the roofline's count (cones whose own box is entered)
            st = fn(*args, stats=True)[-1]
            live = tmax > tmin
            row.update({k: float(v[live].float().mean()) for k, v in zip(("boxes", "leaves", "cones"), st.per_ray)})
            row["blocks_per_sm"] = KC.occupancy(kernel == "cone_any", pc.reach > 0.0, dev)[0]
            if kernel == "cone_closest":
                pick = torch.nonzero(live)[:, 0]
                pick = pick[torch.randperm(pick.numel(), generator=torch.Generator().manual_seed(7))[:2048].to(dev)]
                cut = lambda a: a[pick].contiguous()
                own = C.cones_entered(pc.geom, tuple(cut(c) for c in o), tuple(cut(c) for c in d), cut(tmin),
                                      cut(torch.minimum(out[0], tmax)))
                row["bound_cones"] = float(own.float().mean())
        print(json.dumps(row), flush=True)
    del scene
"""


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", default=REPO)
    args = ap.parse_args()
    for tag in ("a_1", "b_1", "b_2", "a_2"):
        tree = os.path.abspath(args.a if tag.startswith("a") else args.b)
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, timeout=1800)
        if proc.returncode != 0:
            print(f"turn {tag} ({tree}) exited {proc.returncode}: {proc.stderr[-3000:]}", file=sys.stderr)
            return 1
        for line in proc.stdout.splitlines():
            if line.startswith("{"):
                print(json.dumps(dict(run=tag, **json.loads(line))), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
