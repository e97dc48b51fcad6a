#!/usr/bin/env python3
"""Two trees' chip_smoke.py on one card, in turns: A, B, B, A.

Run on a machine with one CUDA card, from the root of a checkout:

    python3 scripts/torch_ab.py --a build/parent [--b .] [--out build/ab]

`--a` and `--b` are checkouts (B defaults to this one); each run builds its
own kernels under its checkout. Every run's output goes to `--out`
(a_1.log, b_1.log, b_2.log, a_2.log), and the script prints one JSON line
per run and row of the Sobol, triangle, gather, BVH and cone kernels (ms, bound_ms,
launches, the groups, nodes or sub-blocks a live ray sweeps where the line
has them), one per run and main path (ms per launch, padded Mrays/s) and last
the card's name and power limit. It exits non-zero if a run fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEEP = ("ms", "bound_ms", "plain_ms", "launches", "boxes_per_ray", "leaves_per_ray", "cones_per_ray",
        "needed_cones_per_ray", "sub_block_cones_per_ray", "lane_efficiency", "schedule", "device_ms", "warp_ms",
        "thread_ms", "warp_device_ms", "thread_device_ms", "dense_bound_ms", "groups_per_ray", "needed_groups_per_ray",
        "nodes_per_ray", "ideal_nodes_per_ray", "primed_nodes_per_ray", "dfs_nodes_per_ray", "tris_per_ray",
        "stack_depth", "registers", "local_bytes", "order_ms", "library_ms", "zeros_ms", "host_us", "rows_per_ray",
        "dfs_tris_per_ray")
KERNELS = ("sobol", "intersect_closest", "intersect_any", "gather_rows_t", "bvh_closest", "bvh_any", "cone_closest",
           "cone_any", "open_w")


def summarise(tag: str, out: str) -> list:
    lines = []
    for raw in out.splitlines():
        if not raw.startswith("{"):
            continue
        rec = json.loads(raw)
        if "main_path" in rec:
            m = rec["main_path"]
            lines.append(dict(run=tag, main_path=m["scene"], ms_per_launch=m.get("ms_per_launch"),
                              padded_mrays_per_s=m.get("padded_mrays_per_s")))
        elif "kernel" in rec and rec["kernel"] in KERNELS:
            lines.append(dict(run=tag, kernel=rec["kernel"], at=rec["at"], **{k: rec[k] for k in KEEP if k in rec}))
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--a", required=True)
    ap.add_argument("--b", default=REPO)
    ap.add_argument("--out", default=os.path.join(REPO, "build", "ab"))
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    for tag in ("a_1", "b_1", "b_2", "a_2"):
        tree = os.path.abspath(args.a if tag.startswith("a") else args.b)
        t0 = time.perf_counter()
        run = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tree, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        with open(os.path.join(args.out, f"{tag}.log"), "w") as f:
            f.write(run.stdout)
        print(json.dumps(dict(run=tag, tree=tree, rc=run.returncode, seconds=time.perf_counter() - t0)), flush=True)
        if run.returncode != 0:
            print(run.stdout[-4000:], flush=True)
            return 1
        for line in summarise(tag, run.stdout):
            print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
