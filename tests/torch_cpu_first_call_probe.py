#!/usr/bin/env python3
"""Does torch on the CPU give the same result on the first and the second
call of one function in a fresh process?

    JAX_PLATFORMS=cpu python3 tests/torch_cpu_first_call_probe.py [--procs 60] [--jobs 4]

A diagnostic beside the tests, not a test. For each of four settings
(torch's default thread count or one thread; JAX's CPU backend started in
the process first, as the tests that compare the port with the JAX package
do, or not) it starts --procs fresh processes. Each calls the port's
OmniPBR bsdf_evaluate twice on the same 4096 random lanes (the shading
tests' size), records every aten op of both calls, and reports the first
op whose output differs although its inputs are equal. Prints one JSON
line per setting: how many processes differed, and the ops, lanes and
values seen.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4096


def child(threads: int, with_jax: bool) -> dict:
    import numpy as np

    if with_jax:
        import jax.numpy as jnp

        jnp.asarray(np.ones(N, np.float32)).block_until_ready()
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    sys.path.insert(0, REPO)
    from strelka_tpu_torch.ops import bsdf as B
    from strelka_tpu_torch.ops.vec import Vec3

    if threads:
        torch.set_num_threads(threads)
    rng = np.random.default_rng(21)

    def unit():
        v = rng.normal(size=(3, N))
        return (v / np.linalg.norm(v, axis=0)).astype(np.float32)

    def vec(a):
        return Vec3(*(torch.tensor(c) for c in a))

    def f(lo, hi):
        return torch.tensor(rng.uniform(lo, hi, N).astype(np.float32))

    n = unit()
    t = np.cross(n.T, unit().T).T
    t = (t / np.linalg.norm(t, axis=0)).astype(np.float32)
    frame = B.ShadingFrame(vec(n), vec(t), vec(np.cross(n.T, t.T).T.astype(np.float32)), vec(n))
    mat = B.SurfaceParams(
        bsdf_type=torch.ones(N, dtype=torch.int32), diffuse_color=Vec3(f(0.05, 0.9), f(0.05, 0.9), f(0.05, 0.9)),
        metallic=f(0, 1), roughness=f(0.0, 1.0), specular_level=f(0.2, 0.8), ior=f(1.3, 1.8),
        glass_color=Vec3(f(0.5, 1), f(0.5, 1), f(0.5, 1)), opacity=torch.ones(N),
        emission_color=Vec3(torch.zeros(N), torch.zeros(N), torch.zeros(N)),
        thin_walled=torch.tensor(rng.random(N) < 0.2))
    k1, k2 = vec(unit()), vec(unit())

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            ins = [a.clone() for a in tree_leaves((args, kwargs)) if isinstance(a, torch.Tensor)]
            outs = [o.clone() for o in tree_leaves(out) if isinstance(o, torch.Tensor)]
            self.ops.append((str(func), ins, outs))
            return out

    def same(a, b):
        return torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))

    first, second = Record(), Record()
    with first:
        B.bsdf_evaluate(mat, frame, k1, k2)
    with second:
        B.bsdf_evaluate(mat, frame, k1, k2)
    res = {"threads": torch.get_num_threads(), "jax": with_jax, "torch": torch.__version__, "ops": len(first.ops)}
    for (op, ins1, outs1), (_, ins2, outs2) in zip(first.ops, second.ops):
        bad = [k for k, (a, b) in enumerate(zip(outs1, outs2)) if not same(a, b)]
        if bad:
            a, b = outs1[bad[0]].reshape(-1), outs2[bad[0]].reshape(-1)
            lanes = torch.nonzero(torch.nan_to_num(a) != torch.nan_to_num(b)).reshape(-1)
            k = int(lanes[0])
            res.update(op=op, inputs_equal=all(same(x, y) for x, y in zip(ins1, ins2)),
                       lanes_differ=int(lanes.numel()), lanes=[int(lanes.min()), int(lanes.max())],
                       first_vs_second=[float(a[k]), float(b[k])])
            break
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=60)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--child", type=int, nargs=2, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child[0], bool(args.child[1]))), flush=True)
        return 0

    def run(setting):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", *map(str, setting)],
                             stdout=subprocess.PIPE, text=True, check=True).stdout
        return json.loads(out.strip().splitlines()[-1])

    for setting in ((0, 1), (1, 1), (0, 0), (1, 0)):
        with ThreadPoolExecutor(args.jobs) as pool:
            results = list(pool.map(run, [setting] * args.procs))
        faults = [r for r in results if "op" in r]
        print(json.dumps({"threads": results[0]["threads"], "jax": results[0]["jax"], "torch": results[0]["torch"],
                          "procs": args.procs,
                          "first_call_differs": len(faults),
                          "seen": sorted({json.dumps({k: r[k] for k in ("op", "inputs_equal", "lanes_differ",
                                                                         "lanes", "first_vs_second")})
                                          for r in faults})}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
