#!/usr/bin/env python3
"""Where does the port's hair_long render part from the JAX package's?

    JAX_PLATFORMS=cpu python3 tests/torch_hair_long_probe.py [--depths 1 2 4] [--size 16]

A diagnostic beside the tests, not a test (several minutes on the CPU: the
JAX launches over 800,000 cones compile for minutes). On hair_long
(hair_patch(n_curves=20000)) at --size x --size, 1 spp, subframe 0, the JAX
device scene carried across to the port as tests/test_torch_render.py does:

  stage 0, torch's f32 sqrt on the CPU against numpy's (correctly rounded)
           on 2^20 values in [0.5, 4), and torch's sqrt through f64;
  stage 1, the camera rays (the port's against JAX's generate_camera_rays,
           jitted with the launch values as arguments, as in a launch);
  stage 2, the cone sweep of those rays (jitted intersect_curves_closest
           against the port's plain sweep): segment, t and u bit for bit;
  stage 3, the refinement of the sweep's hits (jitted refine_scene_curve_hit
           against the port's): t, u and the keep verdict bit for bit;
  stage 4, render_launch at each of --depths: the share of pixels within
           rtol 1e-3 and the share bit-equal, and the mean of each image.

Prints one JSON line a stage (a depth a line in stage 4), the lanes or
pixels that differ first.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--depths", type=int, nargs="*", default=[1, 2, 4])
    ap.add_argument("--size", type=int, default=16)
    ap.add_argument("--curves", type=int, default=20000)
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from strelka_tpu.ops import curve_refine as JR
    from strelka_tpu.ops import curves as JC
    from strelka_tpu.ops import integrator as JI
    from strelka_tpu.ops import sampler as JS
    from strelka_tpu.render.device_scene import build_device_scene as jax_build
    from strelka_tpu.scene import testscenes as JTS
    from strelka_tpu_torch.ops import integrator as TI
    from strelka_tpu_torch.ops import sampler as TS
    from strelka_tpu_torch.ops.curve_refine import refine_scene_curve_hit
    from strelka_tpu_torch.ops.intersect import intersect_curves_closest
    from strelka_tpu_torch.render.device_scene import device_scene_from_arrays

    torch.set_num_threads(1)
    w = h = args.size
    host = JTS.hair_patch(n_curves=args.curves)
    cam = host.get_camera(0)
    cam.update_aspect_ratio(1.0)
    c2v = np.asarray(cam.clip_to_view(), np.float32)
    v2w = np.asarray(cam.view_to_world(), np.float32)
    exposure = np.full(3, 6.25e-4, np.float32)
    jds = jax_build(host)
    arrays = {f.name: np.asarray(getattr(jds, f.name)) for f in dataclasses.fields(jds)
              if not isinstance(getattr(jds, f.name), tuple)}
    for name in ("bvh", "curves", "cones"):
        if getattr(jds, name) is not None:
            arrays[name] = tuple(np.asarray(x) for x in getattr(jds, name))
    tds = device_scene_from_arrays(arrays, "cpu")

    def report(**kw):
        print(json.dumps(kw), flush=True)

    def first(mask, k=8):
        return [int(i) for i in np.nonzero(np.asarray(mask))[0][:k]]

    # stage 0: torch's f32 square root on the CPU
    x = np.random.default_rng(0).uniform(0.5, 4.0, 1 << 20).astype(np.float32)
    exact = np.sqrt(x)
    report(stage=0, what="torch f32 sqrt", values=int(x.size),
           off=int((torch.sqrt(torch.from_numpy(x)).numpy() != exact).sum()),
           off_through_f64=int((torch.sqrt(torch.from_numpy(x).double()).float().numpy() != exact).sum()))

    # stage 1: camera rays (sample 0 of each pixel, row-major)
    n = w * h
    idx = np.arange(n)
    px, py = idx % w, idx // w
    tsidx = TS.make_sample_index(torch.from_numpy(px), torch.from_numpy(py), torch.zeros(n, dtype=torch.int64), 100000)
    dims0 = TS.random_dims(tsidx, 0, (0, 1, 2, 3, 4))
    tp = TI.LaunchParams(0, c2v, v2w, exposure, np.zeros(3, np.float32))
    to, td = TI.generate_camera_rays(tp, torch.from_numpy(px), torch.from_numpy(py), dims0[0], dims0[1], w, h)
    jsidx = JS.make_sample_index(jnp.asarray(px, jnp.uint32), jnp.asarray(py, jnp.uint32), jnp.zeros(n, jnp.uint32),
                                 100000)
    jdims = JS.random_dims(jsidx, 0, (0, 1, 2, 3, 4))
    jp = JI.LaunchParams(jnp.int32(0), jnp.asarray(c2v), jnp.asarray(v2w), jnp.asarray(exposure), jnp.zeros(3))
    jo, jd = jax.jit(lambda p, x, y, a, b: JI.generate_camera_rays(p, x, y, a, b, w, h))(
        jp, jnp.asarray(px, jnp.uint32), jnp.asarray(py, jnp.uint32), jdims[0], jdims[1])
    ray_off = sum(int((np.asarray(getattr(jo, c)) != getattr(to, c).numpy()).sum()) +
                  int((np.asarray(getattr(jd, c)) != getattr(td, c).numpy()).sum()) for c in "xyz")
    dir_off = np.stack([np.asarray(getattr(jd, c)) != getattr(td, c).numpy() for c in "xyz"])
    report(stage=1, what="camera rays", lanes=n, values_off=ray_off, first_direction_off=first(dir_off.any(axis=0)))

    # stage 2: the cone sweep
    tmin, tmax = np.zeros(n, np.float32), np.full(n, 1e16, np.float32)
    t0 = time.time()
    jhit = jax.jit(JC.intersect_curves_closest)(jds.cones, jo, jd, jnp.asarray(tmin), jnp.asarray(tmax))
    jax_s = time.time() - t0
    thit = intersect_curves_closest(tds, to, td, torch.from_numpy(tmin), torch.from_numpy(tmax))
    jt, jseg, ju = (np.asarray(x) for x in jhit)
    tt, tseg, tu = (x.numpy() for x in thit)
    hits = jseg >= 0
    off = (jseg != tseg) | (hits & ((jt != tt) | (ju != tu)))
    report(stage=2, what="cone sweep", lanes=n, hits=int(hits.sum()), lanes_off=int(off.sum()), first_off=first(off),
           jax_seconds=round(jax_s, 1))

    # stage 3: the refinement of the sweep's hits, each package from its own sweep
    jref = jax.jit(lambda o, d, t, s, u: JR.refine_scene_curve_hit(jds.curves, o, d, t, s, u))(
        jo, jd, jhit.t, jhit.seg, jhit.u)
    tref = refine_scene_curve_hit(tds.curves, to, td, thit.t, thit.seg, thit.u)
    (jrt, jru, jkeep), (trt, tru, tkeep) = ((np.asarray(x) for x in jref), (x.numpy() for x in tref))
    keep_off = hits & (jkeep != tkeep)
    tu_off = hits & jkeep & tkeep & ((jrt != trt) | (jru != tru))
    report(stage=3, what="refinement", hits=int(hits.sum()), keep_off=int(keep_off.sum()),
           first_keep_off=first(keep_off), t_or_u_off=int(tu_off.sum()), first_t_or_u_off=first(tu_off),
           max_rel_t=float(np.max(np.abs(jrt - trt)[hits & jkeep & tkeep] / np.abs(jrt)[hits & jkeep & tkeep],
                                  initial=0.0)))

    # stage 4: whole launches by depth
    for depth in args.depths:
        kw = dict(width=w, height=h, samples_per_launch=1, max_sample_count=100000, max_depth=depth,
                  enable_accumulation=True)
        t0 = time.time()
        _, jimg = jax.jit(lambda s, p, st: JI.render_launch(s, p, st, **kw))(jds, jp, JI.make_frame_state(h, w))
        ref = np.asarray(jimg)
        jax_s = time.time() - t0
        _, timg = TI.render_launch(tds, tp, TI.make_frame_state(h, w, "cpu"), **kw)
        out = timg.numpy()
        within = np.isclose(out, ref, rtol=1e-3, atol=0.0).all(axis=0)
        equal = (out == ref).all(axis=0)
        report(stage=4, depth=depth, pixels=n, within_rtol_1e3=float(within.mean()), bit_equal=float(equal.mean()),
               mean_port=float(out.mean()), mean_jax=float(ref.mean()),
               first_off_rc=[[int(r), int(c)] for r, c in np.argwhere(~within)[:8]], jax_seconds=round(jax_s, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
