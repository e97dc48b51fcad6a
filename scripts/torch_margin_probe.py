#!/usr/bin/env python3
"""Count the lanes the box test's margin leaves to chance, on the CPU.

    python3 scripts/torch_margin_probe.py [--cases 64] [--rays 512]

Runs the coplanar grids of `strelka_tpu_torch/scene/grazing.py:plane_case`
(turned, scaled and moved at random, rays at their vertices, edges and
overlaps at angles to the plane whose sine is log-uniform down to 1e-5)
through the plain walks of kernels K2/K3 (`kernels/intersect.py`) and K5
(`ops/bvh.py:intersect_bvh_ordered_plain`), with the port's margin and with
the reference's exact test (pad and slack 0), against the dense sweep. It
prints one JSON line: the lanes whose dense hit lies outside the margin's
domain (normalised determinant below ops/slab.py:NU_MIN) and, for each
walk and test, the lanes that differ from the dense sweep, split by inside
and outside the domain, with the least and the largest normalised
determinant among them.
It also counts, for the round cones of `grazing.py:cone_face_case` (rays
at the faces and corners of the cone tree's leaf and node boxes), the
lanes where K7's walk of the cone tree (its plain count,
`ops/curves.py:cone_tree_walk`) ends at another t than the dense sweep and
where K8's walk (`any_hit=True`) differs from the dense any-hit sweep, with
the margin and with the exact test; for the rays of
`grazing.py:cone_grazing_case` (rays that graze a leaf or node box's face
at angles log-uniform down to 1e-5, over cones at the boxes' faces and
over hair-like cones) the same lanes with the margin (ROADMAP C.4); and
the boxes K5's walk tests a live ray of box_field(grid=12)'s first launch
at 96x96 (camera and bounce-1 rays, as chip_smoke.py makes them) with
either test. The counts are the plain walks'; the kernels equal them bit
for bit.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strelka_tpu_torch.kernels import intersect as KI  # noqa: E402
from strelka_tpu_torch.ops import curves as C  # noqa: E402
from strelka_tpu_torch.ops import bvh as TB  # noqa: E402
from strelka_tpu_torch.ops import slab  # noqa: E402
from strelka_tpu_torch.scene import grazing as G  # noqa: E402

MASK = 1


def _t(a):
    return torch.tensor(np.ascontiguousarray(a))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", type=int, default=64)
    ap.add_argument("--rays", type=int, default=512)
    args = ap.parse_args()
    rng = np.random.default_rng(2026)
    margin = slab.slab_tnear
    exact = functools.partial(margin, pad=0.0, slack=0.0)
    tally = {"lanes": 0, "hits": 0, "hits_outside": 0}
    for case in range(args.cases):
        params = (case, float(10 ** rng.uniform(-2, 3)), float(10 ** rng.uniform(-1, 3)), int(rng.integers(2, 13)),
                  int(rng.integers(2, 13)), bool(case % 2), 1e-5)
        tris, rays = G.plane_case(*params, n=args.rays)
        o, d, tmin, tmax, ex = rays
        flat = (tuple(_t(o[:, k]) for k in range(3)), tuple(_t(d[:, k]) for k in range(3)), _t(tmin), _t(tmax),
                _t(ex)) + tuple(_t(a) for a in tris)
        bounds = _t(KI.tri_group_bounds(*tris))
        dense = KI.closest_plain(*flat, MASK)
        nu = slab.normalised_det(flat[1], flat[6], flat[7])
        won = dense[1] >= 0
        nu_won = torch.where(won, nu.gather(1, dense[1].clamp(min=0).long()[:, None])[:, 0], 1.0)
        outside = won & (nu_won < slab.NU_MIN)
        tally["lanes"] += int(tmin.shape[0])
        tally["hits"] += int(won.sum())
        tally["hits_outside"] += int(outside.sum())
        threaded, perm, _ = TB.build_threaded(*tris[:3])
        tree = TB.device_bvh(threaded, "cpu")
        leaf = tuple(_t(a[perm]) for a in tris)
        dense_leaf = KI.closest_plain(*flat[:5], *leaf, MASK)
        for test, fn in (("margin", margin), ("exact", exact)):
            KI.slab_tnear = fn
            TB.slab.slab_tnear = fn
            try:
                k2 = KI.closest_walk_plain(*flat, MASK, bounds)
                k5 = TB.intersect_bvh_ordered_plain(*flat[:5], tree, *leaf, MASK)
            finally:
                KI.slab_tnear = margin
                TB.slab.slab_tnear = margin
            for walk, out, ref in (("k2", k2, dense), ("k5", k5, dense_leaf)):
                off = (out[1] != ref[1]) | (out[0].view(torch.int32) != ref[0].view(torch.int32))
                for where, sel in (("inside", off & ~outside), ("outside", off & outside)):
                    key = f"{walk}_{test}_off_{where}"
                    tally[key] = tally.get(key, 0) + int(sel.sum())
                    if bool(sel.any()):
                        low, high = f"{walk}_{test}_least_nu_{where}", f"{walk}_{test}_most_nu_{where}"
                        tally[low] = min(tally.get(low, 1.0), float(nu_won[sel].min()))
                        tally[high] = max(tally.get(high, 0.0), float(nu_won[sel].max()))
    # the cone sweeps (ROADMAP C.2): K7's and K8's walks of the cone tree at its boxes' faces
    for seed in range(6):
        for scale, shift in ((1.0, 0.0), (100.0, 0.0), (0.01, 5.0), (1.0, 300.0)):
            geom, tree, o, d = (_t(a) for a in G.cone_face_case(seed, scale, shift))
            o, d = tuple(o[:, k].contiguous() for k in range(3)), tuple(d[:, k].contiguous() for k in range(3))
            n = o[0].shape[0]
            tmin, tmax = torch.zeros(n), torch.full((n,), 1e16)
            t_p, _, _ = C.intersect_curves_closest_plain(geom, o, d, tmin, tmax)
            occ_p = C.intersect_curves_any_plain(geom, o, d, tmin, tmax)
            tally["cone_lanes"] = tally.get("cone_lanes", 0) + n
            for test, fn in (("margin", margin), ("exact", exact)):
                C.slab_tnear = fn
                try:
                    best = C.cone_tree_walk(geom, tree, o, d, tmin, tmax).t
                    occ = C.cone_tree_walk(geom, tree, o, d, tmin, tmax, any_hit=True).t < C.MISS_T
                finally:
                    C.slab_tnear = margin
                k7 = int((best.view(torch.int32) != t_p.view(torch.int32)).sum())
                k8 = int((occ != occ_p).sum())
                for key, val in ((f"k7_{test}_off", k7), (f"k8_{test}_off", k8)):
                    tally[key] = tally.get(key, 0) + val
    # ROADMAP C.4: rays grazing the cone tree's leaf and node boxes at log-uniform angles, the walks against the
    # dense sweeps
    for hair in (False, True):
        for seed in range(4):
            for scale, shift in ((1.0, 0.0), (100.0, 0.0), (0.01, 5.0), (1.0, 300.0)):
                geom, tree, o, d = (_t(a) for a in G.cone_grazing_case(seed, scale, shift, hair))
                o, d = tuple(o[:, k].contiguous() for k in range(3)), tuple(d[:, k].contiguous() for k in range(3))
                n = o[0].shape[0]
                tmin, tmax = torch.zeros(n), torch.full((n,), 1e16)
                t_p, c_p, _ = C.intersect_curves_closest_plain(geom, o, d, tmin, tmax)
                occ_p = C.intersect_curves_any_plain(geom, o, d, tmin, tmax)
                best = C.cone_tree_walk(geom, tree, o, d, tmin, tmax).t
                occ = C.cone_tree_walk(geom, tree, o, d, tmin, tmax, any_hit=True).t < C.MISS_T
                pre = f"cone_grazing_{'hair' if hair else 'faces'}"
                tally[f"{pre}_lanes"] = tally.get(f"{pre}_lanes", 0) + n
                tally[f"{pre}_hits"] = tally.get(f"{pre}_hits", 0) + int((c_p >= 0).sum())
                tally[f"{pre}_tree_levels"] = len(C.cone_tree_levels(geom.shape[0]))
                key = f"{pre}_k7_off"
                tally[key] = tally.get(key, 0) + int((best.view(torch.int32) != t_p.view(torch.int32)).sum())
                key = f"{pre}_k8_off"
                tally[key] = tally.get(key, 0) + int((occ != occ_p).sum())
    # what the margin costs K5's walk: boxes tested a live ray on box_field(grid=12)'s first-launch rays
    import chip_smoke as CS
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, build_device_scene
    from strelka_tpu_torch.scene import testscenes

    host = testscenes.box_field(grid=12)
    scene = build_device_scene(host, device="cpu")
    cfg = CS.Config("box_field", 96, 96, 1, 4, 1, ())
    _, camera, bounce1, *_ = CS.main_path_rays(scene, CS.launch_params(host, 96, 96, 0), torch.device("cpu"), cfg)
    for name, rays in (("camera", camera), ("bounce1", bounce1)):
        bargs = CS.bvh_args(scene, rays, RAY_MASK_PRIMARY)
        live = int((bargs[3] > bargs[2]).sum())
        for test, fn in (("margin", margin), ("exact", exact)):
            TB.slab.slab_tnear = fn
            try:
                counts = TB.intersect_bvh_ordered_plain(*bargs, counts=True)[4]
            finally:
                TB.slab.slab_tnear = margin
            tally[f"grid12_{name}_{test}_boxes_per_ray"] = float(counts.nodes.sum()) / live
    tally.update(nu_min=slab.NU_MIN, pad=slab.PAD, slack=slab.SLACK, cases=args.cases, rays_a_case=args.rays)
    print(json.dumps(tally))
    return 0


if __name__ == "__main__":
    sys.exit(main())
