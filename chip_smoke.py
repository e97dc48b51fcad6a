#!/usr/bin/env python3
"""H100 probe of the PyTorch/CUDA port (strelka_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the CUDA kernels from strelka_tpu_torch/csrc with nvcc (sm_90a,
     one nvcc per source, all started together) into
     strelka_tpu_torch/_build/;
  2. Cornell (flat scene, kernels K1-K4): hold each kernel against its plain
     PyTorch version on the card at every shape the Cornell main path
     gives it (512x512, 4 spp: 2^20 rays a bounce) and time both (CUDA
     events, median); render the golden config through TorchRender and require
     SSIM >= 0.99 against goldens/cornell_golden.png; drive the main path
     at full size (render_launch, depth 4, accumulation: 1 warm-up + 16
     timed launches) with every launch count reset just before and read
     just after;
  3. box_field(grid=12), 25,732 triangles, built flat and with the BVH:
     K2/K3 against their plain versions at that size, K5/K6 against K2/K3,
     and the two golden-config renders compared;
  4. box_field(grid=48), 411,652 triangles on a BVH (kernels K1, K4, K5,
     K6): K5/K6 against the plain traversal and against K2/K3 brute force
     on the scene's camera, bounce-1 and shadow rays (2^19 lanes each),
     their times and bounds, K1 at 2^19 sample indices, K4 at this scene's
     two tables (attr_table [411776, 68] and light_table [2, 20]); the
     golden config
     against goldens/box_field_golden.png; the main path at 512x512, 2 spp,
     depth 4 (1 warm-up + 4 timed launches), counts reset and read as above;
     after each main path, every (kernel, shape) it launched must be one
     that was held against its plain version before;
  5. hair_patch(n_curves=256), 1,280 cubic B-spline segments as 10,240 round
     cones over a ground quad (kernels K1-K4, K7, K8): K7 and K8 against the
     plain dense sweep (t, cone, y and occlusion equal on every lane) and
     against their own cull=False mode on the scene's camera, bounce-1 and
     shadow rays
     (384x384x2 = 294,912 lanes each), K1-K4 at this scene's shapes; the
     golden config (64x64, 4 spp x 16 launches) against
     goldens/hair_patch_golden.png; the main path at 384x384, 2 spp, depth 4
     (1 warm-up + 4 timed launches);
  6. hair_patch(n_curves=20000) ("hair_long"), 100,000 segments as 800,000
     cones in 391 superblocks, where kernel K9 gives K7/K8 each ray tile's
     superblocks nearest first: K9 against its plain version (W and min_tn
     bit for bit, and the open flag with the reference's K = 16 nearest
     superblocks swept) on every lane; K7/K8 in that order against
     cull=False and against their ascending sweep on every lane and against
     the plain sweep on a fixed subset of 2^14 lanes, the sub-blocks and cones
     a ray tests beside what it needs (counted in plain PyTorch); the main
     path at 384x384, 2 spp, depth 4 (1 warm-up + 2 timed launches), no
     golden;
  7. print the kernels' JSON line, the card's name and power limit, and
     last the {"ok": true, ...} line.

It exits non-zero without a result where there is no CUDA device or no
strelka_tpu_torch package beside it. It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from typing import NamedTuple

REPO = os.path.dirname(os.path.abspath(__file__))


class Config(NamedTuple):
    """One row of bench.py's config list: a scene at a launch shape."""

    name: str
    width: int
    height: int
    spp: int
    depth: int
    timed_launches: int
    kernels: tuple  # the kernels its main path runs


# main-path configurations (the cornell and box_field rows of bench.py:231-232)
CORNELL = Config("cornell", 512, 512, 4, 4, 16, ("sobol", "intersect_closest", "intersect_any", "gather_rows_t"))
BOX = Config("box_field", 512, 512, 2, 4, 4, ("sobol", "bvh_closest", "bvh_any", "gather_rows_t"))
_HAIR_KERNELS = ("sobol", "intersect_closest", "intersect_any", "gather_rows_t", "cone_closest", "cone_any")
HAIR = Config("hair_patch", 384, 384, 2, 4, 4, _HAIR_KERNELS)  # bench.py:238
HAIR_LONG = Config("hair_long", 384, 384, 2, 4, 2, _HAIR_KERNELS + ("open_w",))  # bench.py:239
HAIR_CURVES = {"hair_patch": 256, "hair_long": 20000}  # bench.build_host_scene
HAIR_GOLDEN = (64, 64, 4, 16)  # bench.GOLDEN_CONFIGS["hair_patch"]
PLAIN_SUBSET = 1 << 14  # lanes of hair_long held against the plain dense sweep
BOX_GRID = 48  # bench.build_host_scene("box_field"): 411,652 triangles
FLAT_GRID = 12  # 25,732 triangles: the range of the TPU's _flat/_mxu_flat kernels
MAX_SAMPLE_COUNT = 100000  # as bench.py's render_launch
EXPOSURE = [6.25e-4] * 3  # as bench.py's build_scene
GOLDEN = (64, 64, 4, 4)  # bench.GOLDEN_CONFIGS of both scenes: w, h, spp, launches

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # non-tensor f32
# Integer work, per pipe: instructions per SM per clock for compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput) x 132 SMs x 1.98 GHz boost clock.
SM_CLOCKS_PER_S = 132 * 1.98e9
PIPE_RATE = {
    "alu": 64,  # 32-bit integer add, logic (LOP3), shift, compare, f32 min/max
    "fma": 64,  # 32-bit integer multiply(-add) (IMAD); f32 multiply at 128 counted as 1/2
    "xu": 16,  # bit reverse, population count, int -> f32 conversion
}

REPLACES = {
    "sobol": ("strelka_tpu/ops/sampler.py:307", "strelka_tpu_torch/csrc/sobol.cu"),
    "intersect_closest": ("strelka_tpu/ops/pallas_intersect.py:2574", "strelka_tpu_torch/csrc/intersect.cu"),
    "intersect_any": ("strelka_tpu/ops/pallas_intersect.py:2642", "strelka_tpu_torch/csrc/intersect.cu"),
    "gather_rows_t": ("strelka_tpu/ops/pallas_gather.py:53", "strelka_tpu_torch/csrc/gather.cu"),
    "bvh_closest": ("strelka_tpu/ops/pallas_intersect.py:2247", "strelka_tpu_torch/csrc/bvh.cu"),
    "bvh_any": ("strelka_tpu/ops/pallas_intersect.py:2322", "strelka_tpu_torch/csrc/bvh.cu"),
    "cone_closest": ("strelka_tpu/ops/curves.py:895", "strelka_tpu_torch/csrc/cones.cu"),
    "cone_any": ("strelka_tpu/ops/curves.py:895", "strelka_tpu_torch/csrc/cones.cu"),
    "open_w": ("strelka_tpu/ops/pallas_intersect.py:1002", "strelka_tpu_torch/csrc/open_w.cu"),
}
OPEN_K = 16  # superblocks a tile has swept when the open flag is asked (the reference's CONE_RESIDUAL_K)


# (kernel, shape) pairs held against the plain version so far: a main path
# may launch no kernel at a shape that is not in here
HELD = set()


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def held(fn):
    """fn() launches kernels whose results the caller then compares with
    their plain versions (and raises where they differ): note the
    (kernel, shape) pairs it launched."""
    from strelka_tpu_torch import kernels as K

    before = dict(K.launch_shapes)
    out = fn()
    HELD.update(k for k, v in K.launch_shapes.items() if v > before.get(k, 0))
    return out


def ray_bytes(tmin, tmax, exclude, out_bytes: int) -> int:
    """Bytes an intersection kernel must move for its rays: a live lane reads
    origin, direction, tmin, tmax (8 f32) and its exclude id; a dead lane
    (tmax <= tmin) only tmin and tmax; every lane writes its outputs."""
    n = tmin.shape[0]
    live = int((tmax > tmin).sum())
    return live * (8 * 4 + (4 if exclude is not None else 0)) + (n - live) * 8 + n * out_bytes


def time_ms(fn, samples: int = 20, inner: int = 10, warmup: int = 2) -> float:
    """Device time of one fn() call (CUDA events): the median over `samples`
    of the mean of `inner` back-to-back calls. Calls queued back to back keep
    the host's per-call launch overhead off the device timeline."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def sobol_lane_ops(dims: int) -> dict:
    """Instructions one K1 lane needs (csrc/sobol.cu), by the pipe that runs
    them, each in its fewest sm_90 instructions. A scramble (of the index,
    then one per dimension) is 2 bit reversals, an add, 4 multiplies by a
    constant and 4 xors. The fold is, per bit, one instruction for the bit's
    mask and one three-input LOP3 per dimension (acc ^ (mask & column)). The
    output is, per dimension, a conversion, a multiply by 2^-32 (f32, half
    an IMAD slot) and a clamp (min)."""
    scrambles = 1 + dims
    return {
        "alu": scrambles * (1 + 4) + 32 * (1 + dims) + dims,
        "fma": scrambles * 4 + dims / 2,
        "xu": scrambles * 2 + dims,
    }


def sobol_bound_s(n: int, dims: int) -> float:
    """K1's operation bound: the busiest pipe's instructions over its rate."""
    ops = sobol_lane_ops(dims)
    return max(n * ops[p] / (PIPE_RATE[p] * SM_CLOCKS_PER_S) for p in ops)


def cornell_scene(device):
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.scene import testscenes as TS

    host = TS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True)
    return host, build_device_scene(host, device=device)


def launch_params(host, width: int, height: int, subframe: int = 0):
    import numpy as np

    from strelka_tpu_torch.ops import integrator as I

    cam = host.get_camera(0)
    cam.update_aspect_ratio(width / height)
    return I.LaunchParams(
        subframe_index=subframe,
        clip_to_view=np.asarray(cam.clip_to_view(), np.float32),
        view_to_world=np.asarray(cam.view_to_world(), np.float32),
        exposure=np.asarray(EXPOSURE, np.float32),
        bg_color=np.zeros(3, np.float32),
    )


def main_path_kw(cfg: Config) -> dict:
    """render_launch's keyword arguments on a main path."""
    return dict(width=cfg.width, height=cfg.height, samples_per_launch=cfg.spp,
                max_sample_count=MAX_SAMPLE_COUNT, max_depth=cfg.depth, enable_accumulation=True)


def main_path_rays(scene, params, device, cfg: Config):
    """Sample indices, camera rays, bounce-1 rays, the bounce-0 NEE shadow
    rays, the camera hits' prims, the sampled light ids and (a scene with
    curves) the material ids of the camera rays' curve hits, of the first
    launch of a main path (the shapes the kernels see there), taken as
    trace_paths makes them."""
    import torch

    from strelka_tpu_torch.ops import bsdf as B
    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.ops import light_sampling as LS
    from strelka_tpu_torch.ops import sampler as S
    from strelka_tpu_torch.ops import vec as V
    from strelka_tpu_torch.ops.intersect import intersect_closest, offset_ray_vec
    from strelka_tpu_torch.render.device_scene import ATTR_LIGHT_ROW, ATTR_MAT_ROW, RAY_MASK_PRIMARY

    n = cfg.width * cfg.height
    idx = torch.arange(n, dtype=torch.int64, device=device)
    px, py = (idx % cfg.width).repeat(cfg.spp), (idx // cfg.width).repeat(cfg.spp)
    s_of_ray = torch.arange(cfg.spp, dtype=torch.int64, device=device).repeat_interleave(n)
    sample_idx = S.make_sample_index(px, py, s_of_ray, MAX_SAMPLE_COUNT)
    jxy = S.random_dims(sample_idx, 0, (0, 1))
    origin, direction = I.generate_camera_rays(params, px, py, jxy[0], jxy[1], cfg.width, cfg.height)
    m = sample_idx.shape[0]
    tmin = torch.zeros(m, dtype=torch.float32, device=device)
    tmax = torch.full((m,), 1e16, dtype=torch.float32, device=device)
    hit = intersect_closest(scene, origin, direction, tmin, tmax, RAY_MASK_PRIMARY)
    # bounce 0 shading, as trace_paths does it, to get the bounce-1 rays
    dims = S.random_dims(sample_idx, 0, (0, 1, 2, 3, 4))
    inside = torch.zeros(m, dtype=torch.bool, device=device)
    position, frame, light_id, rows = I._gather_surface(scene, hit, inside)
    mat = I._material_from_rows(rows[ATTR_MAT_ROW:ATTR_LIGHT_ROW])
    is_curve = torch.zeros(m, dtype=torch.bool, device=device)
    seg_mat = None
    if scene.has_curves:
        chit = I.closest_curve_hit(scene, origin, direction, tmin, tmax, None)
        is_curve = (chit.seg >= 0) & (chit.t < hit.t)
        position, frame, mat = I.curve_surface(scene, chit, is_curve, origin, direction, inside, position, frame, mat)
        seg_mat = torch.clamp(scene.curves.material_id[torch.clamp(chit.seg, min=0).to(torch.int64)], min=0)
    smp = B.bsdf_sample(mat, frame, -direction, (dims[0], dims[1], dims[2], dims[3]),
                        torch.ones_like(mat.ior), mat.ior, enable_hair=scene.has_curves or scene.has_hair)
    transmission = (smp.event_type & B.BSDF_EVENT_TRANSMISSION) != 0
    org1 = offset_ray_vec(position, V.where(transmission, -frame.geom_normal, frame.geom_normal))
    alive1 = ((hit.prim >= 0) & (light_id < 0) | is_curve) & (smp.event_type != B.BSDF_EVENT_ABSORB)
    exclude1 = torch.where(is_curve, -1, hit.prim)  # a curve hit excludes no triangle
    camera = dict(o=origin, d=direction, tmin=tmin, tmax=tmax, exclude=torch.full_like(hit.prim, -1))
    bounce1 = dict(o=org1, d=smp.k2, tmin=tmin, tmax=torch.where(alive1, 1e16, 0.0), exclude=exclude1)
    # bounce-0 next-event rays (trace_paths' NEE block, uniform rect sampling)
    nee_able = alive1 & ((smp.event_type & (B.BSDF_EVENT_DIFFUSE | B.BSDF_EVENT_GLOSSY)) != 0)
    lid = torch.clamp((scene.num_lights * dims[int(S.SampleDimension.eLightId) % 5]).to(torch.int32), 0,
                      scene.num_lights - 1)
    lp = I._gather_light(scene, lid)
    ls = LS.sample_light(lp, dims[int(S.SampleDimension.eLightPointX) % 5],
                         dims[int(S.SampleDimension.eLightPointY) % 5], position, 0)
    geom_ok = (V.dot(frame.normal, ls.L) > 0.0) & (-V.dot(ls.L, ls.normal) > 0.0) & V.all_nonzero(lp.color)
    shadow = dict(o=offset_ray_vec(position, frame.geom_normal), d=ls.L, tmin=tmin,
                  tmax=torch.where(nee_able & geom_ok, ls.dist_to_light, 0.0), exclude=exclude1)
    return sample_idx, camera, bounce1, shadow, hit.prim, lid, seg_mat


def _contig(rays):
    return tuple(c.contiguous() for c in rays["o"]), tuple(c.contiguous() for c in rays["d"])


def flat_args(scene, rays, ray_mask):
    """K2/K3's arguments for one ray set against a scene's triangle arrays."""
    o, d = _contig(rays)
    return (o, d, rays["tmin"].contiguous(), rays["tmax"].contiguous(), rays["exclude"].contiguous(), scene.v0,
            scene.e1, scene.e2, scene.geom_mask, ray_mask)


def bvh_args(scene, rays, ray_mask):
    """K5/K6's arguments: K2/K3's with the tree before the triangles."""
    a = flat_args(scene, rays, ray_mask)
    return a[:5] + (scene.bvh,) + a[5:]


def timed_once_ms(fn):
    """Host-clock time of one call that ends in a synchronize (for the plain
    versions above 1024 triangles, which take seconds)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def closest_mismatch(t_a, p_a, t_b, p_b):
    """Lanes where two closest-hit results disagree beyond the tie rule:
    hit/miss differs, or both hit other prims with |dt| > 1e-5 t (a tie is
    two prims at the same distance: a shared edge, coplanar faces). Returns
    (bad lanes, tie lanes, max relative t difference over lanes where both hit)."""
    import torch

    both = (p_a >= 0) & (p_b >= 0)
    rel = torch.where(both, torch.abs(t_a - t_b) / torch.abs(t_b), 0.0)
    differ = p_a != p_b
    tie = both & (rel <= 1e-5)
    agree = both & (~differ | tie)
    max_rel = float(rel[agree].max()) if bool(agree.any()) else 0.0
    return int((differ & ~tie).sum()), int((differ & tie).sum()), max_rel


def check_intersect(scene, rays, ray_mask, name, time_plain: bool = False):
    """K2 and K3 against their plain versions on one ray set. Returns the
    kernels' arguments, K2's largest absolute difference in t, u or v over
    the lanes where both give the same prim (misses included), and the plain
    versions' times (one call each) if asked for."""
    import torch

    from strelka_tpu_torch.kernels import intersect as KI

    args = flat_args(scene, rays, ray_mask)
    t_k, p_k, u_k, v_k = held(lambda: KI.intersect_closest(*args))
    (t_p, p_p, u_p, v_p), closest_plain_ms = timed_once_ms(lambda: KI.closest_plain(*args))
    # tie rule: ids equal, except where two prims give t within 1e-5 t
    both = (p_k >= 0) & (p_p >= 0)
    differ = p_k != p_p
    tie_ok = both & (torch.abs(t_k - t_p) <= 1e-5 * torch.abs(t_p))
    bad_prim = int((differ & ~tie_ok).sum())
    same = ~differ
    hits = same & (p_k >= 0)
    t_err = float((torch.abs(t_k - t_p) / torch.abs(t_p))[hits].max()) if bool(hits.any()) else 0.0
    # the same prim gives the same barycentrics: one -fmad=false f32 MT on both sides
    uv_bits = int(((u_k.view(torch.int32) != u_p.view(torch.int32)) |
                   (v_k.view(torch.int32) != v_p.view(torch.int32)))[same].sum())
    if bad_prim or t_err > 1e-6 or uv_bits:
        raise AssertionError(f"K2 on {name}: {bad_prim} prims differ beyond ties, max rel t err {t_err}, "
                             f"u or v not bit-equal on {uv_bits} lanes with equal prims")
    occ_k = held(lambda: KI.intersect_any(*args))
    occ_p, any_plain_ms = timed_once_ms(lambda: KI.any_plain(*args))
    bad_occ = int((occ_k != occ_p).sum())
    if bad_occ:
        raise AssertionError(f"K3 on {name}: {bad_occ} occlusion results differ")
    max_abs = max(float(torch.abs(a - b)[same].max()) if bool(same.any()) else 0.0
                  for a, b in ((t_k, t_p), (u_k, u_p), (v_k, v_p)))
    log(f"K2/K3 on {name} rays ({rays['tmin'].shape[0]} x {scene.v0.shape[0]} triangles): prims equal but for "
        f"{int(differ.sum())} ties (|dt| <= 1e-5 t), max rel t err {t_err:.3g} (limit 1e-6), u and v bit-equal "
        f"on the {int(same.sum())} lanes with equal prims, occlusion equal ({int(occ_k.sum())} occluded)")
    if time_plain:
        return args, max_abs, (closest_plain_ms, any_plain_ms)
    return args, max_abs


def tests_needed(args, any_hit: bool) -> int:
    """Ray-triangle tests these rays need: for each live ray, the triangles
    whose geometry mask matches the ray mask and that are not the ray's own
    prim; for any-hit only those up to its first occluder (K3 exits there)."""
    import torch

    from strelka_tpu_torch.kernels import intersect as KI

    o, d, tmin, tmax, exclude, v0, e1, e2, mask, ray_mask = args
    ntri = v0.shape[0]
    ids = torch.arange(ntri, device=v0.device)
    match = (mask & ray_mask) != 0
    if not any_hit:
        live = tmax > tmin
        own = live & (exclude >= 0) & match[torch.clamp(exclude, min=0).to(torch.int64)]
        return int(live.sum()) * int(match.sum()) - int(own.sum())
    total = 0
    chunk = max(1024, min(65536, (1 << 26) // ntri))  # [chunk, ntri] temporaries of at most 256 MB
    for r0 in range(0, tmin.shape[0], chunk):
        rs = slice(r0, r0 + chunk)
        live = tmax[rs] > tmin[rs]
        candidate = match[None, :] & (ids[None, :] != exclude[rs, None])
        oc, dc = [c[rs] for c in o], [c[rs] for c in d]
        _, _, _, hit = KI.mt_block(oc, dc, v0, e1, e2, tmin[rs], tmax[rs])
        hit = KI._valid(hit, mask, ray_mask, 0, exclude[rs])
        first = torch.where(hit, ids[None, :], ntri).min(dim=1).values
        candidate = candidate & (ids[None, :] <= first[:, None])
        total += int((candidate & live[:, None]).sum())
    return total


JITTER_DIMS, BOUNCE_DIMS = (0, 1), (0, 1, 2, 3, 4)  # the two dimension lists render_launch asks K1 for


def sobol_rows(sample_idx, cfg: Config, where: str):
    """K1 against its plain version, bit for bit, at both calls a launch
    makes: the pixel jitter (2 dimensions, depth 0) and a bounce's 5
    dimensions at every depth; both timed."""
    import torch

    from strelka_tpu_torch.kernels import sobol as KS

    n = sample_idx.shape[0]
    for dims, depths in ((JITTER_DIMS, (0,)), (BOUNCE_DIMS, range(cfg.depth))):
        for depth in depths:
            a = held(lambda: KS.random_dims(sample_idx, depth, dims))
            b = KS.random_dims_plain(sample_idx, depth, dims)
            torch.cuda.synchronize()
            if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
                raise AssertionError(f"K1 differs from its plain version at depth {depth}, dims {dims} ({where})")
    log(f"K1 bit-equal (tolerance: none) on {n} sample indices of {where}: {len(BOUNCE_DIMS)} dimensions at depths "
        f"0..{cfg.depth - 1}, {len(JITTER_DIMS)} at depth 0")
    return [dict(
        kernel="sobol", at=f"{where}, {len(dims)} dimensions", shape=(n, len(dims)),
        ms=time_ms(lambda: KS.random_dims(sample_idx, depth, dims)),
        plain_ms=time_ms(lambda: KS.random_dims_plain(sample_idx, depth, dims), samples=5, inner=2),
        bound_bytes=n * 8 + len(dims) * n * 4, bound_ops_s=sobol_bound_s(n, len(dims)),
        max_abs_err=0.0, library_ms=None,
    ) for dims, depth in ((BOUNCE_DIMS, 1), (JITTER_DIMS, 0))]


def phase_kernels(scene, params):
    import torch

    from strelka_tpu_torch.kernels import intersect as KI
    from strelka_tpu_torch.ops import sampler as S
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW

    dev = scene.device
    sample_idx, camera, bounce1, _, prims, _, _ = main_path_rays(scene, params, dev, CORNELL)
    n = sample_idx.shape[0]
    where = "cornell 2^20 lanes x 640 triangles"

    # ---- K1: both calls of a launch, every depth of the main path, bit-equal
    rows = sobol_rows(sample_idx, CORNELL, "cornell")

    # ---- K2 / K3: camera rays and bounce-1 rays (2^20 each)
    cam_args, err_cam = check_intersect(scene, camera, RAY_MASK_PRIMARY, "camera")
    b1_args, err_b1 = check_intersect(scene, bounce1, RAY_MASK_PRIMARY, "bounce-1")
    # shadow-style any-hit set: bounce-1 rays cut to a hashed fraction in
    # [0, 1.5) of their hit distance, so that some are occluded and some not
    t_b1 = KI.intersect_closest(*b1_args)[0]
    frac = S.uniform_hash(sample_idx, 7) * 1.5
    o, d, tmin, tmax, ex, v0, e1, e2, mask, _ = b1_args
    shadow_tmax = torch.where(tmax > 0, torch.clamp(t_b1, max=1e3) * frac, 0.0).contiguous()
    sh_args = (o, d, tmin, shadow_tmax, ex, v0, e1, e2, mask, RAY_MASK_SHADOW)
    if not torch.equal(held(lambda: KI.intersect_any(*sh_args)), KI.any_plain(*sh_args)):
        raise AssertionError("K3 differs from its plain version on shadow-style rays")
    ntri = scene.v0.shape[0]
    tests_k2, tests_k3 = tests_needed(b1_args, any_hit=False), tests_needed(sh_args, any_hit=True)
    log(f"ray-triangle tests needed: K2 {tests_k2} on the bounce-1 rays, K3 {tests_k3} on the shadow-style "
        f"rays; of {ntri} triangles {int(((scene.geom_mask & RAY_MASK_PRIMARY) != 0).sum())} match the "
        f"primary ray mask, {int(((scene.geom_mask & RAY_MASK_SHADOW) != 0).sum())} the shadow mask")
    rows.append(dict(
        kernel="intersect_closest", at=where + ", bounce-1 rays", shape=(n, ntri),
        ms=time_ms(lambda: KI.intersect_closest(*b1_args)),
        plain_ms=time_ms(lambda: KI.closest_plain(*b1_args), samples=3, inner=1, warmup=1),
        bound_bytes=ray_bytes(*b1_args[2:5], 16) + ntri * 40,
        bound_ops_s=tests_k2 * KI.MT_FLOPS / F32_OPS_PER_S,
        max_abs_err=max(err_cam, err_b1), library_ms=None,
    ))
    rows.append(dict(
        kernel="intersect_any", at=where + ", shadow-style rays", shape=(n, ntri),
        ms=time_ms(lambda: KI.intersect_any(*sh_args)),
        plain_ms=time_ms(lambda: KI.any_plain(*sh_args), samples=3, inner=1, warmup=1),
        bound_bytes=ray_bytes(*sh_args[2:5], 1) + ntri * 40,
        bound_ops_s=tests_k3 * KI.MT_FLOPS / F32_OPS_PER_S,
        max_abs_err=0.0, library_ms=None,
    ))

    # ---- K4: the attr table at the camera hits (2^20 indices), bit-equal
    rows.append(gather_row(scene.attr_table, prims, "cornell attr_table at the camera hits"))
    return rows


def gather_row(table, prims, where: str):
    """K4 against its plain version at one table and index set, timed. Its
    bound counts the table rows these indices name, not the whole table."""
    import torch

    from strelka_tpu_torch.kernels import gather as KG

    n = prims.shape[0]
    gidx = torch.clamp(prims, min=0).contiguous()
    a = held(lambda: KG.gather_rows_t(table, gidx))
    b = KG.gather_rows_t_plain(table, gidx)
    torch.cuda.synchronize()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError("K4 differs from its plain version")
    rows_named = int(torch.unique(gidx).numel())
    log(f"K4 bit-equal (tolerance: none) on {where}: table {tuple(table.shape)} x {n} indices naming "
        f"{rows_named} rows")
    gidx64 = gidx.to(torch.int64)
    return dict(
        kernel="gather_rows_t", at=where, shape=(table.shape[0], table.shape[1], n),
        ms=time_ms(lambda: KG.gather_rows_t(table, gidx)),
        plain_ms=time_ms(lambda: KG.gather_rows_t_plain(table, gidx)),
        bound_bytes=n * 4 + rows_named * table.shape[1] * 4 + n * table.shape[1] * 4,
        bound_ops_s=0.0,
        max_abs_err=0.0,
        library_ms=time_ms(lambda: torch.index_select(table, 0, gidx64).t().contiguous()),
    )


def finish_bounds(rows):
    for r in rows:
        if (r["kernel"], tuple(r["shape"])) not in HELD:
            raise AssertionError(f"{r['kernel']} was timed at {r['shape']} but not held against its plain version")
        bytes_s = r["bound_bytes"] / HBM_BYTES_PER_S
        r["bound_ms"] = max(bytes_s, r["bound_ops_s"]) * 1e3
        r["bound_by"] = "bytes" if bytes_s >= r["bound_ops_s"] else "operations"


def golden_render(host, device, use_bvh=None, config=GOLDEN):
    """A golden config (w, h, spp, launches) through TorchRender -> [H, W, 3] in [0, 1]."""
    import numpy as np

    from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu_torch.render.render import RenderFactory, RenderType
    from strelka_tpu_torch.settings import SharedContext, make_default_settings

    w, h, spp, launches = config
    s = make_default_settings(w, h)
    s.set("render/pt/sppTotal", spp * launches)
    s.set("render/pt/spp", spp)
    r = RenderFactory.create_render(RenderType.eTorch, device=device)
    r.use_bvh = use_bvh
    r.set_scene(host)
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(w, h, BufferFormat.FLOAT4))
    for _ in range(launches):
        r.render(buf)
    img = buf.map()[..., :3]
    if not np.isfinite(img).all():
        raise AssertionError("golden-config render has non-finite pixels")
    return np.clip(img, 0.0, 1.0)


def phase_golden(host, device, golden_png: str, kernels: tuple, config=GOLDEN) -> float:
    """Golden-config render on the card: SSIM >= 0.99 against the golden,
    every kernel of the path launched, no plain version run on CUDA."""
    from strelka_tpu_torch import kernels as K
    from strelka_tpu_torch.utils.image import read_png, ssim

    K.reset_counts()
    img = golden_render(host, device, config=config)
    counts = dict(K.launch_counts)
    golden = read_png(os.path.join(REPO, "goldens", golden_png))[..., :3]
    s = float(ssim(img, golden))
    log(f"golden config {config}: SSIM vs goldens/{golden_png} = {s:.6f}; launches {counts}")
    if s < 0.99:
        raise AssertionError(f"SSIM {s} < 0.99 against goldens/{golden_png}")
    if not all(counts[k] for k in kernels) or any(K.plain_cuda_calls.values()):
        raise AssertionError(f"the golden-config render did not run {kernels} on the card: {counts}, "
                             f"plain versions on CUDA {dict(K.plain_cuda_calls)}")
    return s


def phase_main_path(scene, host, cfg: Config):
    import numpy as np
    import torch

    from strelka_tpu_torch import kernels as K
    from strelka_tpu_torch.ops import integrator as I

    dev = scene.device
    kw = main_path_kw(cfg)
    w, h = cfg.width, cfg.height
    state = I.make_frame_state(h, w, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    state, image = I.render_launch(scene, launch_params(host, w, h, 0), state, **kw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(cfg.timed_launches):
        state, image = I.render_launch(scene, launch_params(host, w, h, (i + 1) * cfg.spp), state, **kw)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / cfg.timed_launches
    counts = dict(K.launch_counts)
    shapes = dict(K.launch_shapes)
    plain = dict(K.plain_cuda_calls)
    launches = 1 + cfg.timed_launches
    unheld = sorted(k for k in shapes if k not in HELD)
    if unheld:
        raise AssertionError(f"the {cfg.name} main path launched kernels at shapes that were not held against "
                             f"their plain versions: {unheld}")
    for name in cfg.kernels:
        if counts[name] == 0:
            raise AssertionError(f"kernel {name} was not launched on the {cfg.name} main path")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on CUDA on the {cfg.name} main path: {plain}")
    img = image.cpu().numpy()
    if img.shape != (3, h, w) or not np.isfinite(img).all():
        raise AssertionError(f"{cfg.name} main-path image is {img.shape} with non-finite values")
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    # alive-ray accounting: one instrumented launch, same config
    _, _, stats = I.render_launch(scene, launch_params(host, w, h, launches * cfg.spp), state,
                                  collect_stats=True, **kw)
    alive = float(stats["closest_rays"]) + float(stats["shadow_rays"])
    padded = w * h * cfg.spp * 2 * cfg.depth
    result = dict(
        scene=cfg.name,
        config=f"{w}x{h} spp={cfg.spp} depth={cfg.depth}",
        triangles=scene.num_triangles,
        cones=scene.num_cones,
        ms_per_launch=dt * 1e3,
        padded_mrays_per_s=padded / dt / 1e6,
        alive_mrays_per_s=alive / dt / 1e6,
        alive_ray_frac=alive / padded,
        image_mean=float(img.mean()),
        render_launches=launches,
        launch_counts=counts,
        launch_shapes=[dict(kernel=k, shape=list(s), launches=v) for (k, s), v in sorted(shapes.items())],
        launches_per_render_launch={k: v / launches for k, v in counts.items()},
        plain_cuda_calls=plain,
        peak_device_memory_mb=peak_mb,
    )
    log(f"{cfg.name} {result['config']}: {result['ms_per_launch']:.3f} ms/launch, "
        f"{result['padded_mrays_per_s']:.1f} padded Mrays/s, {result['alive_mrays_per_s']:.1f} alive Mrays/s "
        f"(alive fraction {result['alive_ray_frac']:.3f}), peak device memory {peak_mb:.0f} MB")
    log(f"launch counts over {launches} render launches: {counts} (plain versions on CUDA: {plain}); by shape, "
        f"each held against its plain version before: " +
        ", ".join(f"{k}{list(s)} x {v}" for (k, s), v in sorted(shapes.items())))
    return result


# ---------------------------------------------------------------------------
# BVH scenes: kernels K5 and K6
# ---------------------------------------------------------------------------


def check_bvh_vs_plain(scene, rays, ray_mask, name, any_hit: bool):
    """K5 (or K6) against the plain traversal on one ray set: the same walk
    and arithmetic, so prim, t, u and v must be EQUAL (t, u, v bit for bit).
    Returns (args, the plain walk's TraversalCounts, plain ms)."""
    import torch

    from strelka_tpu_torch.kernels import bvh as KB
    from strelka_tpu_torch.ops.bvh import intersect_bvh_plain

    args = bvh_args(scene, rays, ray_mask)
    label = "bvh_any" if any_hit else "bvh_closest"
    out_p, plain_ms = timed_once_ms(
        lambda: intersect_bvh_plain(*args, any_hit=any_hit, counts=True, name=label))
    t_p, p_p, u_p, v_p, walk = out_p
    if any_hit:
        occ = held(lambda: KB.bvh_any(*args))
        torch.cuda.synchronize()
        bad = int((occ != (p_p >= 0)).sum())
        if bad:
            raise AssertionError(f"K6 on {name}: {bad} occlusion results differ from the plain traversal")
        log(f"K6 on {name} rays ({occ.shape[0]}): occlusion equal to the plain traversal ({int(occ.sum())} "
            f"occluded; tolerance: none); plain walk {walk.steps} steps, {plain_ms:.0f} ms")
    else:
        t_k, p_k, u_k, v_k = held(lambda: KB.bvh_closest(*args))
        torch.cuda.synchronize()
        bad = int((p_k != p_p).sum())
        bits = int(sum((a.view(torch.int32) != b.view(torch.int32)).sum()
                       for a, b in ((t_k, t_p), (u_k, u_p), (v_k, v_p))))
        if bad or bits:
            raise AssertionError(f"K5 on {name}: {bad} prims and {bits} values of t, u, v differ from the "
                                 "plain traversal")
        log(f"K5 on {name} rays ({p_k.shape[0]}): prim, t, u, v equal to the plain traversal bit for bit "
            f"({int((p_k >= 0).sum())} hits; tolerance: none); plain walk {walk.steps} steps, {plain_ms:.0f} ms")
    return args, walk, plain_ms


def check_bvh_vs_bruteforce(scene, rays, ray_mask, name):
    """K5/K6 against K2/K3 sweeping every triangle of the same (leaf-ordered)
    arrays: an independent oracle. Bar: hit/miss equal and, where both hit
    other prims, |dt| <= 1e-5 t (the tie rule); t within 1e-5 relative.
    A BVH may lose a grazing hit that brute force keeps (a slab test can cull
    an edge-on triangle), so up to 1e-4 of the lanes may differ, the
    reference's own bar being 1% of prims (tests/test_bvh.py); the count is
    printed. Returns the fraction of lanes that differ."""
    import torch

    from strelka_tpu_torch.kernels import bvh as KB
    from strelka_tpu_torch.kernels import intersect as KI

    fa, ba = flat_args(scene, rays, ray_mask), bvh_args(scene, rays, ray_mask)
    t_k, p_k, _, _ = KB.bvh_closest(*ba)
    t_f, p_f, _, _ = KI.intersect_closest(*fa)
    occ_k, occ_f = KB.bvh_any(*ba), KI.intersect_any(*fa)
    torch.cuda.synchronize()
    n = p_k.shape[0]
    hit_miss = int(((p_k >= 0) != (p_f >= 0)).sum())
    bad, ties, rel = closest_mismatch(t_k, p_k, t_f, p_f)
    bad_occ = int((occ_k != occ_f).sum())
    log(f"K5/K6 vs brute force (K2/K3 over {scene.v0.shape[0]} triangles) on {name} rays ({n}): closest differs "
        f"on {bad} lanes beyond ties ({hit_miss} of them hit against miss), {ties} ties, max rel t diff {rel:.3g} "
        f"(limit 1e-5); occlusion differs on {bad_occ} lanes (bar: at most {1e-4 * n:.0f} lanes each)")
    if bad > 1e-4 * n or bad_occ > 1e-4 * n or rel > 1e-5:
        raise AssertionError(f"K5/K6 disagree with brute force on {name} rays")
    return max(bad, bad_occ) / n


def bvh_rows(scene, sets, where: str):
    """K5/K6 rows: times on the bounce-1 (K5) and shadow (K6) rays, and the
    bound from what these rays need: the nodes whose box overlaps
    [tmin, final t] and the triangles of such leaves that pass mask and
    exclude (K6: up to the first occluder in the kernel's order). The
    operations count every such visit; the bytes count each such node row
    (32 bytes) and triangle (40) once, whatever the number of rays that
    need it, and the rays as `ray_bytes` does."""
    from strelka_tpu_torch.kernels import bvh as KB
    from strelka_tpu_torch.kernels.intersect import MT_FLOPS
    from strelka_tpu_torch.ops.bvh import SLAB_FLOPS, intersect_bvh_plain

    (b1_args, b1_walk, b1_plain_ms), (sh_args, sh_walk, sh_plain_ms) = sets
    n = b1_args[2].shape[0]
    live_b1 = int((b1_args[3] > b1_args[2]).sum())
    live_sh = int((sh_args[3] > sh_args[2]).sum())
    t_final = KB.bvh_closest(*b1_args)[0]
    ideal = intersect_bvh_plain(*b1_args, prime_t=t_final, counts=True)[4]
    log(f"K5 on the bounce-1 rays ({live_b1} live of {n}): the kernel's order visits "
        f"{b1_walk.nodes_visited / live_b1:.1f} nodes and tests {b1_walk.tri_tests / live_b1:.2f} triangles a "
        f"live ray; given the final t a ray needs {ideal.nodes_overlapped / live_b1:.1f} nodes "
        f"(boxes overlapping [tmin, t]) and {ideal.tri_tests / live_b1:.2f} triangles")
    log(f"K6 on the shadow rays ({live_sh} live of {n}): the kernel's order visits "
        f"{sh_walk.nodes_visited / max(live_sh, 1):.1f} nodes and tests "
        f"{sh_walk.tri_tests / max(live_sh, 1):.2f} triangles a live ray, "
        f"{sh_walk.nodes_overlapped / max(live_sh, 1):.1f} of the nodes overlapped")
    log(f"tree these rays need: K5 {ideal.nodes_touched} of {scene.bvh.num_nodes} nodes and {ideal.tris_touched} "
        f"of {scene.v0.shape[0]} triangles; K6 {sh_walk.nodes_touched} nodes and {sh_walk.tris_touched} triangles")
    shape = (n, scene.bvh.num_nodes, scene.v0.shape[0])
    rows = [
        dict(
            kernel="bvh_closest", at=where + ", bounce-1 rays", shape=shape,
            ms=time_ms(lambda: KB.bvh_closest(*b1_args), samples=10, inner=3),
            plain_ms=b1_plain_ms,
            bound_bytes=ray_bytes(*b1_args[2:5], 16) + ideal.nodes_touched * 32 + ideal.tris_touched * 40,
            bound_ops_s=(ideal.nodes_overlapped * SLAB_FLOPS + ideal.tri_tests * MT_FLOPS) / F32_OPS_PER_S,
            max_abs_err=0.0, library_ms=None,
            nodes_per_ray=b1_walk.nodes_visited / live_b1, ideal_nodes_per_ray=ideal.nodes_overlapped / live_b1,
            tris_per_ray=b1_walk.tri_tests / live_b1, ideal_tris_per_ray=ideal.tri_tests / live_b1,
            live_rays=live_b1, nodes_needed=ideal.nodes_touched, tris_needed=ideal.tris_touched,
        ),
        dict(
            kernel="bvh_any", at=where + ", shadow rays", shape=shape,
            ms=time_ms(lambda: KB.bvh_any(*sh_args), samples=10, inner=3),
            plain_ms=sh_plain_ms,
            bound_bytes=ray_bytes(*sh_args[2:5], 1) + sh_walk.nodes_touched * 32 + sh_walk.tris_touched * 40,
            bound_ops_s=(sh_walk.nodes_overlapped * SLAB_FLOPS + sh_walk.tri_tests * MT_FLOPS) / F32_OPS_PER_S,
            max_abs_err=0.0, library_ms=None,
            nodes_per_ray=sh_walk.nodes_visited / max(live_sh, 1),
            ideal_nodes_per_ray=sh_walk.nodes_overlapped / max(live_sh, 1),
            tris_per_ray=sh_walk.tri_tests / max(live_sh, 1),
            ideal_tris_per_ray=sh_walk.tri_tests / max(live_sh, 1),
            live_rays=live_sh, nodes_needed=sh_walk.nodes_touched, tris_needed=sh_walk.tris_touched,
        ),
    ]
    return rows


def phase_flat_scene(dev):
    """box_field(grid=12), 25,732 triangles (the size range of the TPU's
    _flat and _mxu_flat kernels), built flat and with the BVH: K2/K3 against
    their plain versions at that size, K5/K6 against the plain traversal and
    against K2/K3, and the two golden-config renders compared."""
    import numpy as np
    import torch

    from strelka_tpu_torch import kernels as K
    from strelka_tpu_torch.kernels import intersect as KI
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW, build_device_scene
    from strelka_tpu_torch.scene import testscenes as TS
    from strelka_tpu_torch.utils.image import ssim

    host = TS.box_field(grid=FLAT_GRID)
    flat = build_device_scene(host, device=dev, use_bvh=False)
    tree = build_device_scene(TS.box_field(grid=FLAT_GRID), device=dev)
    if flat.bvh is not None or tree.bvh is None:
        raise AssertionError("use_bvh=False must keep the scene flat and the default must build a BVH")
    ntri = flat.v0.shape[0]
    log(f"box_field(grid={FLAT_GRID}): {flat.num_triangles} triangles ({ntri} padded), BVH of "
        f"{tree.bvh.num_nodes} nodes ({tree.bvh.builder} builder, {tree.bvh.build_seconds:.2f} s)")
    params = launch_params(host, BOX.width, BOX.height, 0)

    # ---- K2/K3 at 25,732 triangles, on the flat scene's own rays (2^19 lanes)
    _, camera, bounce1, shadow, _, _, _ = main_path_rays(flat, params, dev, BOX)
    n = camera["tmin"].shape[0]
    where = f"box_field(grid={FLAT_GRID}) 2^19 lanes x {ntri} triangles"
    _, err_cam = check_intersect(flat, camera, RAY_MASK_PRIMARY, "flat camera")
    b1_args, err_b1, (closest_plain_ms, _) = check_intersect(flat, bounce1, RAY_MASK_PRIMARY, "flat bounce-1",
                                                             time_plain=True)
    sh_args = flat_args(flat, shadow, RAY_MASK_SHADOW)
    occ_p, any_plain_ms = timed_once_ms(lambda: KI.any_plain(*sh_args))
    if not torch.equal(held(lambda: KI.intersect_any(*sh_args)), occ_p):
        raise AssertionError("K3 differs from its plain version on the flat scene's shadow rays")
    tests_k2, tests_k3 = tests_needed(b1_args, any_hit=False), tests_needed(sh_args, any_hit=True)
    log(f"ray-triangle tests needed at {ntri} triangles: K2 {tests_k2} on the bounce-1 rays, K3 {tests_k3} on "
        f"the shadow rays ({int(occ_p.sum())} occluded)")
    rows = [
        dict(
            kernel="intersect_closest", at=where + ", bounce-1 rays", shape=(n, ntri),
            ms=time_ms(lambda: KI.intersect_closest(*b1_args), samples=5, inner=2, warmup=1),
            plain_ms=closest_plain_ms,
            bound_bytes=ray_bytes(*b1_args[2:5], 16) + ntri * 40,
            bound_ops_s=tests_k2 * KI.MT_FLOPS / F32_OPS_PER_S,
            max_abs_err=max(err_cam, err_b1), library_ms=None,
        ),
        dict(
            kernel="intersect_any", at=where + ", shadow rays", shape=(n, ntri),
            ms=time_ms(lambda: KI.intersect_any(*sh_args), samples=5, inner=2, warmup=1),
            plain_ms=any_plain_ms,
            bound_bytes=ray_bytes(*sh_args[2:5], 1) + ntri * 40,
            bound_ops_s=tests_k3 * KI.MT_FLOPS / F32_OPS_PER_S,
            max_abs_err=0.0, library_ms=None,
        ),
    ]
    finish_bounds(rows)

    # ---- K5/K6 on the BVH build of the same scene, against the plain
    # traversal and against K2/K3 over its leaf-ordered triangles
    _, camera, bounce1, shadow, _, _, _ = main_path_rays(tree, params, dev, BOX)
    differ = 0.0
    for rays, mask, name, any_hit in ((camera, RAY_MASK_PRIMARY, "grid-12 camera", False),
                                      (bounce1, RAY_MASK_PRIMARY, "grid-12 bounce-1", False),
                                      (shadow, RAY_MASK_SHADOW, "grid-12 shadow", True)):
        check_bvh_vs_plain(tree, rays, mask, name, any_hit)
        differ = max(differ, check_bvh_vs_bruteforce(tree, rays, mask, name))

    # ---- the two golden-config renders
    K.reset_counts()
    img_flat = golden_render(TS.box_field(grid=FLAT_GRID), dev, use_bvh=False)
    flat_counts = dict(K.launch_counts)
    K.reset_counts()
    img_tree = golden_render(TS.box_field(grid=FLAT_GRID), dev)
    tree_counts = dict(K.launch_counts)
    if not (flat_counts["intersect_closest"] and flat_counts["intersect_any"] and tree_counts["bvh_closest"]
            and tree_counts["bvh_any"]) or flat_counts["bvh_closest"] or tree_counts["intersect_closest"]:
        raise AssertionError(f"flat render must run K2/K3 and the BVH render K5/K6: {flat_counts}, {tree_counts}")
    diff = np.abs(img_flat - img_tree)
    s = float(ssim(img_flat, img_tree))
    differing = int((diff.max(axis=-1) > 1e-4).sum())
    log(f"box_field(grid={FLAT_GRID}) golden config, flat (K2/K3) against BVH (K5/K6) render: max abs difference "
        f"{float(diff.max()):.3g}, {differing} of {diff.shape[0] * diff.shape[1]} pixels differ by more than 1e-4, "
        f"SSIM {s:.6f} (bar 0.99)")
    if s < 0.99:
        raise AssertionError("the flat and the BVH render of box_field(grid=12) disagree")
    result = dict(triangles=flat.num_triangles, padded_triangles=ntri, rays=n, kernels=rows,
                  launches_golden_render={k: flat_counts[k] for k in ("intersect_closest", "intersect_any")},
                  bvh_vs_bruteforce_lanes_differing_frac=differ,
                  render_max_abs_diff=float(diff.max()), render_pixels_differing=differing, render_ssim=s)
    return result


def phase_box_kernels(scene, params):
    """Every kernel of the box_field main path at every shape that path
    gives it: K1 on its 2^19 sample indices, K5/K6 on 2^19 lanes a bounce
    against 411,652 triangles, K4 on its two tables (the attr table at the
    hits, the light table at the sampled light ids)."""
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW

    dev = scene.device
    where = f"box_field(grid={BOX_GRID}) 2^19 lanes x {scene.v0.shape[0]} triangles"
    sample_idx, camera, bounce1, shadow, prims, lid, _ = main_path_rays(scene, params, dev, BOX)
    rows = sobol_rows(sample_idx, BOX, "box_field")
    check_bvh_vs_plain(scene, camera, RAY_MASK_PRIMARY, "box_field camera", False)
    b1 = check_bvh_vs_plain(scene, bounce1, RAY_MASK_PRIMARY, "box_field bounce-1", False)
    sh = check_bvh_vs_plain(scene, shadow, RAY_MASK_SHADOW, "box_field shadow", True)
    differ = 0.0
    for rays, mask, name in ((camera, RAY_MASK_PRIMARY, "box_field camera"),
                             (bounce1, RAY_MASK_PRIMARY, "box_field bounce-1"),
                             (shadow, RAY_MASK_SHADOW, "box_field shadow")):
        differ = max(differ, check_bvh_vs_bruteforce(scene, rays, mask, name))
    rows += bvh_rows(scene, (b1, sh), where)
    rows.append(gather_row(scene.attr_table, prims, "box_field attr_table at the camera hits"))
    rows.append(gather_row(scene.light_table, lid, "box_field light_table at the sampled light ids"))
    finish_bounds(rows)
    return rows, differ


# ---------------------------------------------------------------------------
# Curve scenes: kernels K7 and K8
# ---------------------------------------------------------------------------


def cone_args(scene, rays):
    """K7/K8's arguments for one ray set against a scene's packed cones."""
    o, d = _contig(rays)
    return o, d, rays["tmin"].contiguous(), rays["tmax"].contiguous(), scene.packed_cones


def check_open_w(pc, o, d, tmin, tmax, t_closest, name):
    """K9 against its plain version on one ray set, at the tile the cone
    sweeps use: W equal and min_tn bit for bit without the open flag (the
    main path's call), and the open flag too with each tile's OPEN_K nearest
    superblocks taken as swept and the closest sweep's t as the bound (the
    reference's use after phase 1). Returns (plain ms, mean superblocks a
    tile passes)."""
    import torch

    from strelka_tpu_torch.kernels import open_w as KO
    from strelka_tpu_torch.ops import curves as C

    tile = C.CONE_ORDER_TILE
    bits = lambda a, b: a.view(torch.int32) != b.view(torch.int32)  # noqa: E731
    open_k, w_k, tn_k = held(lambda: KO.open_w(o, d, tmin, tmax, pc.sbounds, tile=tile))
    (open_p, w_p, tn_p), plain_ms = timed_once_ms(lambda: KO.open_w_plain(o, d, tmin, tmax, pc.sbounds, tile=tile))
    off = int((w_k != w_p).sum()) + int(bits(tn_k, tn_p).sum()) + int(open_k.sum()) + int(open_p.sum())
    _, r2t, d2 = C.tile_sweep_order_k(o, pc.sbounds, tile, OPEN_K)
    bound = torch.minimum(t_closest, tmax)
    open_k2, w_k2, tn_k2 = held(lambda: KO.open_w(o, d, tmin, bound, pc.sbounds, d2, r2t, tile=tile))
    open_p2, w_p2, tn_p2 = KO.open_w_plain(o, d, tmin, bound, pc.sbounds, d2, r2t, tile=tile)
    off2 = int((open_k2 != open_p2).sum()) + int((w_k2 != w_p2).sum()) + int(bits(tn_k2, tn_p2).sum())
    passed = float(w_k.sum()) / w_k.shape[0]
    log(f"K9 on {name} rays ({tmin.shape[0]} in {w_k.shape[0]} tiles of {tile} x {w_k.shape[1]} superblocks): a tile "
        f"passes {passed:.1f} superblocks; W, min_tn differ from the plain version on {off} entries; with the "
        f"{OPEN_K} nearest swept and the closest t as bound {int(open_k2.sum())} rays are open, open, W, min_tn "
        f"differ on {off2} entries (bar: 0 and 0, min_tn bit for bit); plain {plain_ms:.1f} ms")
    if off or off2:
        raise AssertionError(f"K9 on {name} rays disagrees with its plain version")
    return plain_ms, passed


def check_cones(scene, rays, name, subset=None):
    """K7 and K8 on one ray set, swept as the main path sweeps them (in the
    order kernel K9 gives, where the scene's dispatch asks for one), against
    their own cull=False mode and their ascending culled sweep on every lane
    and against the plain dense sweep (on every lane, or on the lanes
    `subset` where the dense sweep over the scene's cones would take
    minutes): t bit for bit, cone index and y equal, occlusion equal. One
    plain sweep serves both: the plain K8 is its hit set. Returns a dict:
    args, order, K7's t, K7's and K8's [2, N] stats, plain ms and lanes, the
    largest |difference| in t or y against the plain version, and K9's."""
    import torch

    from strelka_tpu_torch.kernels import cones as KC
    from strelka_tpu_torch.ops.intersect import cone_sweep_order

    args = cone_args(scene, rays)
    o, d, tmin, tmax, pc = args
    n = tmin.shape[0]
    if subset is None:
        sub_args, lanes = args, n
    else:
        sub_args = (tuple(c[subset].contiguous() for c in o), tuple(c[subset].contiguous() for c in d),
                    tmin[subset].contiguous(), tmax[subset].contiguous(), pc)
        lanes = int(subset.shape[0])
    pick = (lambda a: a) if subset is None else (lambda a: a[subset])
    block = 256 if subset is None else 4096  # the result does not depend on it
    order = cone_sweep_order(pc, o, d, tmin, tmax)
    t, c, y, stats7 = held(lambda: KC.cone_closest(*args, stats=True, order=order))
    occ, stats8 = held(lambda: KC.cone_any(*args, stats=True, order=order))
    t_b, c_b, y_b = KC.cone_closest(*args, cull=False)
    occ_b = KC.cone_any(*args, cull=False)
    (t_p, c_p, y_p), plain_ms = timed_once_ms(lambda: KC.closest_plain(*sub_args, block=block))
    bits = lambda a, b: a.view(torch.int32) != b.view(torch.int32)  # noqa: E731
    off_cull = int((bits(t, t_b) | (c != c_b) | (y != y_b)).sum())
    off_plain = int((bits(pick(t), t_p) | (pick(c) != c_p) | (pick(y) != y_p)).sum())
    occ_off_cull, occ_off_plain = int((occ != occ_b).sum()), int((pick(occ) != (c_p >= 0)).sum())
    off_asc = 0
    if order is not None:
        t_a, c_a, y_a = KC.cone_closest(*args)
        off_asc = int((bits(t, t_a) | (c != c_a) | (y != y_a)).sum()) + int((occ != KC.cone_any(*args)).sum())
    _, ties, _ = closest_mismatch(pick(t), pick(c), t_p, c_p)
    same = pick(c) == c_p
    err = max(float(torch.abs(pick(a) - b)[same].max()) if bool(same.any()) else 0.0 for a, b in ((t, t_p), (y, y_p)))
    how = "ascending" if order is None else f"K9's order per {order.tile} rays"
    log(f"K7 on {name} rays ({n}, {how}): {int((c >= 0).sum())} hits; t, cone, y differ from cull=False on {off_cull} "
        f"lanes and from the plain sweep on {off_plain} of {lanes} lanes ({ties} of them ties, max abs difference in "
        f"t or y on equal cones {err:.3g}; bar: 0 and 0 lanes, t bit for bit); plain sweep {plain_ms:.0f} ms")
    log(f"K8 on {name} rays ({n}, {how}): {int(occ.sum())} occluded; differs from cull=False on {occ_off_cull} lanes "
        f"and from the plain sweep's hit set on {occ_off_plain} of {lanes} lanes (bar: 0 and 0)" +
        ("" if order is None else f"; K7 and K8 differ from their ascending sweeps on {off_asc} lanes (bar: 0)"))
    if off_cull or off_plain or occ_off_cull or occ_off_plain or off_asc:
        raise AssertionError(f"K7 or K8 on {name} rays disagrees with its cull=False mode, its ascending sweep or "
                             f"its plain version")
    open_w = None if order is None else check_open_w(pc, o, d, tmin, tmax, t, name)
    return dict(args=args, order=order, t=t, stats7=stats7, stats8=stats8, plain_ms=plain_ms, lanes=lanes, err=err,
                open_w=open_w)


def cone_rows(scene, b1, sh, where: str):
    """K7/K8 rows: times on the bounce-1 (K7) and shadow (K8) rays and the
    bound from what these rays need, counted in plain PyTorch and not by the
    kernels. K7: the cones with ra >= 0 of the sub-blocks whose box the ray's
    final interval [tmin, t] enters (ops/curves.py:sub_blocks_entered with
    the final t). K8: the cones with ra >= 0 a ray tests up to its first
    occluder, going through the sub-blocks it enters and their cones in
    ascending order (ops/curves.py:any_hit_need). Operations: CONE_FLOPS a
    test. Bytes: the rays as `ray_bytes` does, each such sub-block's cones
    (32 bytes each: a, b, ra, rb) and box (32 bytes) once, and the sweep
    order's rows where there is one. The kernels' own counters give the
    swept and tested columns only. Where K9 orders the sweep, its row
    follows (bounce-1 rays), and `ascending_ms` is the same kernel without
    the order."""
    import torch

    from strelka_tpu_torch.kernels import cones as KC
    from strelka_tpu_torch.kernels import open_w as KO
    from strelka_tpu_torch.ops import curves as C

    pc = scene.packed_cones
    n = b1["args"][2].shape[0]
    tblk = pc.geom.shape[0] // pc.bounds.shape[1]
    rows = []
    for kernel, chk, stats, fn, out_bytes, which in (
            ("cone_closest", b1, b1["stats7"], KC.cone_closest, 12, "bounce-1"),
            ("cone_any", sh, sh["stats8"], KC.cone_any, 1, "shadow")):
        args, order = chk["args"], chk["order"]
        o, d, tmin, tmax, _ = args
        live = max(int((tmax > tmin).sum()), 1)
        swept, tested = int(stats[0].sum()), int(stats[1].sum())
        if kernel == "cone_closest":
            need = C.sub_blocks_entered(pc.geom, pc.bounds, o, d, tmin, torch.minimum(chk["t"], tmax))
        else:
            need = C.any_hit_need(pc.geom, pc.bounds, o, d, tmin, tmax)
        blocks_needed, cones_needed, boxes = int(need[0].sum()), int(need[1].sum()), int(need[2].sum())
        log(f"{kernel} on the {which} rays ({live} live of {n}): sweeps {swept / live:.2f} sub-blocks and tests "
            f"{tested / live:.1f} cones a live ray (the kernel's counters); needs {blocks_needed / live:.2f} "
            f"sub-blocks and {cones_needed / live:.1f} cones (counted in plain PyTorch); {boxes} of "
            f"{pc.bounds.shape[1]} sub-blocks touched")
        order_bytes = 0 if order is None else int(order.count.sum()) * 4 + order.count.shape[0] * 4
        row = dict(
            kernel=kernel, at=f"{where}, {which} rays", shape=KC.launch_shape(n, pc, order),
            ms=time_ms(lambda: fn(*args, order=order), samples=5, inner=2, warmup=1),
            plain_ms=chk["plain_ms"], plain_lanes=chk["lanes"],
            bound_bytes=ray_bytes(tmin, tmax, None, out_bytes) + boxes * (tblk * 32 + 32) + order_bytes,
            bound_ops_s=cones_needed * C.CONE_FLOPS / F32_OPS_PER_S,
            max_abs_err=chk["err"] if kernel == "cone_closest" else 0.0, library_ms=None,
            sub_blocks_per_ray=swept / live, needed_sub_blocks_per_ray=blocks_needed / live,
            cones_per_ray=tested / live, needed_cones_per_ray=cones_needed / live, live_rays=live,
            sub_blocks_touched=boxes,
        )
        if order is not None:
            row["ascending_ms"] = time_ms(lambda: fn(*args), samples=5, inner=2, warmup=1)
        rows.append(row)
    if b1["order"] is not None:
        o, d, tmin, tmax, _ = b1["args"]
        tile, nsb = b1["order"].tile, pc.sbounds.shape[1]
        n_tiles = -(-n // tile)
        live = int((tmax > tmin).sum())
        plain_ms, passed = b1["open_w"]
        rows.append(dict(
            kernel="open_w", at=f"{where}, bounce-1 rays in tiles of {tile}", shape=(n, nsb, tile, 0),
            ms=time_ms(lambda: KO.open_w(o, d, tmin, tmax, pc.sbounds, tile=tile)),
            order_ms=time_ms(lambda: KO.sweep_order(o, d, tmin, tmax, pc.sbounds, tile)),
            plain_ms=plain_ms,
            bound_bytes=ray_bytes(tmin, tmax, None, 1) + nsb * 24 + n_tiles * nsb * 5,
            bound_ops_s=live * nsb * KO.SLAB_FLOPS / F32_OPS_PER_S,
            max_abs_err=0.0, library_ms=None, superblocks_passed_per_tile=passed,
        ))
    return rows


def phase_hair_kernels(scene, params, cfg: Config, subset_lanes=None):
    """Every kernel of a hair main path at every shape that path gives it:
    K1 on its 294,912 sample indices, K2/K3 on the ground quad (2 triangles
    padded to 128), K4 on the attr table at the camera hits and on the
    material table at the curve hits' material ids, K7/K8 on the cones and,
    where the scene's dispatch orders their sweep, K9 on the superblock boxes."""
    import torch

    from strelka_tpu_torch.kernels import intersect as KI
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW

    dev = scene.device
    sample_idx, camera, bounce1, shadow, prims, _, seg_mat = main_path_rays(scene, params, dev, cfg)
    n = sample_idx.shape[0]
    ntri, ncones = scene.v0.shape[0], scene.cone_geom.shape[0]
    where = f"{cfg.name} {n} lanes x {ncones} cones"
    rows = sobol_rows(sample_idx, cfg, cfg.name)

    # ---- K2/K3 on the ground quad
    _, err_cam = check_intersect(scene, camera, RAY_MASK_PRIMARY, f"{cfg.name} camera")
    b1_args, err_b1, (closest_plain_ms, _) = check_intersect(scene, bounce1, RAY_MASK_PRIMARY, f"{cfg.name} bounce-1",
                                                             time_plain=True)
    sh_args = flat_args(scene, shadow, RAY_MASK_SHADOW)
    occ_p, any_plain_ms = timed_once_ms(lambda: KI.any_plain(*sh_args))
    if not torch.equal(held(lambda: KI.intersect_any(*sh_args)), occ_p):
        raise AssertionError(f"K3 differs from its plain version on the {cfg.name} shadow rays")
    flat_where = f"{cfg.name} {n} lanes x {ntri} triangles"
    rows.append(dict(
        kernel="intersect_closest", at=flat_where + ", bounce-1 rays", shape=(n, ntri),
        ms=time_ms(lambda: KI.intersect_closest(*b1_args)), plain_ms=closest_plain_ms,
        bound_bytes=ray_bytes(*b1_args[2:5], 16) + ntri * 40,
        bound_ops_s=tests_needed(b1_args, any_hit=False) * KI.MT_FLOPS / F32_OPS_PER_S,
        max_abs_err=max(err_cam, err_b1), library_ms=None,
    ))
    rows.append(dict(
        kernel="intersect_any", at=flat_where + ", shadow rays", shape=(n, ntri),
        ms=time_ms(lambda: KI.intersect_any(*sh_args)), plain_ms=any_plain_ms,
        bound_bytes=ray_bytes(*sh_args[2:5], 1) + ntri * 40,
        bound_ops_s=tests_needed(sh_args, any_hit=True) * KI.MT_FLOPS / F32_OPS_PER_S,
        max_abs_err=0.0, library_ms=None,
    ))

    # ---- K7/K8 on the cones
    subset = None
    if subset_lanes is not None:
        subset = torch.arange(0, n, n // subset_lanes, device=dev)[:subset_lanes]
    check_cones(scene, camera, f"{cfg.name} camera", subset)
    b1 = check_cones(scene, bounce1, f"{cfg.name} bounce-1", subset)
    sh = check_cones(scene, shadow, f"{cfg.name} shadow", subset)
    rows += cone_rows(scene, b1, sh, where)

    # ---- K4 on this scene's tables
    rows.append(gather_row(scene.attr_table, prims, f"{cfg.name} attr_table at the camera hits"))
    rows.append(gather_row(scene.mat_table, seg_mat, f"{cfg.name} mat_table at the curve hits' material ids"))
    finish_bounds(rows)
    return rows


def hair_scene(cfg: Config, dev):
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.scene import testscenes as TS

    t0 = time.perf_counter()
    host = TS.hair_patch(n_curves=HAIR_CURVES[cfg.name])
    scene = build_device_scene(host, device=dev)
    log(f"{cfg.name}: hair_patch(n_curves={HAIR_CURVES[cfg.name]}), {scene.num_curve_segments} segments (padded), "
        f"{scene.num_cones} cones ({scene.cone_geom.shape[0]} padded) in {scene.cone_bounds.shape[1]} "
        f"sub-blocks and {scene.cone_sbounds.shape[1]} superblocks, {scene.num_triangles} triangles; host scene and "
        f"device tables built in {time.perf_counter() - t0:.1f} s")
    return host, scene


def phase_hair(dev, t_start):
    """Phases 5 and 6 -> (hair_patch rows, main path, golden SSIM, hair_long rows, main path)."""
    from strelka_tpu_torch.scene import testscenes as TS

    host, scene = hair_scene(HAIR, dev)
    rows = phase_hair_kernels(scene, launch_params(host, HAIR.width, HAIR.height, 0), HAIR)
    ssim_hair = phase_golden(TS.hair_patch(n_curves=HAIR_CURVES["hair_patch"]), dev, "hair_patch_golden.png",
                             HAIR.kernels, HAIR_GOLDEN)
    main_hair = phase_main_path(scene, host, HAIR)
    log(f"[{time.perf_counter() - t_start:.0f} s] hair_patch phases done")
    del scene
    long_host, long_scene = hair_scene(HAIR_LONG, dev)
    long_rows = phase_hair_kernels(long_scene, launch_params(long_host, HAIR_LONG.width, HAIR_LONG.height, 0),
                                   HAIR_LONG, subset_lanes=PLAIN_SUBSET)
    main_long = phase_main_path(long_scene, long_host, HAIR_LONG)
    log(f"hair_long image mean {main_long['image_mean']:.6f} (finite; no golden exists, so no SSIM)")
    log(f"[{time.perf_counter() - t_start:.0f} s] hair_long phases done")
    return rows, main_hair, ssim_hair, long_rows, main_long


def print_kernel_lines(rows, main=None):
    """One JSON line per (kernel, shape) row; `main` is the result of the main
    path whose launches at that shape are given beside it."""
    for r in rows:
        line = {"kernel": r["kernel"], "at": r["at"], "replaces": REPLACES[r["kernel"]][0]}
        line.update({k: v for k, v in r.items() if k not in ("kernel", "at", "bound_ops_s")})
        if main is not None:
            line["launches"] = shape_launches(main, r)
        print(json.dumps(line), flush=True)


def shape_launches(main, row) -> int:
    """Launches of a row's kernel at its shape on a main path."""
    return sum(e["launches"] for e in main["launch_shapes"]
               if e["kernel"] == row["kernel"] and tuple(e["shape"]) == tuple(row["shape"]))


def main() -> int:
    if sys.argv[1:]:
        print("usage: python3 chip_smoke.py", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this probe runs on the card only", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "strelka_tpu_torch")):
        print("chip_smoke: no strelka_tpu_torch package beside this script; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from strelka_tpu_torch.kernels import build
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.scene import testscenes as TS

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    # ---- 1. build
    t0 = time.perf_counter()
    build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {'ran' if build.Built.seconds is not None else 'skipped: cached build'})")
    for line in build.ptxas_report().splitlines():
        if "registers" in line or "==" in line or "error" in line.lower():
            log("  " + line.strip())

    # ---- 2. Cornell: kernels K1-K4, fidelity through the library API, main path
    host, scene = cornell_scene(dev)
    rows = phase_kernels(scene, launch_params(host, CORNELL.width, CORNELL.height, 0))
    finish_bounds(rows)
    ssim_cornell = phase_golden(TS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True), dev,
                                "cornell_golden.png", CORNELL.kernels)
    main_cornell = phase_main_path(scene, host, CORNELL)
    log(f"[{time.perf_counter() - t_start:.0f} s] Cornell phases done")

    # ---- 3. flat kernels above 1024 triangles
    flat = phase_flat_scene(dev)
    log(f"[{time.perf_counter() - t_start:.0f} s] box_field(grid={FLAT_GRID}) phase done")

    # ---- 4. box_field on the BVH: kernels K5/K6, golden, main path
    box_host = TS.box_field(grid=BOX_GRID)
    box = build_device_scene(box_host, device=dev)
    log(f"box_field(grid={BOX_GRID}): {box.num_triangles} triangles ({box.v0.shape[0]} padded), BVH of "
        f"{box.bvh.num_nodes} nodes built by the {box.bvh.builder} builder in {box.bvh.build_seconds:.2f} s")
    box_rows, box_differ = phase_box_kernels(box, launch_params(box_host, BOX.width, BOX.height, 0))
    ssim_box = phase_golden(TS.box_field(grid=BOX_GRID), dev, "box_field_golden.png", BOX.kernels)
    main_box = phase_main_path(box, box_host, BOX)
    main_box.update(bvh_nodes=box.bvh.num_nodes, bvh_builder=box.bvh.builder,
                    bvh_build_seconds=box.bvh.build_seconds)
    log(f"[{time.perf_counter() - t_start:.0f} s] box_field(grid={BOX_GRID}) phases done")

    # ---- 5, 6. the hair scenes: kernels K7/K8, golden, main paths
    del box
    hair_rows, main_hair, ssim_hair, long_rows, main_long = phase_hair(dev, t_start)

    # ---- 7. results
    print(json.dumps({"main_path": main_cornell, "golden_ssim": ssim_cornell}), flush=True)
    print(json.dumps({"main_path": main_box, "golden_ssim": ssim_box,
                      "bvh_vs_bruteforce_lanes_differing_frac": box_differ}), flush=True)
    print(json.dumps({"flat_scene": {k: v for k, v in flat.items() if k != "kernels"}}), flush=True)
    print_kernel_lines(rows, main_cornell)
    print_kernel_lines(flat["kernels"])
    print_kernel_lines(box_rows, main_box)
    print(json.dumps({"main_path": main_hair, "golden_ssim": ssim_hair}), flush=True)
    print(json.dumps({"main_path": main_long}), flush=True)
    print_kernel_lines(hair_rows, main_hair)
    print_kernel_lines(long_rows, main_long)

    # one entry per kernel: its numbers at the first shape it was timed at
    # (K1-K4 at Cornell's, K5/K6 at box_field's, K7/K8 at hair_patch's, K9 at hair_long's) and
    # launches over the four main-path runs; "shapes" lists every shape a main path or the flat
    # scene gave it, each with its own numbers and its launches there
    from strelka_tpu_torch.kernels import KERNEL_NAMES

    numbers = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    tagged = ([(r, main_cornell) for r in rows] + [(r, None) for r in flat["kernels"]]
              + [(r, main_box) for r in box_rows] + [(r, main_hair) for r in hair_rows]
              + [(r, main_long) for r in long_rows])
    mains = (main_cornell, main_box, main_hair, main_long)
    kernels = []
    for name in KERNEL_NAMES:
        mine = [(r, m) for r, m in tagged if r["kernel"] == name]
        entry = {
            "name": name, "route": "cuda", "source": REPLACES[name][1], "replaces": REPLACES[name][0],
            "launches": sum(m["launch_counts"][name] for m in mains),
            **{f"launches_{m['scene']}": m["launch_counts"][name] for m in mains},
        }
        entry.update({k: mine[0][0][k] for k in numbers})
        # plain_lanes: the lanes the plain version ran on, where they are fewer than the kernel's
        entry["shapes"] = [dict(at=r["at"], shape=list(r["shape"]), launches=shape_launches(m, r) if m else 0,
                                **{k: r[k] for k in numbers},
                                **{k: r[k] for k in ("plain_lanes",) if r.get(k, r["shape"][0]) != r["shape"][0]})
                           for r, m in mine]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}), flush=True)
    log(f"total {time.perf_counter() - t_start:.0f} s")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
