#!/usr/bin/env python3
"""H100 probe of the PyTorch/CUDA port (strelka_tpu_torch).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. build the four CUDA kernels from strelka_tpu_torch/csrc with nvcc
     (sm_90a) into strelka_tpu_torch/_build/;
  2. hold each kernel against its plain PyTorch version on the card, at the
     shapes of the Cornell main path (512x512, 4 spp: 2^20 rays a bounce),
     and time both (CUDA events, median);
  3. render the Cornell box through TorchRender at its golden config and
     require SSIM >= 0.99 against goldens/cornell_golden.png;
  4. drive the main path at full size (render_launch, 512x512, 4 spp,
     depth 4, accumulation): 1 warm-up + 16 timed launches, with every
     kernel's launch count reset just before and read just after;
  5. print the kernels' JSON line, the card's name and power limit, and
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

REPO = os.path.dirname(os.path.abspath(__file__))

# main-path configuration (the cornell row of bench.py:231)
WIDTH = HEIGHT = 512
SPP = 4
DEPTH = 4
MAX_SAMPLE_COUNT = 100000  # as bench.py's render_launch
TIMED_LAUNCHES = 16
EXPOSURE = [6.25e-4] * 3  # as bench.py's build_scene
GOLDEN = (64, 64, 4, 4)  # bench.GOLDEN_CONFIGS["cornell"]: w, h, spp, launches

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
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


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


def main_path_kw() -> dict:
    """render_launch's keyword arguments on the main path."""
    return dict(width=WIDTH, height=HEIGHT, samples_per_launch=SPP, max_sample_count=MAX_SAMPLE_COUNT,
                max_depth=DEPTH, enable_accumulation=True)


def main_path_rays(scene, params, device):
    """Sample indices, camera rays and bounce-1 rays of the first launch of
    the main path (the shapes the kernels see there)."""
    import torch

    from strelka_tpu_torch.ops import bsdf as B
    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.ops import sampler as S
    from strelka_tpu_torch.ops import vec as V
    from strelka_tpu_torch.ops.intersect import intersect_closest, offset_ray_vec
    from strelka_tpu_torch.render.device_scene import ATTR_LIGHT_ROW, ATTR_MAT_ROW, RAY_MASK_PRIMARY

    n = WIDTH * HEIGHT
    idx = torch.arange(n, dtype=torch.int64, device=device)
    px, py = (idx % WIDTH).repeat(SPP), (idx // WIDTH).repeat(SPP)
    s_of_ray = torch.arange(SPP, dtype=torch.int64, device=device).repeat_interleave(n)
    sample_idx = S.make_sample_index(px, py, s_of_ray, MAX_SAMPLE_COUNT)
    jxy = S.random_dims(sample_idx, 0, (0, 1))
    origin, direction = I.generate_camera_rays(params, px, py, jxy[0], jxy[1], WIDTH, HEIGHT)
    m = sample_idx.shape[0]
    tmin = torch.zeros(m, dtype=torch.float32, device=device)
    tmax = torch.full((m,), 1e16, dtype=torch.float32, device=device)
    hit = intersect_closest(scene, origin, direction, tmin, tmax, RAY_MASK_PRIMARY)
    # bounce 0 shading, as trace_paths does it, to get the bounce-1 rays
    dims = S.random_dims(sample_idx, 0, (0, 1, 2, 3, 4))
    inside = torch.zeros(m, dtype=torch.bool, device=device)
    position, frame, light_id, rows = I._gather_surface(scene, hit, inside)
    mat = I._material_from_rows(rows[ATTR_MAT_ROW:ATTR_LIGHT_ROW])
    smp = B.bsdf_sample(mat, frame, -direction, (dims[0], dims[1], dims[2], dims[3]),
                        torch.ones_like(mat.ior), mat.ior)
    transmission = (smp.event_type & B.BSDF_EVENT_TRANSMISSION) != 0
    org1 = offset_ray_vec(position, V.where(transmission, -frame.geom_normal, frame.geom_normal))
    alive1 = (hit.prim >= 0) & (light_id < 0) & (smp.event_type != B.BSDF_EVENT_ABSORB)
    camera = dict(o=origin, d=direction, tmin=tmin, tmax=tmax, exclude=torch.full_like(hit.prim, -1))
    bounce1 = dict(o=org1, d=smp.k2, tmin=tmin, tmax=torch.where(alive1, 1e16, 0.0), exclude=hit.prim)
    return sample_idx, camera, bounce1, hit.prim


def _contig(rays):
    return tuple(c.contiguous() for c in rays["o"]), tuple(c.contiguous() for c in rays["d"])


def check_intersect(scene, rays, ray_mask, name):
    """K2 and K3 against their plain versions on one ray set. Returns the
    kernels' arguments and K2's largest absolute difference in t, u or v
    over the lanes where both give the same prim (misses included)."""
    import torch

    from strelka_tpu_torch.kernels import intersect as KI

    o, d = _contig(rays)
    args = (o, d, rays["tmin"], rays["tmax"], rays["exclude"], scene.v0, scene.e1, scene.e2, scene.geom_mask,
            ray_mask)
    t_k, p_k, u_k, v_k = KI.intersect_closest(*args)
    t_p, p_p, u_p, v_p = KI.closest_plain(*args)
    torch.cuda.synchronize()
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
    occ_k = KI.intersect_any(*args)
    occ_p = KI.any_plain(*args)
    torch.cuda.synchronize()
    bad_occ = int((occ_k != occ_p).sum())
    if bad_occ:
        raise AssertionError(f"K3 on {name}: {bad_occ} occlusion results differ")
    max_abs = max(float(torch.abs(a - b)[same].max()) if bool(same.any()) else 0.0
                  for a, b in ((t_k, t_p), (u_k, u_p), (v_k, v_p)))
    log(f"K2/K3 on {name} rays ({rays['tmin'].shape[0]}): prims equal but for {int(differ.sum())} ties "
        f"(|dt| <= 1e-5 t), max rel t err {t_err:.3g} (limit 1e-6), u and v bit-equal on the "
        f"{int(same.sum())} lanes with equal prims, occlusion equal ({int(occ_k.sum())} occluded)")
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
    total = 0
    for r0 in range(0, tmin.shape[0], 65536):
        rs = slice(r0, r0 + 65536)
        live = tmax[rs] > tmin[rs]
        candidate = match[None, :] & (ids[None, :] != exclude[rs, None])
        if any_hit:
            oc, dc = [c[rs] for c in o], [c[rs] for c in d]
            _, _, _, hit = KI.mt_block(oc, dc, v0, e1, e2, tmin[rs], tmax[rs])
            hit = KI._valid(hit, mask, ray_mask, 0, exclude[rs])
            first = torch.where(hit, ids[None, :], ntri).min(dim=1).values
            candidate = candidate & (ids[None, :] <= first[:, None])
        total += int((candidate & live[:, None]).sum())
    return total


def phase_kernels(scene, params):
    import torch

    from strelka_tpu_torch.kernels import gather as KG
    from strelka_tpu_torch.kernels import intersect as KI
    from strelka_tpu_torch.kernels import sobol as KS
    from strelka_tpu_torch.ops import sampler as S
    from strelka_tpu_torch.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW

    dev = scene.device
    sample_idx, camera, bounce1, prims = main_path_rays(scene, params, dev)
    n = sample_idx.shape[0]
    rows = {}

    # ---- K1: every depth of the main path, bit-equal
    dims = (0, 1, 2, 3, 4)
    for depth in range(DEPTH):
        a = KS.random_dims(sample_idx, depth, dims)
        b = KS.random_dims_plain(sample_idx, depth, dims)
        torch.cuda.synchronize()
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"K1 differs from its plain version at depth {depth}")
    log(f"K1 bit-equal (tolerance: none) on {n} sample indices, depths 0..{DEPTH - 1}")
    rows["sobol"] = dict(
        ms=time_ms(lambda: KS.random_dims(sample_idx, 1, dims)),
        plain_ms=time_ms(lambda: KS.random_dims_plain(sample_idx, 1, dims), samples=5, inner=2),
        bound_bytes=n * 8 + len(dims) * n * 4, bound_ops_s=sobol_bound_s(n, len(dims)),
        max_abs_err=0.0, library_ms=None,
    )

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
    if not torch.equal(KI.intersect_any(*sh_args), KI.any_plain(*sh_args)):
        raise AssertionError("K3 differs from its plain version on shadow-style rays")
    ntri = scene.v0.shape[0]
    tests_k2, tests_k3 = tests_needed(b1_args, any_hit=False), tests_needed(sh_args, any_hit=True)
    log(f"ray-triangle tests needed: K2 {tests_k2} on the bounce-1 rays, K3 {tests_k3} on the shadow-style "
        f"rays; of {ntri} triangles {int(((scene.geom_mask & RAY_MASK_PRIMARY) != 0).sum())} match the "
        f"primary ray mask, {int(((scene.geom_mask & RAY_MASK_SHADOW) != 0).sum())} the shadow mask")
    rows["intersect_closest"] = dict(
        ms=time_ms(lambda: KI.intersect_closest(*b1_args)),
        plain_ms=time_ms(lambda: KI.closest_plain(*b1_args), samples=3, inner=1, warmup=1),
        bound_bytes=n * (8 * 4 + 4 + 16) + ntri * 40,
        bound_ops_s=tests_k2 * KI.MT_FLOPS / F32_OPS_PER_S,
        max_abs_err=max(err_cam, err_b1), library_ms=None,
    )
    rows["intersect_any"] = dict(
        ms=time_ms(lambda: KI.intersect_any(*sh_args)),
        plain_ms=time_ms(lambda: KI.any_plain(*sh_args), samples=3, inner=1, warmup=1),
        bound_bytes=n * (8 * 4 + 4 + 1) + ntri * 40,
        bound_ops_s=tests_k3 * KI.MT_FLOPS / F32_OPS_PER_S,
        max_abs_err=0.0, library_ms=None,
    )

    # ---- K4: the attr table at the camera hits (2^20 indices), bit-equal
    table = scene.attr_table
    gidx = torch.clamp(prims, min=0).contiguous()
    a = KG.gather_rows_t(table, gidx)
    b = KG.gather_rows_t_plain(table, gidx)
    torch.cuda.synchronize()
    if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
        raise AssertionError("K4 differs from its plain version")
    log(f"K4 bit-equal (tolerance: none) on attr_table {tuple(table.shape)} x {n} indices")
    gidx64 = gidx.to(torch.int64)
    rows["gather_rows_t"] = dict(
        ms=time_ms(lambda: KG.gather_rows_t(table, gidx)),
        plain_ms=time_ms(lambda: KG.gather_rows_t_plain(table, gidx)),
        bound_bytes=n * 4 + table.numel() * 4 + n * table.shape[1] * 4,
        bound_ops_s=0.0,
        max_abs_err=0.0,
        library_ms=time_ms(lambda: torch.index_select(table, 0, gidx64).t().contiguous()),
    )
    return rows


def phase_golden(device) -> float:
    import numpy as np

    from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu_torch.render.render import RenderFactory, RenderType
    from strelka_tpu_torch.scene import testscenes as TS
    from strelka_tpu_torch.settings import SharedContext, make_default_settings
    from strelka_tpu_torch.utils.image import read_png, ssim

    w, h, spp, launches = GOLDEN
    s = make_default_settings(w, h)
    s.set("render/pt/sppTotal", spp * launches)
    s.set("render/pt/spp", spp)
    r = RenderFactory.create_render(RenderType.eTorch, device=device)
    r.set_scene(TS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True))
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(w, h, BufferFormat.FLOAT4))
    for _ in range(launches):
        r.render(buf)
    img = buf.map()[..., :3]
    if not np.isfinite(img).all():
        raise AssertionError("golden-config render has non-finite pixels")
    golden = read_png(os.path.join(REPO, "goldens", "cornell_golden.png"))[..., :3]
    return float(ssim(np.clip(img, 0.0, 1.0), golden))


def phase_main_path(scene, host):
    import numpy as np
    import torch

    from strelka_tpu_torch import kernels as K
    from strelka_tpu_torch.ops import integrator as I

    dev = scene.device
    kw = main_path_kw()
    state = I.make_frame_state(HEIGHT, WIDTH, dev)
    torch.cuda.synchronize()
    K.reset_counts()
    state, image = I.render_launch(scene, launch_params(host, WIDTH, HEIGHT, 0), state, **kw)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TIMED_LAUNCHES):
        state, image = I.render_launch(scene, launch_params(host, WIDTH, HEIGHT, (i + 1) * SPP), state, **kw)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / TIMED_LAUNCHES
    counts = dict(K.launch_counts)
    plain = dict(K.plain_cuda_calls)
    launches = 1 + TIMED_LAUNCHES
    for name, c in counts.items():
        if c == 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    if any(plain.values()):
        raise AssertionError(f"a plain version ran on CUDA on the main path: {plain}")
    img = image.cpu().numpy()
    if img.shape != (3, HEIGHT, WIDTH) or not np.isfinite(img).all():
        raise AssertionError(f"main-path image is {img.shape} with non-finite values")
    # alive-ray accounting: one instrumented launch, same config
    _, _, stats = I.render_launch(scene, launch_params(host, WIDTH, HEIGHT, launches * SPP), state,
                                  collect_stats=True, **kw)
    alive = float(stats["closest_rays"]) + float(stats["shadow_rays"])
    padded = WIDTH * HEIGHT * SPP * 2 * DEPTH
    result = dict(
        ms_per_launch=dt * 1e3,
        padded_mrays_per_s=padded / dt / 1e6,
        alive_mrays_per_s=alive / dt / 1e6,
        alive_ray_frac=alive / padded,
        image_mean=float(img.mean()),
        render_launches=launches,
        launch_counts=counts,
        launches_per_render_launch={k: v / launches for k, v in counts.items()},
        plain_cuda_calls=plain,
    )
    return result


def main() -> int:
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
    from strelka_tpu_torch import kernels as K
    from strelka_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    # ---- 1. build
    t0 = time.perf_counter()
    build.load()
    log(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {'ran' if build.Built.seconds is not None else 'skipped: cached build'})")
    for line in build.ptxas_report().splitlines():
        if "registers" in line or "==" in line or "error" in line.lower():
            log("  " + line.strip())

    host, scene = cornell_scene(dev)
    params = launch_params(host, WIDTH, HEIGHT, 0)

    # ---- 2. kernels against their plain versions
    rows = phase_kernels(scene, params)
    for name, r in rows.items():
        bytes_s = r["bound_bytes"] / HBM_BYTES_PER_S
        r["bound_ms"] = max(bytes_s, r["bound_ops_s"]) * 1e3
        r["bound_by"] = "bytes" if bytes_s >= r["bound_ops_s"] else "operations"

    # ---- 3. fidelity through the library API
    K.reset_counts()
    s = phase_golden(dev)
    golden_counts = dict(K.launch_counts)
    log(f"golden config {GOLDEN}: SSIM vs goldens/cornell_golden.png = {s:.6f}; launches {golden_counts}")
    if s < 0.99:
        raise AssertionError(f"SSIM {s} < 0.99")
    if not all(golden_counts.values()) or any(K.plain_cuda_calls.values()):
        raise AssertionError("the golden-config render did not run every kernel on the card")

    # ---- 4. main path at full size
    main = phase_main_path(scene, host)
    log(f"cornell {WIDTH}x{HEIGHT} spp={SPP} depth={DEPTH}: {main['ms_per_launch']:.3f} ms/launch, "
        f"{main['padded_mrays_per_s']:.1f} padded Mrays/s, {main['alive_mrays_per_s']:.1f} alive Mrays/s "
        f"(alive fraction {main['alive_ray_frac']:.3f})")
    log(f"launch counts over {main['render_launches']} render launches: {main['launch_counts']} "
        f"(plain versions on CUDA: {main['plain_cuda_calls']})")
    print(json.dumps({"main_path": main, "golden_ssim": s}), flush=True)
    for name, r in rows.items():
        print(json.dumps({"kernel": name, "replaces": REPLACES[name][0], "ms": r["ms"], "bound_ms": r["bound_ms"],
                          "bound_by": r["bound_by"], "plain_ms": r["plain_ms"], "library_ms": r["library_ms"],
                          "max_err": r["max_abs_err"],
                          "launches_per_render_launch": main["launches_per_render_launch"][name]}), flush=True)

    kernels = []
    for name, r in rows.items():
        kernels.append({
            "name": name, "route": "cuda", "source": REPLACES[name][1], "replaces": REPLACES[name][0],
            "launches": main["launch_counts"][name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(line.strip(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
