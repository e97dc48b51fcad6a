"""The showcase images on the port: the five scenes of scripts/render_showcase.py
at its spp, spp a launch, depth, exposure and background, 512x512, Reinhard
tonemap with gamma 2.4, through render_launch on the card (the kernels,
the accelerator path's wavefront order).

  python scripts/torch_render_showcase.py [--only cornell kitchen ...] [--out-dir images] [--cpu]

Writes <out-dir>/torch_<scene>_<spp>spp_<depth>d.png and prints one line a
scene with its wall seconds. Without a CUDA card it exits 1 unless --cpu is
given (the CPU takes minutes for box_field and kitchen).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# scripts/render_showcase.py:33-52: (spp total, spp a launch, depth, exposure, background)
SHOWCASE = {
    "cornell": (512, 8, 4, 6.25e-4, 0.0),
    "coffeetable": (512, 8, 4, 6.25e-4, 0.0),
    "hair_patch": (128, 4, 4, 8e-4, 0.35),
    "box_field": (32, 2, 4, 2e-4, 0.0),
    "kitchen": (64, 2, 4, 1.2e-3, 0.02),
}


def host_scene(name: str):
    from strelka_tpu_torch.loaders.usd import UsdLoader
    from strelka_tpu_torch.scene import testscenes as TS
    from strelka_tpu_torch.scene.kitchen import ensure_kitchen
    from strelka_tpu_torch.scene.scene import Scene

    if name == "cornell":
        return TS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True)
    if name == "hair_patch":
        return TS.hair_patch(n_curves=256)
    if name == "box_field":
        return TS.box_field(grid=48)
    host = Scene()
    path = os.path.join(ROOT, "data", "scenes", "coffeetable.usda") if name == "coffeetable" else ensure_kitchen()
    if not UsdLoader().load(path, host):
        raise RuntimeError(f"{path} did not load")
    return host


def render(name: str, device, out_dir: str, width: int = 512, height: int = 512) -> str:
    import numpy as np
    import torch

    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.ops import tonemap as TM
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.utils.image import write_png

    spp_total, spl, depth, exposure, bg = SHOWCASE[name]
    host = host_scene(name)
    scene = build_device_scene(host, device=device)
    cam = host.get_camera(0)
    cam.update_aspect_ratio(width / height)
    exposure3 = np.full(3, exposure, np.float32)
    params = I.LaunchParams(0, np.asarray(cam.clip_to_view(), np.float32), np.asarray(cam.view_to_world(), np.float32),
                            exposure3, np.full(3, bg, np.float32))
    state = I.make_frame_state(height, width, device)
    t0 = time.perf_counter()
    for i in range(spp_total // spl):
        state, img = I.render_launch(scene, params._replace(subframe_index=i * spl), state, width=width,
                                     height=height, samples_per_launch=spl, max_sample_count=spp_total,
                                     max_depth=depth, enable_accumulation=True)
    img = TM.apply_tonemap_planar(img, TM.ToneMapperType.eReinhard, exposure3, 2.4)
    out = np.clip(img.cpu().numpy().transpose(1, 2, 0), 0.0, 1.0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    path = os.path.join(out_dir, f"torch_{name}_{spp_total}spp_{depth}d.png")
    os.makedirs(out_dir, exist_ok=True)
    write_png(path, out)
    print(f"{path}: {time.perf_counter() - t0:.1f} s, mean {out.mean():.4f}", flush=True)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", choices=list(SHOWCASE), default=list(SHOWCASE))
    ap.add_argument("--out-dir", default=os.path.join(ROOT, "images"))
    ap.add_argument("--cpu", action="store_true", help="render on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    from strelka_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"torch_render_showcase: {e} (--cpu renders on the CPU)", file=sys.stderr)
        return 1
    for name in args.only:
        render(name, device, args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
