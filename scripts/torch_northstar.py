"""North-star render on the port: kitchen at the reference's converged config.

The reference's headline showcase is Kitchen Set at 2048 spp, depth 4
(images/Kitchen_2048i_4d_2048spp_0.png). This renders the bench kitchen
stage (scene/kitchen.py:ensure_kitchen, through UsdLoader) at 1024x768 with
that spp and depth, through TorchRender's launch cache: on the card a
key's first launch runs eagerly, its second is captured as a CUDA graph
and the rest replay it. Exposure 6.25e-4 (the default settings' ISO 100,
f/4, 1/100 s), background 0.1.

Every --ckpt-every launches the accumulator goes to a checkpoint
(render/checkpoint.py, its meta: elapsed seconds, exposure, spl, W, H, spp,
depth, the card's name and power limit). A run finds its checkpoint and
resumes from it; when --max-seconds has run out at a checkpoint it stops
there and exits 0 (run it again to go on). A finished run, or a re-run of
one, writes the image from the accumulator (torch_northstar_image.py) and
its last row: wall seconds, spp done, complete, padded Mrays/s
(W*H*spp*2*depth over the wall seconds), the image path and the card,
printed as the last line and written to --out-json.

  python scripts/torch_northstar.py [--spp 2048] [--spl 2] [--depth 4] [--w 1024 --h 768]
      [--ckpt-every 64] [--max-seconds S] [--ckpt PATH] [--image PATH] [--out-json PATH] [--cpu]

Without a CUDA card it exits 1 unless --cpu is given.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

CKPT = os.path.join(ROOT, ".northstar_kitchen_torch.npz")
OUT_JSON = os.path.join(ROOT, "chiprun_out", "northstar_kitchen_torch.json")
BACKGROUND = 0.1
CONFIG_KEYS = ("W", "H", "spp", "spl", "depth")


def card_name(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    import torch

    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out.splitlines()[0].strip() if out else torch.cuda.get_device_name(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=2048)
    ap.add_argument("--spl", type=int, default=2, help="spp per launch")
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--w", type=int, default=1024)
    ap.add_argument("--h", type=int, default=768)
    ap.add_argument("--ckpt-every", type=int, default=64, help="launches between checkpoints")
    ap.add_argument("--max-seconds", type=float, default=0.0,
                    help="wall-clock budget of this run, checked at each checkpoint; 0 = none")
    ap.add_argument("--ckpt", default=CKPT, help="checkpoint path (resumed from when present)")
    ap.add_argument("--image", default=None, help="PNG path (default images/torch_kitchen_...png)")
    ap.add_argument("--out-json", default=OUT_JSON, help="where the last row is written")
    ap.add_argument("--cpu", action="store_true", help="render on the CPU instead of the CUDA card")
    args = ap.parse_args(argv)

    from strelka_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        print(f"torch_northstar: {e} (--cpu renders on the CPU)", file=sys.stderr)
        return 1

    import numpy as np
    import torch

    from strelka_tpu_torch.loaders.usd import UsdLoader
    from strelka_tpu_torch.ops import tonemap as TM
    from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu_torch.render.checkpoint import load_meta
    from strelka_tpu_torch.render.render import TorchRender
    from strelka_tpu_torch.scene.kitchen import ensure_kitchen
    from strelka_tpu_torch.scene.scene import Scene
    from strelka_tpu_torch.settings import SharedContext, make_default_settings
    from torch_northstar_image import write_image

    W, H = args.w, args.h
    config = dict(W=W, H=H, spp=args.spp, spl=args.spl, depth=args.depth)
    settings = make_default_settings(W, H)
    settings.set("render/pt/sppTotal", args.spp)
    settings.set("render/pt/spp", args.spl)
    settings.set("render/pt/depth", args.depth)
    settings.set("render/bgColor", (BACKGROUND,) * 3)
    exposure = TM.compute_exposure_value(settings)
    card = card_name(device)

    spp_done, elapsed_prev = 0, 0.0
    if os.path.exists(args.ckpt):
        meta = load_meta(args.ckpt)
        if any(meta.get(k) != v for k, v in config.items()):
            print(f"torch_northstar: {args.ckpt} is of another config "
                  f"({ {k: meta.get(k) for k in CONFIG_KEYS} }, not {config}); move it away", file=sys.stderr)
            return 2
        with np.load(args.ckpt) as data:
            spp_done = int(data["subframe_index"])
        elapsed_prev = float(meta["elapsed_s"])
        print(f"resuming at {spp_done} spp ({elapsed_prev:.1f} s so far)", flush=True)

    t0 = time.perf_counter()
    load_s = 0.0
    if spp_done < args.spp:
        host = Scene()
        if not UsdLoader().load(ensure_kitchen(), host):
            print("torch_northstar: the kitchen stage did not load", file=sys.stderr)
            return 1
        load_s = time.perf_counter() - t0
        render = TorchRender(device=device)
        render.set_scene(host)
        ctx = SharedContext(settings)
        render.set_shared_context(ctx)
        render.init()
        buf = render.create_buffer(BufferDesc(W, H, BufferFormat.FLOAT4))
        if spp_done:
            render.load_checkpoint(args.ckpt)
        launches = 0
        while ctx.subframe_index < args.spp:
            render.render(buf)
            launches += 1
            done = ctx.subframe_index
            if launches % args.ckpt_every == 0 or done >= args.spp:
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                elapsed = elapsed_prev + (time.perf_counter() - t0)
                render.save_checkpoint(args.ckpt, meta=dict(config, elapsed_s=elapsed,
                                                            exposure=np.asarray(exposure, np.float32), card=card))
                print(f"{done}/{args.spp} spp, {elapsed:.1f} s", flush=True)
                if done < args.spp and args.max_seconds and time.perf_counter() - t0 > args.max_seconds:
                    print(f"time budget reached at {done} spp: checkpointed to {args.ckpt}, run again to resume",
                          flush=True)
                    return 0
        spp_done = ctx.subframe_index

    elapsed = float(load_meta(args.ckpt)["elapsed_s"])
    path, spp_img, mean = write_image(args.ckpt, args.image)
    row = {
        "metric": "northstar_kitchen_wall_clock",
        "value": elapsed,
        "unit": "s",
        "config": f"{W}x{H} {args.spp}spp spl={args.spl} depth={args.depth}",
        "spp_done": spp_img,
        "complete": spp_img >= args.spp,
        "padded_mrays_per_s": W * H * spp_img * 2 * args.depth / elapsed / 1e6,
        "image": os.path.relpath(path, ROOT) if path.startswith(ROOT) else path,
        "image_mean": mean,
        "this_run_load_s": load_s,
        "card": card,
        "reference_config": "images/Kitchen_2048i_4d_2048spp_0.png (hdRunner/main.cpp:729-733)",
    }
    if args.out_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.out_json)), exist_ok=True)
        with open(args.out_json, "w") as f:
            json.dump(row, f, indent=1)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
