"""usd_runner — port of the hdRunner USD viewer (src/hdRunner/main.cpp:443-770).

Loads a USD stage through the Hydra-style delegate, runs the progressive
render loop, prints per-frame timing (the title-bar counter), and saves the
screenshot at target spp using the reference's naming scheme
(<scene>_<iter>i_<depth>d_<spp>spp_<n>.png, hdRunner/main.cpp:729-733).

The PyTorch counterpart of strelka_tpu/app/usd_runner.py, with the same
flags: it renders on the CUDA card and exits non-zero without one; --cpu
renders on the CPU.

Usage: python -m strelka_tpu_torch.app.usd_runner -s scene.usd[ac] -i 100 -t 64 -f 1 -c
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

from strelka_tpu_torch import log
from strelka_tpu_torch.hydra import HdStrelkaDriverName, StrelkaRendererPlugin
from strelka_tpu_torch.settings import SharedContext, make_default_settings
from strelka_tpu_torch.utils.device import resolve_device
from strelka_tpu_torch.utils.image import write_png


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("usd_runner", description="USD progressive renderer")
    parser.add_argument("-s", "--scene", required=True, help="USD stage (.usda | .usdc | .usd)")
    parser.add_argument("-i", "--iteration", type=int, default=-1)
    parser.add_argument("-t", "--spp-total", type=int, default=64)
    parser.add_argument("-f", "--spp-subframe", type=int, default=1)
    parser.add_argument("-c", "--need-screenshot", action="store_true")
    parser.add_argument("-v", "--validation", action="store_true")
    parser.add_argument("-o", "--output", default="")
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--height", type=int, default=768)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--camera", default="", help="camera prim name")
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--multichip", action="store_true")
    args = parser.parse_args(argv)

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        log.fatal("{} (--cpu renders on the CPU)", e)
        return 1

    if not os.path.exists(args.scene):
        log.fatal("Scene file doesn't exist: {}", args.scene)
        return 1

    # settings block (hdRunner/main.cpp:506-543, same keys as the glTF app)
    settings = make_default_settings(args.width, args.height)
    settings.set("render/pt/sppTotal", args.spp_total)
    settings.set("render/pt/spp", args.spp_subframe)
    settings.set("render/pt/depth", args.depth)
    settings.set("render/enableValidation", args.validation)
    settings.set("resource/searchPath", os.path.dirname(os.path.abspath(args.scene)))
    ctx = SharedContext(settings)

    # plugin -> delegate -> driver -> populate (main.cpp:48-54, 545-591)
    load_t0 = time.perf_counter()
    delegate = StrelkaRendererPlugin.create_render_delegate(use_sharding=args.multichip, device=device)
    delegate.set_drivers({HdStrelkaDriverName: ctx})
    if not delegate.populate_from_usd(args.scene):
        return 1
    render_pass = delegate.create_render_pass()
    buf = delegate.create_render_buffer(args.width, args.height)
    log.info("Stage setup in {:.2f}s", time.perf_counter() - load_t0)

    # camera selection (main.cpp:56-91): by name or first found
    if args.camera:
        idx = delegate.scene.find_camera_by_name(args.camera)
        if idx > 0:
            delegate.scene.cameras[0], delegate.scene.cameras[idx] = (
                delegate.scene.cameras[idx],
                delegate.scene.cameras[0],
            )

    iteration = 0
    total_t0 = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        render_pass.execute(buf)
        img = buf.map()
        dt = (time.perf_counter() - t0) * 1e3
        print(f"Strelka {dt:.1f} ms [{ctx.subframe_index} spp]", flush=True)
        iteration += 1
        if ctx.subframe_index >= args.spp_total or (0 < args.iteration <= iteration):
            break
    log.info(
        "Rendered {} spp in {:.2f}s total", ctx.subframe_index, time.perf_counter() - total_t0
    )

    if args.need_screenshot or args.output:
        out = args.output
        if not out:
            base = os.path.splitext(os.path.basename(args.scene))[0]
            out = f"{base}_{iteration}i_{args.depth}d_{ctx.subframe_index}spp_0.png"
        write_png(out, np.asarray(img)[..., :3])
        log.info("Saved screenshot: {}", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
