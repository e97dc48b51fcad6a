"""Strelka CLI — port of the glTF viewer app (src/app/main.cpp:250-407).

Headless progressive renderer: same flags (-s scene, -t sppTotal, -f spp
subframe, -i capture iteration, -c screenshot, -v validation), plus output
controls. The display/UI layer of the reference maps to PNG output + the
interactive viewer in strelka_tpu_torch.app.viewer.

The PyTorch counterpart of strelka_tpu/app/cli.py, with the same flags and
defaults. It renders on the CUDA card and exits non-zero without one;
--cpu renders on the CPU (the kernels' plain PyTorch versions).

Usage:
  python -m strelka_tpu_torch.app.cli -s scene.gltf -t 64 -f 1 -c
  python -m strelka_tpu_torch.app.cli -s builtin://cornell_box -t 256 -f 8 -c
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from strelka_tpu_torch import log
from strelka_tpu_torch.loaders.gltf import GltfLoader
from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
from strelka_tpu_torch.render.render import RenderFactory
from strelka_tpu_torch.scene.scene import Scene
from strelka_tpu_torch.settings import SharedContext, make_default_settings
from strelka_tpu_torch.utils.device import resolve_device
from strelka_tpu_torch.utils.image import write_png


def load_scene(scene_path: str) -> Scene:
    if scene_path.startswith("builtin://"):
        from strelka_tpu_torch.scene import testscenes

        name = scene_path[len("builtin://") :]
        factory = getattr(testscenes, name, None)
        if factory is None:
            log.fatal("Unknown builtin scene: {}", name)
            sys.exit(1)
        return factory()
    scene = Scene()
    ext = os.path.splitext(scene_path)[1].lower()
    if ext in (".gltf", ".glb"):
        if not GltfLoader().load_gltf(scene_path, scene):
            log.fatal("unable to load scene: {}", scene_path)
            sys.exit(1)
    elif ext in (".usda", ".usd", ".usdc"):
        from strelka_tpu_torch.loaders.usd import UsdLoader

        if not UsdLoader().load(scene_path, scene):
            log.fatal("unable to load scene: {}", scene_path)
            sys.exit(1)
    else:
        log.fatal("Unsupported scene format: {}", ext)
        sys.exit(1)
    return scene


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("strelka", description="path tracer on PyTorch and CUDA")
    parser.add_argument("-s", "--scene", default="", help="scene path (gltf/glb/usda or builtin://name)")
    parser.add_argument("-i", "--iteration", type=int, default=-1, help="iteration to capture")
    parser.add_argument("-t", "--spp-total", type=int, default=64)
    parser.add_argument("-f", "--spp-subframe", type=int, default=1)
    parser.add_argument("-c", "--need-screenshot", action="store_true")
    parser.add_argument("-v", "--validation", action="store_true", help="report NaN and canary pixels per frame")
    parser.add_argument("-o", "--output", default="", help="output PNG path")
    parser.add_argument("--width", type=int, default=1024)
    parser.add_argument("--height", type=int, default=768)
    parser.add_argument("--depth", type=int, default=4)
    parser.add_argument("--tonemapper", type=int, default=0, help="0 reinhard 1 aces 2 filmic 3 none")
    parser.add_argument("--debug-view", type=int, default=0, help="0 none 1 normals 2 diffuse 3 specular")
    parser.add_argument("--cpu", action="store_true", help="render on the CPU instead of the CUDA card")
    parser.add_argument("--multichip", action="store_true", help="band pixel rows over all CUDA cards")
    parser.add_argument("--checkpoint", default="", help="save accumulator checkpoint here at exit")
    parser.add_argument("--resume", default="", help="resume accumulation from a checkpoint")
    parser.add_argument("--upscale", type=float, default=0.0, help="render at FACTOR res, upscale to output")
    parser.add_argument("--play-animation", action="store_true", help="advance scene animation per frame")
    parser.add_argument("--profile", default="", help="capture a torch.profiler trace and the program's spans "
                        "(spans.json) into this dir")
    args = parser.parse_args(argv)

    try:
        device = resolve_device("cpu" if args.cpu else None)
    except RuntimeError as e:
        log.fatal("{} (--cpu renders on the CPU)", e)
        return 1
    if args.validation:
        log.info("Validation mode: device NaN canaries active (red pixels)")

    if not args.scene:
        log.fatal("Specify scene file name")
        return 1
    if not args.scene.startswith("builtin://") and not os.path.exists(args.scene):
        log.fatal("Specified scene file: {} doesn't exist", args.scene)
        return 1

    settings = make_default_settings(args.width, args.height)
    settings.set("render/pt/sppTotal", args.spp_total)
    settings.set("render/pt/spp", args.spp_subframe)
    settings.set("render/pt/depth", args.depth)
    settings.set("render/pt/tonemapperType", args.tonemapper)
    settings.set("render/pt/debug", args.debug_view)
    settings.set("render/pt/screenshotSPP", args.need_screenshot)
    settings.set("render/enableValidation", args.validation)
    if args.upscale > 0.0:
        settings.set("render/pt/enableUpscale", True)
        settings.set("render/pt/upscaleFactor", args.upscale)
    if not args.scene.startswith("builtin://"):
        settings.set("resource/searchPath", os.path.dirname(os.path.abspath(args.scene)))

    ctx = SharedContext(settings)
    load_t0 = time.perf_counter()
    scene = load_scene(args.scene)
    log.info("Scene loaded in {:.3f}s", time.perf_counter() - load_t0)
    render = RenderFactory.create_render(device=device, use_sharding=args.multichip)
    render.set_scene(scene)
    render.set_shared_context(ctx)
    render.init()
    ctx.render = render

    buf = render.create_buffer(BufferDesc(args.width, args.height, BufferFormat.FLOAT4))
    if args.resume:
        render.load_checkpoint(args.resume)

    from strelka_tpu_torch import kernels
    from strelka_tpu_torch.utils import profiling

    kernels.count_replays = True  # the "Kernel launches" line counts the graphs' replays too
    if args.profile:
        profiling.enable()
    anim_time = scene.animations[0].start if (args.play_animation and scene.animations) else 0.0
    iteration = 0
    stats = profiling.FrameStats()
    start_total = time.perf_counter()
    import contextlib

    trace_cm = profiling.device_trace(args.profile) if args.profile else contextlib.nullcontext()
    per_frame = []  # each frame's device ms by span name, with the recorder on
    with trace_cm as run_dir:
        while True:
            t0 = time.perf_counter()
            if args.play_animation and scene.animations:
                scene.update_animation(anim_time)
                anim_time += 1.0 / 24.0
            spp_before = ctx.subframe_index
            render.render(buf)
            img = buf.map()
            dt = time.perf_counter() - t0
            if args.profile:
                per_frame.append(profiling.device_ms(profiling.collect()["device"]))
            rays = args.width * args.height * max(ctx.subframe_index - spp_before, 0) * 2 * args.depth
            stats.add_frame(dt, rays)
            # title-bar equivalent (app/main.cpp:399-403)
            print(stats.title(spp=ctx.subframe_index), flush=True)
            iteration += 1
            done_spp = ctx.subframe_index >= args.spp_total
            done_iter = args.iteration > 0 and iteration >= args.iteration
            if done_spp or done_iter:
                break

    total = time.perf_counter() - start_total
    log.info(
        "Rendered {} spp in {:.2f}s ({:.1f} Mray/s avg)",
        ctx.subframe_index,
        total,
        stats.mrays_per_sec,
    )
    log.info("Kernel launches: {}", json.dumps(kernels.launch_counts, sort_keys=True))
    if args.profile:
        profiling.disable()
        for name, ms in profiling.summarize_trace(args.profile, top=10):
            log.info("profile: {:.2f}ms {}", ms, name)
        spans = profiling.export()
        spans["per_frame"] = per_frame
        with open(os.path.join(run_dir, profiling.SPANS_NAME), "w") as f:
            json.dump(spans, f, indent=1)
        for name, ms in sorted(spans["device_ms"].items(), key=lambda kv: -kv[1]):
            log.info("span: {:.3f}ms a frame {}", ms, name)

    if args.checkpoint:
        render.save_checkpoint(args.checkpoint)
    if args.need_screenshot or args.output:
        out = args.output
        if not out:
            # hdRunner naming scheme: <scene>_<iter>i_<depth>d_<spp>spp_0.png
            base = os.path.splitext(os.path.basename(args.scene.replace("builtin://", "")))[0]
            out = f"{base}_{iteration}i_{args.depth}d_{ctx.subframe_index}spp_0.png"
        write_png(out, np.asarray(img)[..., :3])
        log.info("Saved screenshot: {}", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
