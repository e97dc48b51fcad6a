"""The north-star kitchen PNG from a torch_northstar.py checkpoint, on the CPU.

The checkpoint's accumulator holds the mean radiance so far; this tonemaps
it (Reinhard, gamma 2.4) with the exposure the render used, read from the
checkpoint's meta, and writes an 8-bit PNG. It needs no card, so a run cut
by its time budget can publish its partly converged image at any point.

  python scripts/torch_northstar_image.py [--ckpt .northstar_kitchen_torch.npz] [out.png]
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CKPT = os.path.join(ROOT, ".northstar_kitchen_torch.npz")


def default_image_path(meta: dict, spp: int) -> str:
    return os.path.join(ROOT, "images", f"torch_kitchen_{spp}spp_{meta['depth']}d_{meta['W']}x{meta['H']}.png")


def write_image(ckpt: str, path: str | None = None) -> tuple:
    """Tonemap the checkpoint's accumulator with its meta's exposure and
    write it to `path` (default: images/torch_kitchen_<spp>spp_<depth>d_<W>x<H>.png).
    Returns (path, spp, the image's mean)."""
    import numpy as np

    from strelka_tpu_torch.ops import tonemap as TM
    from strelka_tpu_torch.render.checkpoint import load_checkpoint, load_meta
    from strelka_tpu_torch.utils.image import write_png

    state, spp = load_checkpoint(ckpt, "cpu")
    meta = load_meta(ckpt)
    if "exposure" not in meta:
        raise ValueError(f"{ckpt}: no exposure in the checkpoint's meta")
    img = TM.apply_tonemap_planar(state.accum, TM.ToneMapperType.eReinhard,
                                  np.asarray(meta["exposure"], np.float32), 2.4)
    out = np.clip(img.numpy().transpose(1, 2, 0), 0.0, 1.0)
    path = path or default_image_path(meta, spp)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    write_png(path, out)
    return path, spp, float(out.mean())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default=None, help="PNG path (default under images/)")
    ap.add_argument("--ckpt", default=CKPT, help="checkpoint written by torch_northstar.py")
    args = ap.parse_args(argv)
    if not os.path.exists(args.ckpt):
        print(f"no checkpoint at {args.ckpt}", file=sys.stderr)
        return 1
    path, spp, mean = write_image(args.ckpt, args.out)
    print(f"wrote {path} ({spp} spp, mean={mean:.4f})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
