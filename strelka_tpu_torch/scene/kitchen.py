"""The kitchen bench stage: a binary .usdc interior (105,168 triangles, 10
materials, 4 textures, 4 lights) that the repository keeps under
data/gen/kitchen/.

The port's counterpart of the path half of strelka_tpu/scene/kitchen_gen.py
(`ensure_kitchen`). The stage and its textures are committed files; where
one is missing, scene/kitchen_gen.py:build_kitchen_stage generates them all.
"""

from __future__ import annotations

import os

KITCHEN_TEXTURES = ("checker.png", "wood.png", "wallpaper.png", "fabric.png")


def kitchen_dir() -> str:
    """data/gen/kitchen/ of the checkout this package lies in."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "data", "gen", "kitchen")


def ensure_kitchen(base_dir: str | None = None) -> str:
    """Path of kitchen.usdc under base_dir (default kitchen_dir()), after
    generating the stage there when it or any texture it names is missing
    (a .usdc alone is not enough: without its textures it renders bare)."""
    base_dir = kitchen_dir() if base_dir is None else base_dir
    usdc = os.path.join(base_dir, "kitchen.usdc")
    if all(os.path.exists(p) for p in (usdc, *(os.path.join(base_dir, "textures", t) for t in KITCHEN_TEXTURES))):
        return usdc
    from strelka_tpu_torch.scene.kitchen_gen import build_kitchen_stage

    return build_kitchen_stage(base_dir)
