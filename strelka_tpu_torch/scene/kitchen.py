"""The kitchen bench stage: a binary .usdc interior (105,168 triangles, 10
materials, 4 textures, 4 lights) that the repository keeps under
data/gen/kitchen/.

The port's counterpart of the path half of strelka_tpu/scene/kitchen_gen.py
(`ensure_kitchen`). The stage and its textures are committed files; the
generator that rebuilds them is not ported (ROADMAP A.7), so a missing file
raises.
"""

from __future__ import annotations

import os

KITCHEN_TEXTURES = ("checker.png", "wood.png", "wallpaper.png", "fabric.png")


def kitchen_dir() -> str:
    """data/gen/kitchen/ of the checkout this package lies in."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "data", "gen", "kitchen")


def ensure_kitchen(base_dir: str | None = None) -> str:
    """Path of kitchen.usdc, after checking that it and every texture it
    names exist (FileNotFoundError naming the first that does not)."""
    base_dir = kitchen_dir() if base_dir is None else base_dir
    usdc = os.path.join(base_dir, "kitchen.usdc")
    for path in (usdc, *(os.path.join(base_dir, "textures", t) for t in KITCHEN_TEXTURES)):
        if not os.path.exists(path):
            raise FileNotFoundError(f"{path} is missing; the port does not regenerate the kitchen stage "
                                    "(ROADMAP A.7)")
    return usdc
