"""The Einar-class character stage (scene/character_gen.py): a textured bust
on the BVH and a groom of 200,000 strands on the cone tree, in one binary
.usdc stage under data/gen/character/ (not committed: about 30 MB).

`ensure_character` generates the stage on first use, or where it or its
texture is missing.
"""

from __future__ import annotations

import os

CHARACTER_FILES = ("character.usdc", os.path.join("textures", "skin.png"))


def character_dir() -> str:
    """data/gen/character/ of the checkout this package lies in."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    return os.path.join(root, "data", "gen", "character")


def ensure_character(base_dir: str | None = None, **sizes) -> str:
    """Path of character.usdc under base_dir (default character_dir()), after
    generating the stage there when it or its texture is missing. `sizes`
    (around, down, scalp, beard, texture, seed) pass to
    build_character_stage; give a smaller stage its own directory."""
    base_dir = character_dir() if base_dir is None else base_dir
    if all(os.path.exists(os.path.join(base_dir, f)) for f in CHARACTER_FILES):
        return os.path.join(base_dir, CHARACTER_FILES[0])
    from strelka_tpu_torch.scene.character_gen import build_character_stage

    return build_character_stage(base_dir, **sizes)
