"""A stage on disk, read by each side's own UsdLoader.

Configuration: `scene.stage`, the stage's path relative to the checkout.
"""

import os


def build(side, root: str, spec: dict, seed: int):
    """The host Scene of `side` (inputs.side_modules) for the stage."""
    scene = side.scene.Scene()
    path = os.path.join(root, spec["stage"])
    if not side.UsdLoader().load(path, scene):
        raise RuntimeError(f"{side.name}: the stage {path} did not load")
    return scene
