"""The inputs the benchmark hands to both sides: the scene and the camera's poses.

A configuration file names its scene's builder by `scene.kind`: the module
`scenes/<kind>.py`, found by name, whose `build(side, root, spec, seed)`
returns the host Scene of one side ("program" or "reference") from the
configuration's `scene` entry. A builder takes the side's modules
(`side_modules`), so the same lines build both sides' scenes from the same
file or arrays. The camera runs a closed route about the configuration's
`camera.target` (orbit_pose).
"""

from __future__ import annotations

import importlib.util
import os
import types

import numpy as np

SCENES_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scenes")
SEED_SALT_ORBIT = 0x5EED0002


def rng_for(seed: int, salt: int) -> np.random.Generator:
    """A generator keyed by the run's seed (any non-negative int) and a salt."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFFFFFF, salt])


def side_modules(side: str) -> types.SimpleNamespace:
    """The modules a scene builder takes from one side: its UsdLoader, scene
    module, Camera and math3d (the program's, or the reference's frozen copy)."""
    if side == "program":
        from strelka_tpu_torch.loaders.usd import UsdLoader
        from strelka_tpu_torch.scene import scene
        from strelka_tpu_torch.scene.camera import Camera
        from strelka_tpu_torch.utils import math3d
    elif side == "reference":
        from refport.loaders.usd import UsdLoader
        from refport.scene import scene
        from refport.scene.camera import Camera
        from refport.utils import math3d
    else:
        raise ValueError(f"unknown side {side!r}")
    return types.SimpleNamespace(name=side, UsdLoader=UsdLoader, scene=scene, Camera=Camera, math3d=math3d)


def scene_builder(kind: str, scenes_dir: str = SCENES_DIR):
    """The module `scenes/<kind>.py`."""
    path = os.path.join(scenes_dir, kind + ".py")
    if not os.path.exists(path):
        raise ValueError(f"unknown scene kind {kind!r}: no {path}")
    spec = importlib.util.spec_from_file_location("bench_scene_" + kind.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_scene(side: str, root: str, config: dict, seed: int):
    """The host Scene of `side` ("program" or "reference") for a configuration."""
    spec = config["scene"]
    return scene_builder(spec["kind"]).build(side_modules(side), root, spec, seed)


def orbit_pose(config: dict, seed: int, step: int, stride):
    """(eye, target) of the camera's `step`-th pose. The camera runs a closed
    route of `route_steps` poses about the vertical axis through the
    configuration's target, from -orbit_span_deg to +orbit_span_deg and
    back. With a `stride` the seed picks where on the route step 0 lies, at
    a multiple of it, so that every seed passes the same poses and stops at
    the same set of them, in another order; with None step 0 is the route's
    start for every seed."""
    cam = config["camera"]
    eye0 = np.asarray(cam["eye"], np.float64)
    target = np.asarray(cam["target"], np.float64)
    steps = int(cam["route_steps"])
    offset = 0 if stride is None else stride * int(rng_for(seed, SEED_SALT_ORBIT).integers(0, steps // stride))
    phase = ((offset + step) % steps) / steps
    wave = 4.0 * phase - 1.0 if phase < 0.5 else 3.0 - 4.0 * phase
    angle = np.radians(float(cam["orbit_span_deg"]) * wave)
    c, s = np.cos(angle), np.sin(angle)
    rel = eye0 - target
    eye = target + np.array([c * rel[0] + s * rel[2], rel[1], -s * rel[0] + c * rel[2]])
    return eye, target
