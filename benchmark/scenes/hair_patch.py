"""Hair strands over a ground quad under one distant light: a frozen copy of
the arithmetic of the program's `scene/testscenes.py:hair_patch`.

Configuration: `scene.n_curves`, `scene.ctrl_per_curve` and
`scene.strand_seed`, the generator's own seed. Every run gets the same
strands, in an order its seed draws (`hair_strands`), so the work does not
move with the seed. `populate` fills a Scene of either side from the same
arrays: it takes the side's modules, so the same lines build both.
"""

import numpy as np

import inputs
import shapes

SEED_SALT_STRANDS = 0x5EED0001


def hair_patch_arrays(n_curves: int, ctrl_per_curve: int, rng: np.random.Generator) -> dict:
    """The strands of hair_patch(n_curves, ctrl_per_curve) drawn from `rng`:
    control points [n_curves * ctrl, 3] f32, counts [n_curves] u32 and widths
    [n_curves * ctrl] f32, by the generator's own draws in its own order."""
    pts, widths = [], []
    for _ in range(n_curves):
        x, z = rng.uniform(-1.0, 1.0, 2)
        sway = rng.uniform(-0.3, 0.3, 2)
        h = rng.uniform(0.8, 1.2)
        ys = np.linspace(0.0, h, ctrl_per_curve)
        cx = x + sway[0] * (ys / h) ** 2 + rng.normal(0, 0.02, ctrl_per_curve)
        cz = z + sway[1] * (ys / h) ** 2 + rng.normal(0, 0.02, ctrl_per_curve)
        pts.append(np.stack([cx, ys, cz], axis=1))
        widths.append(np.linspace(0.012, 0.004, ctrl_per_curve))
    return dict(points=np.concatenate(pts).astype(np.float32),
                counts=np.full(n_curves, ctrl_per_curve, np.uint32),
                widths=np.concatenate(widths).astype(np.float32))


def hair_strands(spec: dict, seed: int) -> dict:
    """A configuration's strands: hair_patch's, drawn from its own generator
    (`strand_seed`), in an order the run's seed draws."""
    n, ctrl = int(spec["n_curves"]), int(spec["ctrl_per_curve"])
    arrays = hair_patch_arrays(n, ctrl, np.random.default_rng(int(spec["strand_seed"])))
    order = inputs.rng_for(seed, SEED_SALT_STRANDS).permutation(n)
    return dict(points=arrays["points"].reshape(n, ctrl, 3)[order].reshape(-1, 3),
                counts=arrays["counts"][order],
                widths=arrays["widths"].reshape(n, ctrl)[order].reshape(-1))


def populate(side, arrays: dict):
    """A Scene of `side` holding hair_patch's ground, strands, light and camera around `arrays`."""
    sm = side.scene
    scene = sm.Scene()
    ground = scene.add_material(shapes.diffuse(side, "ground", [0.4, 0.38, 0.35]))
    hair = sm.MaterialDescription(type="mdl", file="OmniHair.mdl", name="OmniHair")
    hair.params = {"reflection_roughness_constant": 0.3}
    hair_id = scene.add_material(hair)
    e = 2.0
    pos, idx, nrm, uv = shapes.quad([-e, 0, e], [e, 0, e], [e, 0, -e], [-e, 0, -e])
    mesh = scene.create_mesh(pos, idx, normals=nrm, uvs=uv)
    scene.create_instance(sm.InstanceType.eMesh, mesh, ground, side.math3d.identity4())
    cid = scene.create_curve(sm.CurveType.eCubic, arrays["counts"], arrays["points"], arrays["widths"])
    scene.create_instance(sm.InstanceType.eCurve, cid, hair_id, side.math3d.identity4())
    scene.create_light(sm.UniformLightDesc(
        type=3, orientation=np.array([-55.0, 30.0, 0.0]), half_angle=np.radians(3.0), intensity=40000.0,
        color=np.array([1.0, 0.97, 0.9])))
    cam = side.Camera(name="Main", fov=40.0, aspect=1.0)
    cam.look_at([2.4, 1.6, 2.4], [0.0, 0.5, 0.0])
    scene.add_camera(cam)
    scene.model_path = "builtin://hair_patch"
    return scene


def build(side, root: str, spec: dict, seed: int):
    return populate(side, hair_strands(spec, seed))
