"""The box field: a frozen copy of the arithmetic of the program's
`scene/testscenes.py:box_field(grid, seed)`.

Configuration: `scene.grid` and `scene.field_seed`, the generator's own
seed. A grid x grid field of rotated unit boxes and the scene's unit
spheres (every third cell), scaled and turned by the generator's draws, over
a ground quad, in 8 materials (OmniPBR where k % 3 == 2, else diffuse),
under a distant light and a rect light. No textures. The run's seed changes
nothing here: every run traces the same field.
"""

import numpy as np

import shapes


def build(side, root: str, spec: dict, seed: int):
    """The host Scene of `side` (inputs.side_modules)."""
    sm, m3 = side.scene, side.math3d
    grid = int(spec["grid"])
    rng = np.random.default_rng(int(spec["field_seed"]))
    scene = sm.Scene()
    mats = []
    for k in range(8):
        c = rng.uniform(0.2, 0.9, 3)
        if k % 3 == 2:
            m = sm.MaterialDescription(type="mdl", file="OmniPBR.mdl", name=f"pbr{k}", has_color=True, color=c)
            m.params = {"metallic_constant": float(rng.uniform(0, 1)),
                        "reflection_roughness_constant": float(rng.uniform(0.1, 0.8))}
            mats.append(scene.add_material(m))
        else:
            mats.append(scene.add_material(shapes.diffuse(side, f"diff{k}", c)))

    e = grid * 0.75
    pos, idx, nrm, uv = shapes.quad([-e, 0, e], [e, 0, e], [e, 0, -e], [-e, 0, -e])
    ground = scene.create_mesh(pos, idx, normals=nrm, uvs=uv)
    scene.create_instance(sm.InstanceType.eMesh, ground, mats[0], m3.identity4())

    box_pos, box_idx, box_nrm, box_uv = shapes.box([0, 0, 0], [1, 1, 1])
    box_mesh = scene.create_mesh(box_pos, box_idx, normals=box_nrm, uvs=box_uv)
    sphere_mesh = scene._get_sphere_light_mesh()
    for i in range(grid):
        for j in range(grid):
            x = (i - grid / 2) * 1.5 + rng.uniform(-0.3, 0.3)
            z = (j - grid / 2) * 1.5 + rng.uniform(-0.3, 0.3)
            h = rng.uniform(0.4, 2.5)
            xf = (m3.translate([x, h / 2, z])
                  @ m3.quat_to_mat4(m3.quat_axis_angle([0, 1, 0], rng.uniform(0, np.pi)))
                  @ m3.scale([rng.uniform(0.4, 1.0), h, rng.uniform(0.4, 1.0)]))
            mesh = box_mesh if (i + j) % 3 else sphere_mesh
            scene.create_instance(sm.InstanceType.eMesh, mesh, mats[(i * 7 + j) % len(mats)], xf)

    scene.create_light(sm.UniformLightDesc(
        type=3, orientation=np.array([-50.0, 25.0, 0.0]), half_angle=np.radians(2.0), intensity=60000.0,
        color=np.array([1.0, 0.95, 0.85])))
    scene.create_light(sm.UniformLightDesc(
        type=0, position=np.array([0.0, grid * 0.8, 0.0]), orientation=np.array([-90.0, 0.0, 0.0]),
        color=np.array([0.9, 0.95, 1.0]), intensity=2000.0, width=grid * 0.5, height=grid * 0.5))
    cam = side.Camera(name="Main", fov=50.0, aspect=1.0)
    cam.look_at([grid * 0.7, grid * 0.45, grid * 0.7], [0.0, 1.0, 0.0])
    scene.add_camera(cam)
    scene.model_path = "builtin://box_field"
    return scene
