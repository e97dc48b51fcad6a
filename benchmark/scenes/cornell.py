"""The bench Cornell box: a frozen copy of the arithmetic of the program's
`scene/testscenes.py:cornell_box(light_intensity=5000.0, metal_box=True,
glass_sphere=True)`, the box the program's bench and chip smoke test render.

x in [-1, 1], y in [0, 2], z in [-1, 1]: diffuse walls, the tall box in a
metallic OmniPBR, an OmniGlass sphere of ior 1.5 (the scene's own unit
sphere mesh), one 0.9 x 0.9 rect light of intensity 5000 under the ceiling.
The configuration names the kind alone; the seed changes nothing here.
"""

import numpy as np

import shapes


def build(side, root: str, spec: dict, seed: int):
    """The host Scene of `side` (inputs.side_modules)."""
    sm, m3 = side.scene, side.math3d
    scene = sm.Scene()
    white = scene.add_material(shapes.diffuse(side, "white", [0.73, 0.73, 0.73]))
    red = scene.add_material(shapes.diffuse(side, "red", [0.65, 0.05, 0.05]))
    green = scene.add_material(shapes.diffuse(side, "green", [0.12, 0.45, 0.15]))

    def add_quad(mat, *pts):
        pos, idx, nrm, uv = shapes.quad(*pts)
        mesh = scene.create_mesh(pos, idx, normals=nrm, uvs=uv)
        scene.create_instance(sm.InstanceType.eMesh, mesh, mat, m3.identity4())

    # inward normals: floor +y, ceiling -y, back wall +z, left red +x, right green -x
    add_quad(white, [-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1])
    add_quad(white, [-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1])
    add_quad(white, [-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1])
    add_quad(red, [-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1])
    add_quad(green, [1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1])

    tall = sm.MaterialDescription(type="mdl", file="OmniPBR.mdl", name="metal", has_color=True,
                                  color=[0.8, 0.8, 0.9])
    tall.params = {"metallic_constant": 1.0, "reflection_roughness_constant": 0.15}
    tall_mat = scene.add_material(tall)
    pos, idx, nrm, uv = shapes.box([0, 0, 0], [0.6, 1.2, 0.6])
    mesh = scene.create_mesh(pos, idx, normals=nrm, uvs=uv)
    xf = m3.translate([-0.35, 0.6, -0.35]) @ m3.quat_to_mat4(m3.quat_axis_angle([0, 1, 0], np.radians(18)))
    scene.create_instance(sm.InstanceType.eMesh, mesh, tall_mat, xf)
    pos, idx, nrm, uv = shapes.box([0, 0, 0], [0.6, 0.6, 0.6])
    mesh2 = scene.create_mesh(pos, idx, normals=nrm, uvs=uv)
    xf2 = m3.translate([0.4, 0.3, 0.35]) @ m3.quat_to_mat4(m3.quat_axis_angle([0, 1, 0], np.radians(-15)))
    scene.create_instance(sm.InstanceType.eMesh, mesh2, white, xf2)

    glass = sm.MaterialDescription(type="mdl", file="OmniGlass.mdl", name="glass")
    glass.params = {"ior": 1.5}
    gid = scene.add_material(glass)
    sphere_mesh = scene._get_sphere_light_mesh()  # the scene's unit sphere
    xf = m3.translate([0.4, 0.35, 0.35]) @ m3.scale(0.35)
    scene.create_instance(sm.InstanceType.eMesh, sphere_mesh, gid, xf)

    # the ceiling's rect light emits -y (local -Z to world -Y by euler x = -90)
    scene.create_light(sm.UniformLightDesc(
        type=0, position=np.array([0.0, 1.99, 0.0]), orientation=np.array([-90.0, 0.0, 0.0]),
        color=np.array([1.0, 0.85, 0.7]), intensity=5000.0, width=0.9, height=0.9))
    cam = side.Camera(name="Main", fov=45.0, aspect=1.0)
    cam.set_position([0.0, 1.0, 3.9])
    scene.add_camera(cam)
    scene.model_path = "builtin://cornell_box"
    return scene
