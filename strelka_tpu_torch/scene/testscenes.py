"""Built-in analytic test scenes (Cornell box & friends).

The reference validates visually against checked-in renders (images/); these
scenes are our deterministic equivalents for golden tests and benchmarks.
"""

from __future__ import annotations

import numpy as np

from strelka_tpu_torch.scene.camera import Camera
from strelka_tpu_torch.scene.scene import (
    InstanceType,
    MaterialDescription,
    Scene,
    UniformLightDesc,
)
from strelka_tpu_torch.utils import math3d as m3


def _quad(p0, p1, p2, p3):
    """Two triangles for corners given CCW (normal = right-hand rule)."""
    pos = np.array([p0, p1, p2, p3], np.float32)
    idx = np.array([0, 1, 2, 0, 2, 3], np.uint32)
    n = np.cross(pos[1] - pos[0], pos[2] - pos[0])
    n = n / np.linalg.norm(n)
    normals = np.tile(n[None, :], (4, 1)).astype(np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    return pos, idx, normals, uvs


def _box(center, size):
    """Axis-aligned box as 12 triangles with outward normals."""
    c = np.asarray(center, np.float64)
    h = np.asarray(size, np.float64) / 2
    # 6 faces
    faces = []
    x, y, z = h
    # +x, -x, +y, -y, +z, -z
    quads = [
        ([x, -y, -z], [x, y, -z], [x, y, z], [x, -y, z]),
        ([-x, -y, z], [-x, y, z], [-x, y, -z], [-x, -y, -z]),
        ([-x, y, -z], [-x, y, z], [x, y, z], [x, y, -z]),
        ([-x, -y, z], [-x, -y, -z], [x, -y, -z], [x, -y, z]),
        ([-x, -y, z], [x, -y, z], [x, y, z], [-x, y, z]),
        ([x, -y, -z], [-x, -y, -z], [-x, y, -z], [x, y, -z]),
    ]
    all_pos, all_idx, all_n, all_uv = [], [], [], []
    ofs = 0
    for q in quads:
        pos, idx, nrm, uv = _quad(*[np.asarray(p) + c for p in q])
        all_pos.append(pos)
        all_idx.append(idx + ofs)
        all_n.append(nrm)
        all_uv.append(uv)
        ofs += 4
    return (
        np.concatenate(all_pos),
        np.concatenate(all_idx),
        np.concatenate(all_n),
        np.concatenate(all_uv),
    )


def _diffuse_material(name: str, color) -> MaterialDescription:
    return MaterialDescription(
        type="mdl",
        file="default.mdl",
        name=name,
        has_color=True,
        color=np.asarray(color, np.float32),
    )


def cornell_box(
    light_intensity: float = 5000.0,  # matched to the default photographic exposure
    with_boxes: bool = True,
    glass_sphere: bool = False,
    metal_box: bool = False,
) -> Scene:
    """Classic Cornell box: x in [-1,1], y in [0,2], z in [-1,1].

    Camera at (0, 1, 3.9) looking down -z; rect light at the ceiling
    emitting -y (reference light convention: emits along local -Z,
    Lights.h:54-64, so the light xform rotates +Z to world +Y).
    """
    scene = Scene()
    white = scene.add_material(_diffuse_material("white", [0.73, 0.73, 0.73]))
    red = scene.add_material(_diffuse_material("red", [0.65, 0.05, 0.05]))
    green = scene.add_material(_diffuse_material("green", [0.12, 0.45, 0.15]))

    def add_quad(mat, *pts):
        pos, idx, nrm, uv = _quad(*pts)
        mesh = scene.create_mesh(pos, idx, normals=nrm, uvs=uv)
        scene.create_instance(InstanceType.eMesh, mesh, mat, m3.identity4())

    # inward normals: floor +y, ceiling -y, back wall +z, left red +x, right green -x
    add_quad(white, [-1, 0, 1], [1, 0, 1], [1, 0, -1], [-1, 0, -1])
    add_quad(white, [-1, 2, -1], [1, 2, -1], [1, 2, 1], [-1, 2, 1])
    add_quad(white, [-1, 0, -1], [1, 0, -1], [1, 2, -1], [-1, 2, -1])
    add_quad(red, [-1, 0, 1], [-1, 0, -1], [-1, 2, -1], [-1, 2, 1])
    add_quad(green, [1, 0, -1], [1, 0, 1], [1, 2, 1], [1, 2, -1])

    if with_boxes:
        tall_mat = white
        if metal_box:
            tall = MaterialDescription(
                type="mdl", file="OmniPBR.mdl", name="metal", has_color=True, color=[0.8, 0.8, 0.9]
            )
            tall.params = {"metallic_constant": 1.0, "reflection_roughness_constant": 0.15}
            tall_mat = scene.add_material(tall)
        pos, idx, nrm, uv = _box([0, 0, 0], [0.6, 1.2, 0.6])
        mesh = scene.create_mesh(pos, idx, normals=nrm, uvs=uv)
        xf = m3.translate([-0.35, 0.6, -0.35]) @ m3.quat_to_mat4(
            m3.quat_axis_angle([0, 1, 0], np.radians(18))
        )
        scene.create_instance(InstanceType.eMesh, mesh, tall_mat, xf)
        pos, idx, nrm, uv = _box([0, 0, 0], [0.6, 0.6, 0.6])
        mesh2 = scene.create_mesh(pos, idx, normals=nrm, uvs=uv)
        xf2 = m3.translate([0.4, 0.3, 0.35]) @ m3.quat_to_mat4(
            m3.quat_axis_angle([0, 1, 0], np.radians(-15))
        )
        scene.create_instance(InstanceType.eMesh, mesh2, white, xf2)

    if glass_sphere:
        glass = MaterialDescription(type="mdl", file="OmniGlass.mdl", name="glass")
        glass.params = {"ior": 1.5}
        gid = scene.add_material(glass)
        sphere_mesh = scene._get_sphere_light_mesh()  # reuse unit sphere geometry
        xf = m3.translate([0.4, 0.35, 0.35]) @ m3.scale(0.35)
        scene.create_instance(InstanceType.eMesh, sphere_mesh, gid, xf)

    # ceiling rect light, emits -y (local -Z -> world -Y via euler x=-90)
    scene.create_light(
        UniformLightDesc(
            type=0,
            position=np.array([0.0, 1.99, 0.0]),
            orientation=np.array([-90.0, 0.0, 0.0]),
            color=np.array([1.0, 0.85, 0.7]),
            intensity=light_intensity,
            width=0.9,
            height=0.9,
        )
    )

    cam = Camera(name="Main", fov=45.0, aspect=1.0)
    cam.set_position([0.0, 1.0, 3.9])
    scene.add_camera(cam)
    scene.model_path = "builtin://cornell_box"
    return scene


def box_field(grid: int = 24, seed: int = 7) -> Scene:
    """Kitchen-Set-class stress scene: a grid^2 field of rotated boxes +
    spheres (~grid^2 * 50 triangles) under a distant light + area light.

    grid=24 -> ~38k tris; grid=48 -> ~150k tris.
    """
    rng = np.random.default_rng(seed)
    scene = Scene()
    mats = []
    for k in range(8):
        c = rng.uniform(0.2, 0.9, 3)
        if k % 3 == 2:
            m = MaterialDescription(type="mdl", file="OmniPBR.mdl", name=f"pbr{k}", has_color=True, color=c)
            m.params = {
                "metallic_constant": float(rng.uniform(0, 1)),
                "reflection_roughness_constant": float(rng.uniform(0.1, 0.8)),
            }
            mats.append(scene.add_material(m))
        else:
            mats.append(scene.add_material(_diffuse_material(f"diff{k}", c)))

    # ground
    e = grid * 0.75
    pos, idx, nrm, uv = _quad([-e, 0, e], [e, 0, e], [e, 0, -e], [-e, 0, -e])
    ground = scene.create_mesh(pos, idx, normals=nrm, uvs=uv)
    scene.create_instance(InstanceType.eMesh, ground, mats[0], m3.identity4())

    box_pos, box_idx, box_nrm, box_uv = _box([0, 0, 0], [1, 1, 1])
    box_mesh = scene.create_mesh(box_pos, box_idx, normals=box_nrm, uvs=box_uv)
    sphere_mesh = scene._get_sphere_light_mesh()
    for i in range(grid):
        for j in range(grid):
            x = (i - grid / 2) * 1.5 + rng.uniform(-0.3, 0.3)
            z = (j - grid / 2) * 1.5 + rng.uniform(-0.3, 0.3)
            h = rng.uniform(0.4, 2.5)
            xf = (
                m3.translate([x, h / 2, z])
                @ m3.quat_to_mat4(m3.quat_axis_angle([0, 1, 0], rng.uniform(0, np.pi)))
                @ m3.scale([rng.uniform(0.4, 1.0), h, rng.uniform(0.4, 1.0)])
            )
            mesh = box_mesh if (i + j) % 3 else sphere_mesh
            scene.create_instance(InstanceType.eMesh, mesh, mats[(i * 7 + j) % len(mats)], xf)

    scene.create_light(
        UniformLightDesc(
            type=3,
            orientation=np.array([-50.0, 25.0, 0.0]),
            half_angle=np.radians(2.0),
            intensity=60000.0,
            color=np.array([1.0, 0.95, 0.85]),
        )
    )
    scene.create_light(
        UniformLightDesc(
            type=0,
            position=np.array([0.0, grid * 0.8, 0.0]),
            orientation=np.array([-90.0, 0.0, 0.0]),
            color=np.array([0.9, 0.95, 1.0]),
            intensity=2000.0,
            width=grid * 0.5,
            height=grid * 0.5,
        )
    )
    cam = Camera(name="Main", fov=50.0, aspect=1.0)
    cam.look_at([grid * 0.7, grid * 0.45, grid * 0.7], [0.0, 1.0, 0.0])
    scene.add_camera(cam)
    scene.model_path = "builtin://box_field"
    return scene


def furnace_scene(albedo: float = 1.0, radius: float = 1.0) -> Scene:
    """White furnace: a diffuse sphere in a uniform environment is invisible.

    Used by BSDF energy-conservation tests (bg acts as the uniform emitter).
    """
    scene = Scene()
    mat = scene.add_material(_diffuse_material("furnace", [albedo] * 3))
    sphere = scene._get_sphere_light_mesh()
    scene.create_instance(InstanceType.eMesh, sphere, mat, m3.scale(radius))
    cam = Camera(name="Main", fov=45.0, aspect=1.0)
    cam.set_position([0.0, 0.0, 4.0])
    scene.add_camera(cam)
    return scene


def hair_patch(n_curves: int = 256, ctrl_per_curve: int = 8, seed: int = 3) -> Scene:
    """Curve/hair stress scene: a patch of wavy cubic B-spline hairs over a
    diffuse ground plane under a distant light (hairmat/einar-class shape,
    BASELINE config 3). n_curves=256 -> ~1280 cubic segments; 10k+ for the
    scale benchmark."""
    from strelka_tpu_torch.scene.scene import CurveType

    rng = np.random.default_rng(seed)
    scene = Scene()
    ground = scene.add_material(_diffuse_material("ground", [0.4, 0.38, 0.35]))
    hair = MaterialDescription(type="mdl", file="OmniHair.mdl", name="OmniHair")
    hair.params = {"reflection_roughness_constant": 0.3}
    hair_id = scene.add_material(hair)

    e = 2.0
    pos, idx, nrm, uv = _quad([-e, 0, e], [e, 0, e], [e, 0, -e], [-e, 0, -e])
    mesh = scene.create_mesh(pos, idx, normals=nrm, uvs=uv)
    scene.create_instance(InstanceType.eMesh, mesh, ground, m3.identity4())

    pts = []
    counts = []
    widths = []
    for _ in range(n_curves):
        x, z = rng.uniform(-1.0, 1.0, 2)
        sway = rng.uniform(-0.3, 0.3, 2)
        h = rng.uniform(0.8, 1.2)
        ys = np.linspace(0.0, h, ctrl_per_curve)
        cx = x + sway[0] * (ys / h) ** 2 + rng.normal(0, 0.02, ctrl_per_curve)
        cz = z + sway[1] * (ys / h) ** 2 + rng.normal(0, 0.02, ctrl_per_curve)
        pts.append(np.stack([cx, ys, cz], axis=1))
        counts.append(ctrl_per_curve)
        widths.append(np.linspace(0.012, 0.004, ctrl_per_curve))
    cid = scene.create_curve(
        CurveType.eCubic,
        np.asarray(counts, np.uint32),
        np.concatenate(pts).astype(np.float32),
        np.concatenate(widths).astype(np.float32),
    )
    scene.create_instance(InstanceType.eCurve, cid, hair_id, m3.identity4())

    scene.create_light(
        UniformLightDesc(
            type=3,
            orientation=np.array([-55.0, 30.0, 0.0]),
            half_angle=np.radians(3.0),
            intensity=40000.0,
            color=np.array([1.0, 0.97, 0.9]),
        )
    )
    cam = Camera(name="Main", fov=40.0, aspect=1.0)
    cam.look_at([2.4, 1.6, 2.4], [0.0, 0.5, 0.0])
    scene.add_camera(cam)
    scene.model_path = "builtin://hair_patch"
    return scene
