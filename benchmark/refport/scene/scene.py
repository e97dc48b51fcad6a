"""Host-side scene model — port of oka::Scene (include/scene/scene.h:21-487).

Geometry lives in append-only pools (global vertex/index buffers, curve
point/width/count pools); instances reference meshes/curves with a 4x4
transform. Lights are described by UniformLightDesc and packed into the
GPU-layout Light records by update_light (scene.cpp:353-408); creating a
light also instantiates an emissive proxy mesh (scene.cpp:306-351) so camera
and BSDF-sampled rays can hit the emitter.

Unlike the reference we keep vertex attributes UNPACKED as float32 arrays
(positions [N,3], normals [N,3], tangents [N,3], uvs [N,2]) — the 10:10:12 /
16:16 packing (scene.h:80-89) is a GPU bandwidth optimization that TPU HBM
layouts do not benefit from; the packing/unpacking helpers live in
loaders for file-format parity instead.
"""

from __future__ import annotations

import enum
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from refport.scene.camera import Camera
from refport.utils import math3d as m3


class InstanceType(enum.IntEnum):
    eMesh = 0
    eLight = 1
    eCurve = 2


class CurveType(enum.IntEnum):
    eLinear = 0
    eCubic = 1


class AnimationState(enum.IntEnum):
    eStop = 0
    ePlay = 1
    eScroll = 2


@dataclass
class Mesh:
    index: int = 0  # first index in the global index pool
    count: int = 0  # number of indices
    vb_offset: int = 0  # first vertex in the global vertex pool
    vertex_count: int = 0


@dataclass
class Curve:
    vertex_counts_start: int = 0
    vertex_counts_count: int = 0
    points_start: int = 0
    points_count: int = 0
    widths_start: int = -1
    widths_count: int = -1
    type: CurveType = CurveType.eCubic


@dataclass
class Instance:
    transform: np.ndarray = field(default_factory=m3.identity4)
    type: InstanceType = InstanceType.eMesh
    geom_id: int = 0  # mesh id or curve id
    material_id: int = 0
    light_id: int = -1


@dataclass
class MaterialDescription:
    """scene.h:65-78. type: 'mdl' | 'mtlx'. params: name -> python value."""

    type: str = "mdl"
    code: str = ""
    file: str = ""
    name: str = ""
    has_color: bool = False
    color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    params: Dict[str, object] = field(default_factory=dict)


@dataclass
class UniformLightDesc:
    """CPU-side light description (scene.h:158-178)."""

    type: int = 0  # 0 rect, 1 disc, 2 sphere, 3 distant
    xform: np.ndarray = field(default_factory=m3.identity4)
    position: np.ndarray = field(default_factory=lambda: np.zeros(3))
    orientation: np.ndarray = field(default_factory=lambda: np.zeros(3))  # euler degrees
    use_xform: bool = False
    color: np.ndarray = field(default_factory=lambda: np.ones(3))
    intensity: float = 1.0
    width: float = 1.0
    height: float = 1.0
    radius: float = 1.0
    half_angle: float = 0.1


@dataclass
class Light:
    """GPU-layout light record (scene.h:146-155 == include/render/Lights.h:5-14)."""

    points: np.ndarray = field(default_factory=lambda: np.zeros((4, 4), np.float32))
    color: np.ndarray = field(default_factory=lambda: np.ones(4, np.float32))
    normal: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    type: int = 0
    half_angle: float = 0.0


@dataclass
class AnimationSampler:
    interpolation: str = "LINEAR"  # LINEAR | STEP | CUBICSPLINE
    inputs: List[float] = field(default_factory=list)
    outputs_vec4: List[np.ndarray] = field(default_factory=list)


@dataclass
class AnimationChannel:
    path: str = "translation"  # translation | rotation | scale
    node: int = -1
    sampler_index: int = 0


@dataclass
class Animation:
    name: str = ""
    samplers: List[AnimationSampler] = field(default_factory=list)
    channels: List[AnimationChannel] = field(default_factory=list)
    start: float = float("inf")
    end: float = float("-inf")


@dataclass
class Node:
    name: str = ""
    translation: np.ndarray = field(default_factory=lambda: np.zeros(3))
    scale: np.ndarray = field(default_factory=lambda: np.ones(3))
    rotation: np.ndarray = field(default_factory=lambda: np.array([1.0, 0.0, 0.0, 0.0]))
    parent: int = -1
    children: List[int] = field(default_factory=list)


class Scene:
    """Append-only geometry pools + instances + lights + cameras."""

    def __init__(self) -> None:
        # vertex pool (unpacked SoA)
        self.positions: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.tangents: List[np.ndarray] = []
        self.uvs: List[np.ndarray] = []
        self.indices: List[np.ndarray] = []
        self._vb_size = 0
        self._ib_size = 0

        self.meshes: List[Mesh] = []
        self.curves: List[Curve] = []
        self.instances: List[Instance] = []
        self.lights: List[Light] = []
        self.light_descs: List[UniformLightDesc] = []
        self.light_id_to_instance_id: Dict[int, int] = {}
        self.materials: List[MaterialDescription] = []

        self.curve_points: List[np.ndarray] = []
        self.curve_widths: List[np.ndarray] = []
        self.curve_vertex_counts: List[np.ndarray] = []
        self._curve_points_size = 0
        self._curve_widths_size = 0
        self._curve_counts_size = 0

        self.nodes: List[Node] = []
        self.animations: List[Animation] = []
        self.anim_state = AnimationState.eStop

        self.cameras: List[Camera] = []
        self._name_to_camera: Dict[str, int] = {}

        self.model_path: str = ""

        self._rect_light_mesh_id = -1
        self._disc_light_mesh_id = -1
        self._sphere_light_mesh_id = -1
        self._del_instances: List[int] = []
        self._del_meshes: List[int] = []
        self._del_materials: List[int] = []
        self._dirty_instances: set = set()
        self._fr_mod = False
        self.dirty = True

    # ------------------------------------------------------------------ geometry

    def create_mesh(self, positions, indices, normals=None, uvs=None, tangents=None) -> int:
        """scene.cpp:15-48 (free-list reuse omitted: ids are stable appends)."""
        positions = np.asarray(positions, np.float32).reshape(-1, 3)
        indices = np.asarray(indices, np.uint32).reshape(-1)
        n = positions.shape[0]
        if normals is None:
            normals = _smooth_normals(positions, indices)
        if uvs is None:
            uvs = np.zeros((n, 2), np.float32)
        if tangents is None:
            tangents = _default_tangents(np.asarray(normals, np.float32))
        mesh = Mesh(
            index=self._ib_size, count=len(indices), vb_offset=self._vb_size, vertex_count=n
        )
        mesh_id = len(self.meshes)
        self.meshes.append(mesh)
        self.positions.append(positions)
        self.normals.append(np.asarray(normals, np.float32).reshape(-1, 3))
        self.tangents.append(np.asarray(tangents, np.float32).reshape(-1, 3))
        self.uvs.append(np.asarray(uvs, np.float32).reshape(-1, 2))
        self.indices.append(indices)
        self._vb_size += n
        self._ib_size += len(indices)
        self.dirty = True
        return mesh_id

    def create_curve(self, type: CurveType, vertex_counts, points, widths=None) -> int:
        """scene.cpp:463-489."""
        points = np.asarray(points, np.float32).reshape(-1, 3)
        vertex_counts = np.asarray(vertex_counts, np.uint32).reshape(-1)
        c = Curve(
            type=type,
            points_start=self._curve_points_size,
            points_count=len(points),
            vertex_counts_start=self._curve_counts_size,
            vertex_counts_count=len(vertex_counts),
        )
        self.curve_points.append(points)
        self.curve_vertex_counts.append(vertex_counts)
        self._curve_points_size += len(points)
        self._curve_counts_size += len(vertex_counts)
        if widths is not None and len(widths) > 0:
            widths = np.asarray(widths, np.float32).reshape(-1)
            c.widths_start = self._curve_widths_size
            c.widths_count = len(widths)
            self.curve_widths.append(widths)
            self._curve_widths_size += len(widths)
        curve_id = len(self.curves)
        self.curves.append(c)
        self.dirty = True
        return curve_id

    def create_instance(
        self, type: InstanceType, geom_id: int, material_id: int, transform, light_id: int = -1
    ) -> int:
        """scene.cpp:50-88."""
        inst = Instance(
            transform=np.asarray(transform, np.float64).reshape(4, 4),
            type=InstanceType(type),
            geom_id=geom_id,
            material_id=material_id,
            light_id=light_id,
        )
        inst_id = len(self.instances)
        self.instances.append(inst)
        self.dirty = True
        return inst_id

    def update_instance_transform(self, inst_id: int, transform) -> None:
        """scene.cpp:445-450 (marks the instance dirty for re-bake)."""
        self.instances[inst_id].transform = np.asarray(transform, np.float64).reshape(4, 4)
        self._dirty_instances.add(inst_id)
        self.dirty = True

    # -- removal free-lists (scene.cpp:410-423; ids are reused on next create)
    def remove_instance(self, inst_id: int) -> None:
        # mark removed: zero-scale transform excludes it from the next bake
        self.instances[inst_id].transform = np.zeros((4, 4))
        self.instances[inst_id].light_id = -1
        self._del_instances.append(inst_id)
        self.dirty = True

    def remove_mesh(self, mesh_id: int) -> None:
        self._del_meshes.append(mesh_id)
        self.dirty = True

    def remove_material(self, material_id: int) -> None:
        self._del_materials.append(material_id)
        self.dirty = True

    # -- frame dirty-tracking (scene.cpp:435-461)
    def get_dirty_instances(self):
        return set(self._dirty_instances)

    def begin_frame(self) -> None:
        self._fr_mod = True
        self._dirty_instances.clear()

    def end_frame(self) -> None:
        self._fr_mod = False

    def get_fr_mod(self) -> bool:
        return self._fr_mod

    def add_material(self, material: MaterialDescription) -> int:
        self.materials.append(material)
        self.dirty = True
        return len(self.materials) - 1

    # ------------------------------------------------------------------ lights

    def get_transform(self, desc: UniformLightDesc) -> np.ndarray:
        """T * R(euler degrees) * S — scale matched to the light type.

        DELIBERATE deviation from the reference: scene.h:337-348 always
        scales by (width, height, 1), so disc/sphere lights built without
        use_xform get a radius-1 emissive proxy regardless of desc.radius
        (latent upstream because UsdLux lights always take the useXform
        branch, scene.cpp:344). A radius-0.25 sphere light then renders as
        a radius-1 glowing ball and BSDF-sampled hits overcount direct
        light ~1/r^2 (caught by test_radiometric_oracle.py)."""
        t = m3.translate(desc.position)
        r = m3.quat_to_mat4(m3.quat_from_euler(np.radians(desc.orientation)))
        if desc.type in (1, 2):  # disc / sphere proxies are unit-radius
            s = m3.scale(desc.radius)
        else:
            s = m3.scale([desc.width, desc.height, 1.0])
        return t @ r @ s

    def create_light(self, desc: UniformLightDesc) -> int:
        """scene.cpp:306-351: pack GPU record + lazy emissive proxy mesh."""
        light_id = len(self.lights)
        self.lights.append(Light())
        self.light_descs.append(desc)
        self.update_light(light_id, desc)

        if desc.type == 0:
            mesh_id = self._get_rect_light_mesh()
            scale_m = m3.scale([desc.width, desc.height, 1.0])
        elif desc.type == 1:
            mesh_id = self._get_disc_light_mesh()
            scale_m = m3.scale(desc.radius)
        elif desc.type == 2:
            mesh_id = self._get_sphere_light_mesh()
            scale_m = m3.scale(desc.radius)
        else:  # distant: no proxy geometry
            self.light_id_to_instance_id[light_id] = -1
            return light_id

        transform = (desc.xform @ scale_m) if desc.use_xform else self.get_transform(desc)
        inst_id = self.create_instance(InstanceType.eLight, mesh_id, -1, transform, light_id)
        self.light_id_to_instance_id[light_id] = inst_id
        return light_id

    def update_light(self, light_id: int, desc: UniformLightDesc) -> None:
        """Exact packing of scene.cpp:353-408."""
        light = self.lights[light_id]
        if desc.type == 0:  # rect: 4 world-space corners
            scale_m = m3.scale([desc.width, desc.height, 1.0])
            xf = (desc.xform @ scale_m) if desc.use_xform else self.get_transform(desc)
            corners = np.array(
                [[0.5, 0.5, 0.0], [-0.5, 0.5, 0.0], [-0.5, -0.5, 0.0], [0.5, -0.5, 0.0]]
            )
            pts = m3.transform_points(xf, corners)
            light.points = np.concatenate([pts, np.ones((4, 1))], axis=1).astype(np.float32)
            light.type = 0
        elif desc.type == 1:  # disc: radius, origin, OX, OY; normal = +Z
            scale_m = m3.scale(desc.radius)
            xf = (desc.xform @ scale_m) if desc.use_xform else self.get_transform(desc)
            light.points = np.zeros((4, 4), np.float32)
            light.points[0, 0] = desc.radius
            light.points[1, :3] = m3.transform_points(xf, np.zeros((1, 3)))[0]
            light.points[1, 3] = 1.0
            light.points[2, :3] = m3.transform_vectors(xf, np.array([[1.0, 0.0, 0.0]]))[0]
            light.points[3, :3] = m3.transform_vectors(xf, np.array([[0.0, 1.0, 0.0]]))[0]
            n = m3.transform_vectors(xf, np.array([[0.0, 0.0, 1.0]]))[0]
            light.normal = np.array([*n, 0.0], np.float32)
            light.type = 1
        elif desc.type == 2:  # sphere: radius + origin
            # NOTE reference quirk: use_xform branch applies scale*xform
            xf = desc.xform if desc.use_xform else self.get_transform(desc)
            light.points = np.zeros((4, 4), np.float32)
            light.points[0, 0] = desc.radius
            light.points[1, :3] = m3.transform_points(xf, np.zeros((1, 3)))[0]
            light.points[1, 3] = 1.0
            light.type = 2
        elif desc.type == 3:  # distant: -Z direction + half angle
            xf = desc.xform if desc.use_xform else self.get_transform(desc)
            n = m3.transform_vectors(xf, np.array([[0.0, 0.0, -1.0]]))[0]
            n = n / np.linalg.norm(n)
            light.normal = np.array([*n, 0.0], np.float32)
            light.half_angle = desc.half_angle
            light.type = 3
        light.color = np.array([*(np.asarray(desc.color) * desc.intensity), desc.intensity], np.float32)
        self.dirty = True

    # light proxy meshes (scene.cpp:119-250)
    def _get_rect_light_mesh(self) -> int:
        if self._rect_light_mesh_id == -1:
            pos = np.array(
                [[0.5, 0.5, 0.0], [-0.5, 0.5, 0.0], [-0.5, -0.5, 0.0], [0.5, -0.5, 0.0]], np.float32
            )
            nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (4, 1))
            idx = np.array([0, 1, 2, 2, 3, 0], np.uint32)
            self._rect_light_mesh_id = self.create_mesh(pos, idx, normals=nrm)
        return self._rect_light_mesh_id

    def _get_disc_light_mesh(self) -> int:
        if self._disc_light_mesh_id == -1:
            verts = [[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]]
            idx: List[int] = []
            angle = 0.0
            step = 2.0 * np.pi / 16
            for _ in range(16):
                idx += [0, len(verts) - 1]
                angle += step
                verts.append([np.cos(angle), np.sin(angle), 0.0])
                idx.append(len(verts) - 1)
            pos = np.asarray(verts, np.float32)
            nrm = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (len(verts), 1))
            self._disc_light_mesh_id = self.create_mesh(pos, np.asarray(idx, np.uint32), normals=nrm)
        return self._disc_light_mesh_id

    def _get_sphere_light_mesh(self) -> int:
        if self._sphere_light_mesh_id == -1:
            segments = rings = 16
            verts, norms = [], []
            for i in range(rings + 1):
                theta = i * np.pi / rings
                for j in range(segments + 1):
                    phi = j * 2.0 * np.pi / segments
                    d = [np.cos(phi) * np.sin(theta), np.cos(theta), np.sin(phi) * np.sin(theta)]
                    verts.append(d)
                    norms.append(d)
            idx: List[int] = []
            for i in range(rings):
                for j in range(segments):
                    p0 = i * (segments + 1) + j
                    p1, p2 = p0 + 1, (i + 1) * (segments + 1) + j
                    p3 = p2 + 1
                    idx += [p0, p1, p2, p2, p1, p3]
            self._sphere_light_mesh_id = self.create_mesh(
                np.asarray(verts, np.float32), np.asarray(idx, np.uint32), normals=np.asarray(norms, np.float32)
            )
        return self._sphere_light_mesh_id

    # ------------------------------------------------------------------ cameras

    def add_camera(self, camera: Camera) -> int:
        self.cameras.append(camera)
        self._name_to_camera[camera.name] = len(self.cameras) - 1
        return len(self.cameras) - 1

    def update_camera(self, camera: Camera, index: int) -> None:
        self.cameras[index] = camera

    def get_camera(self, index: int) -> Camera:
        if not self.cameras:
            cam = Camera(name="default")
            cam.set_position([0.0, 0.0, -10.0])
            self.add_camera(cam)
        return self.cameras[index]

    def find_camera_by_name(self, name: str) -> int:
        return self._name_to_camera.get(name, -1)

    def update_cameras_params(self, width: int, height: int) -> None:
        for cam in self.cameras:
            cam.update_aspect_ratio(width / height)

    # ------------------------------------------------------------------ nodes & animation

    def get_transform_from_node(self, node_idx: int) -> np.ndarray:
        """scene.h:370-381: compose local T*R*S transforms up to the root."""
        xform = m3.identity4()
        while node_idx != -1:
            n = self.nodes[node_idx]
            xform = m3.compose_trs(n.translation, n.rotation, n.scale) @ xform
            node_idx = n.parent
        return xform

    def update_animation(self, time: float) -> None:
        """Keyframe evaluation (scene.cpp:252-304)."""
        if not self.animations:
            return
        animation = self.animations[0]
        for channel in animation.channels:
            sampler = animation.samplers[channel.sampler_index]
            if len(sampler.inputs) > len(sampler.outputs_vec4):
                continue
            for i in range(len(sampler.inputs) - 1):
                t0, t1 = sampler.inputs[i], sampler.inputs[i + 1]
                if not (t0 <= time <= t1):
                    continue
                u = max(0.0, time - t0) / (t1 - t0)
                if u > 1.0:
                    continue
                o0 = np.asarray(sampler.outputs_vec4[i], np.float64)
                o1 = np.asarray(sampler.outputs_vec4[i + 1], np.float64)
                node = self.nodes[channel.node]
                if channel.path == "translation":
                    node.translation = (1 - u) * o0[:3] + u * o1[:3]
                elif channel.path == "scale":
                    node.scale = (1 - u) * o0[:3] + u * o1[:3]
                elif channel.path == "rotation":
                    q0 = np.array([o0[3], o0[0], o0[1], o0[2]])
                    q1 = np.array([o1[3], o1[0], o1[1], o1[2]])
                    node.rotation = m3.quat_slerp(q0, q1, u)
        # re-derive the camera from its (possibly animated) node — the
        # reference ends updateAnimation with
        # mCameras[0].matrices.view = getTransform(mCameras[0].node)
        # (scene.cpp:303); same decompose as the glTF camera-node path
        if self.cameras:
            cam = self.cameras[0]
            node_idx = getattr(cam, "node", -1)
            if 0 <= node_idx < len(self.nodes):
                xf = self.get_transform_from_node(node_idx)
                rot = xf[:3, :3].copy()
                sc = np.linalg.norm(rot, axis=0)
                rot = rot / np.maximum(sc, 1e-20)
                cam.position = xf[:3, 3] * sc
                cam.orientation = m3.quat_conjugate(m3.quat_from_mat3(rot))
                cam.update_view_matrix()
        self.dirty = True

    # ------------------------------------------------------------------ misc

    def get_scene_file_name(self) -> str:
        return os.path.basename(self.model_path)

    def get_scene_dir(self) -> str:
        return os.path.dirname(self.model_path)

    # concatenated pools
    def vertex_pools(self):
        if self._vb_size == 0:
            z3 = np.zeros((0, 3), np.float32)
            return z3, z3.copy(), z3.copy(), np.zeros((0, 2), np.float32), np.zeros(0, np.uint32)
        return (
            np.concatenate(self.positions),
            np.concatenate(self.normals),
            np.concatenate(self.tangents),
            np.concatenate(self.uvs),
            np.concatenate(self.indices),
        )


def _smooth_normals(positions: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals (fallback when the source has none)."""
    normals = np.zeros_like(positions, dtype=np.float64)
    tri = indices.reshape(-1, 3).astype(np.int64)
    p0, p1, p2 = positions[tri[:, 0]], positions[tri[:, 1]], positions[tri[:, 2]]
    face_n = np.cross(p1 - p0, p2 - p0)
    for k in range(3):
        np.add.at(normals, tri[:, k], face_n)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    normals = np.where(lens > 1e-12, normals / np.maximum(lens, 1e-12), [0.0, 0.0, 1.0])
    return normals.astype(np.float32)


def _default_tangents(normals: np.ndarray) -> np.ndarray:
    """Arbitrary orthogonal tangents (createCoordinateSystem, Lights.h:291-300)."""
    n = normals.astype(np.float64)
    use_x = np.abs(n[:, 0]) > np.abs(n[:, 1])
    inv_len_x = 1.0 / np.sqrt(n[:, 0] ** 2 + n[:, 2] ** 2 + 1e-20)
    tx = np.stack([-n[:, 2] * inv_len_x, np.zeros(len(n)), n[:, 0] * inv_len_x], axis=1)
    inv_len_y = 1.0 / np.sqrt(n[:, 1] ** 2 + n[:, 2] ** 2 + 1e-20)
    ty = np.stack([np.zeros(len(n)), n[:, 2] * inv_len_y, -n[:, 1] * inv_len_y], axis=1)
    return np.where(use_x[:, None], tx, ty).astype(np.float32)
