"""glTF 2.0 scene loader — port of src/sceneloader/gltfloader.cpp semantics.

Self-contained parser (.gltf JSON + external/bin/data-URI buffers, and .glb
binary container) — the environment has no tinygltf/pygltflib. Behavior
parity (gltfloader.cpp:637-689):

  * materials: alphaMode OPAQUE -> OmniPBR descriptor (diffuse color/
    roughness/metallic + diffuse/normal textures), else OmniGlass (:304-421)
  * lights: `<scene>_light.json` sidecar of rect lights, else a default
    distant light (orientation (-45,15,0), halfAngle 5 deg, intensity 1e5)
  * cameras: perspective yfov/znear/zfar; default camera when none
  * nodes: TRS or matrix; camera nodes decompose the global transform and
    conjugate the rotation (:281-295)
  * animations: linear keyframe samplers for T/R/S channels

Copied from the JAX package (strelka_tpu/loaders/gltf.py); stdlib and numpy only.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import List, Optional

import numpy as np

from strelka_tpu_torch import log
from strelka_tpu_torch.scene.camera import Camera
from strelka_tpu_torch.scene.scene import (
    Animation,
    AnimationChannel,
    AnimationSampler,
    InstanceType,
    MaterialDescription,
    Node,
    Scene,
    UniformLightDesc,
)
from strelka_tpu_torch.utils import math3d as m3
from strelka_tpu_torch.utils import profiling as P

_COMPONENT_DTYPE = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNT = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


class _Gltf:
    """Parsed glTF document + raw buffer blobs."""

    def __init__(self, doc: dict, buffers: List[bytes], base_dir: str):
        self.doc = doc
        self.buffers = buffers
        self.base_dir = base_dir

    def accessor(self, index: int) -> np.ndarray:
        """Decode an accessor to [count, components] (or [count] for SCALAR)."""
        acc = self.doc["accessors"][index]
        count = acc["count"]
        ncomp = _TYPE_COUNT[acc["type"]]
        dtype = _COMPONENT_DTYPE[acc["componentType"]]
        itemsize = np.dtype(dtype).itemsize
        if "bufferView" not in acc:
            data = np.zeros((count, ncomp), dtype)
        else:
            bv = self.doc["bufferViews"][acc["bufferView"]]
            buf = self.buffers[bv["buffer"]]
            offset = bv.get("byteOffset", 0) + acc.get("byteOffset", 0)
            stride = bv.get("byteStride", 0) or ncomp * itemsize
            if stride == ncomp * itemsize:
                data = np.frombuffer(buf, dtype, count * ncomp, offset).reshape(count, ncomp)
            else:
                raw = np.frombuffer(buf, np.uint8, count * stride, offset).reshape(count, stride)
                data = raw[:, : ncomp * itemsize].copy().view(dtype).reshape(count, ncomp)
        if acc.get("sparse"):
            data = self._apply_sparse(acc, data.copy())
        return data[:, 0] if ncomp == 1 else data

    def _apply_sparse(self, acc: dict, data: np.ndarray) -> np.ndarray:
        sp = acc["sparse"]
        n = sp["count"]
        idx_info = sp["indices"]
        bv = self.doc["bufferViews"][idx_info["bufferView"]]
        idx_dtype = _COMPONENT_DTYPE[idx_info["componentType"]]
        offset = bv.get("byteOffset", 0) + idx_info.get("byteOffset", 0)
        idx = np.frombuffer(self.buffers[bv["buffer"]], idx_dtype, n, offset)
        val_info = sp["values"]
        bv = self.doc["bufferViews"][val_info["bufferView"]]
        ncomp = _TYPE_COUNT[acc["type"]]
        dtype = _COMPONENT_DTYPE[acc["componentType"]]
        offset = bv.get("byteOffset", 0) + val_info.get("byteOffset", 0)
        vals = np.frombuffer(self.buffers[bv["buffer"]], dtype, n * ncomp, offset).reshape(n, ncomp)
        data[idx] = vals
        return data


def _load_buffer(uri: Optional[str], base_dir: str, glb_chunk: Optional[bytes]) -> bytes:
    if uri is None:
        assert glb_chunk is not None, "buffer without uri requires GLB binary chunk"
        return glb_chunk
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    path = os.path.join(base_dir, uri)
    with open(path, "rb") as f:
        return f.read()


def _parse_file(path: str) -> _Gltf:
    base_dir = os.path.dirname(os.path.abspath(path))
    glb_chunk = None
    if path.lower().endswith(".glb"):
        with open(path, "rb") as f:
            magic, version, _length = struct.unpack("<III", f.read(12))
            assert magic == 0x46546C67, "not a GLB file"
            doc = None
            while True:
                header = f.read(8)
                if len(header) < 8:
                    break
                chunk_len, chunk_type = struct.unpack("<II", header)
                chunk = f.read(chunk_len)
                if chunk_type == 0x4E4F534A:  # JSON
                    doc = json.loads(chunk.decode("utf-8"))
                elif chunk_type == 0x004E4942:  # BIN
                    glb_chunk = chunk
        assert doc is not None
    else:
        with open(path, "r", encoding="utf-8") as f:
            doc = json.load(f)
    buffers = [_load_buffer(b.get("uri"), base_dir, glb_chunk) for b in doc.get("buffers", [])]
    return _Gltf(doc, buffers, base_dir)


# ---------------------------------------------------------------------------


def _convert_to_omni_pbr(doc: dict, material: dict) -> MaterialDescription:
    """gltfloader.cpp:304-356."""
    pbr = material.get("pbrMetallicRoughness", {})
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    desc = MaterialDescription(
        type="mdl",
        file="OmniPBR.mdl",
        name="OmniPBR",
        has_color=True,
        color=np.asarray(base[:3], np.float32),
    )
    desc.params["diffuse_color_constant"] = np.asarray(base[:3], np.float32)
    desc.params["reflection_roughness_constant"] = float(pbr.get("roughnessFactor", 1.0))
    desc.params["metallic_constant"] = float(pbr.get("metallicFactor", 1.0))

    def tex_uri(tex_index: int) -> Optional[str]:
        textures = doc.get("textures", [])
        images = doc.get("images", [])
        if 0 <= tex_index < len(textures):
            img = textures[tex_index].get("source", -1)
            if 0 <= img < len(images):
                return images[img].get("uri")
        return None

    bct = pbr.get("baseColorTexture", {}).get("index", -1)
    if bct >= 0 and tex_uri(bct):
        desc.params["diffuse_texture"] = tex_uri(bct)
    nt = material.get("normalTexture", {}).get("index", -1)
    if nt >= 0 and tex_uri(nt):
        desc.params["normalmap_texture"] = tex_uri(nt)
    emissive = material.get("emissiveFactor")
    if emissive and any(float(c) > 0 for c in emissive):
        strength = (
            material.get("extensions", {})
            .get("KHR_materials_emissive_strength", {})
            .get("emissiveStrength", 1.0)
        )
        desc.params["emissive_color"] = np.asarray(emissive[:3], np.float32)
        desc.params["emissive_intensity"] = float(strength)
        desc.params["enable_emission"] = True
    return desc


def _convert_to_omni_glass(doc: dict, material: dict) -> MaterialDescription:
    """gltfloader.cpp:358-404 (+ MASK alpha -> stochastic cutout opacity)."""
    pbr = material.get("pbrMetallicRoughness", {})
    desc = MaterialDescription(type="mdl", file="OmniGlass.mdl", name="OmniGlass")
    desc.params["enable_opacity"] = True
    desc.params["thin_walled"] = False
    desc.params["frosting_roughness"] = float(pbr.get("roughnessFactor", 0.0))
    base = pbr.get("baseColorFactor", [1.0, 1.0, 1.0, 1.0])
    if len(base) > 3 and float(base[3]) < 1.0:
        desc.params["opacity"] = float(base[3])
    return desc


class GltfLoader:
    """include/sceneloader/gltfloader.h — loadGltf(path, scene)."""

    def load_gltf(self, model_path: str, scene: Scene) -> bool:
        with P.setup_span("scene.load"):
            return self._load_gltf(model_path, scene)

    def _load_gltf(self, model_path: str, scene: Scene) -> bool:
        if not model_path or not os.path.exists(model_path):
            log.error("Unable to load file: {}", model_path)
            return False
        g = _parse_file(model_path)
        doc = g.doc
        scene.model_path = model_path

        self._load_materials(g, scene)
        if not self._load_lights_from_json(model_path, scene):
            log.warning("No light in scene, adding default distant light")
            scene.create_light(
                UniformLightDesc(
                    type=3,
                    position=np.zeros(3),
                    orientation=np.array([-45.0, 15.0, 0.0]),
                    half_angle=10.0 * 0.5 * (np.pi / 180.0),
                    intensity=100000.0,
                    color=np.ones(3),
                )
            )
        self._load_cameras(g, scene)
        self._load_nodes(g, scene)

        scene_id = doc.get("scene", 0)
        scenes = doc.get("scenes", [{}])
        for root in scenes[scene_id].get("nodes", []):
            self._process_node(g, scene, root, m3.identity4())
        self._load_animation(g, scene)
        return True

    # loadGltf alias for C++-style call sites
    loadGltf = load_gltf

    # ------------------------------------------------------------------
    def _load_materials(self, g: _Gltf, scene: Scene) -> None:
        for material in g.doc.get("materials", []):
            if material.get("alphaMode", "OPAQUE") == "OPAQUE":
                scene.add_material(_convert_to_omni_pbr(g.doc, material))
            else:
                scene.add_material(_convert_to_omni_glass(g.doc, material))
        if not scene.materials:
            scene.add_material(
                MaterialDescription(type="mdl", file="default.mdl", name="default", has_color=True)
            )

    def _load_lights_from_json(self, model_path: str, scene: Scene) -> bool:
        """gltfloader.cpp:612-632: `<name>_light.json` sidecar of rect lights."""
        json_path = os.path.splitext(model_path)[0] + "_light.json"
        if not os.path.exists(json_path):
            return False
        log.info("Found light file, loading lights from it")
        with open(json_path) as f:
            data = json.load(f)
        for light in data.get("lights", []):
            scene.create_light(
                UniformLightDesc(
                    type=0,
                    position=np.asarray(light["position"], np.float64),
                    orientation=np.asarray(light["orientation"], np.float64),
                    width=float(light["width"]),
                    height=float(light["height"]),
                    color=np.asarray(light["color"], np.float64),
                    intensity=float(light["intensity"]),
                    use_xform=False,
                )
            )
        return True

    def _load_cameras(self, g: _Gltf, scene: Scene) -> None:
        """gltfloader.cpp:423-449."""
        for cam in g.doc.get("cameras", []):
            if cam.get("type") == "perspective":
                p = cam.get("perspective", {})
                camera = Camera(
                    name=cam.get("name", ""),
                    fov=float(p.get("yfov", 0.785)) * (180.0 / np.pi),
                    znear=float(p.get("znear", 0.1)),
                    zfar=float(p.get("zfar", 100000.0)),
                )
                scene.add_camera(camera)
        if len(scene.cameras) == 0:
            scene.add_camera(Camera(name="default"))

    def _load_nodes(self, g: _Gltf, scene: Scene) -> None:
        for node in g.doc.get("nodes", []):
            n = Node(name=node.get("name", ""), children=list(node.get("children", [])))
            if "scale" in node:
                n.scale = np.asarray(node["scale"], np.float64)
            if "rotation" in node:
                x, y, z, w = node["rotation"]
                n.rotation = np.array([w, x, y, z], np.float64)
            if "translation" in node:
                n.translation = np.asarray(node["translation"], np.float64)
            scene.nodes.append(n)

    def _node_local_transform(self, node: dict) -> np.ndarray:
        """getTransform (gltfloader.cpp:221-265)."""
        if "matrix" in node:
            # glTF matrices are column-major; ours row-major applied as M@v
            return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
        t = np.asarray(node.get("translation", [0, 0, 0]), np.float64)
        s = np.asarray(node.get("scale", [1, 1, 1]), np.float64)
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            q = np.array([w, x, y, z], np.float64)
        else:
            q = np.array([1.0, 0, 0, 0])
        return m3.compose_trs(t, q, s)

    def _process_node(self, g: _Gltf, scene: Scene, node_id: int, base_transform: np.ndarray):
        """processNode (gltfloader.cpp:267-302)."""
        node = g.doc["nodes"][node_id]
        global_transform = base_transform @ self._node_local_transform(node)
        if node.get("mesh", -1) != -1:
            mesh = g.doc["meshes"][node["mesh"]]
            for prim in mesh.get("primitives", []):
                self._process_primitive(g, scene, prim, global_transform)
        elif node.get("camera", -1) != -1:
            # decompose + conjugate (gltfloader.cpp:283-295)
            cam = scene.get_camera(node["camera"])
            rot = global_transform[:3, :3].copy()
            sc = np.linalg.norm(rot, axis=0)
            rot = rot / np.maximum(sc, 1e-20)
            q = m3.quat_conjugate(m3.quat_from_mat3(rot))
            cam.node = node_id
            cam.position = global_transform[:3, 3] * sc
            cam.orientation = q
            cam.update_view_matrix()
        for child in node.get("children", []):
            scene.nodes[child].parent = node_id
            self._process_node(g, scene, child, global_transform)

    def _process_primitive(self, g: _Gltf, scene: Scene, prim: dict, transform: np.ndarray):
        """processPrimitive (gltfloader.cpp:96-208)."""
        attrs = prim.get("attributes", {})
        if "POSITION" not in attrs:
            return
        positions = g.accessor(attrs["POSITION"]).astype(np.float32)
        count = positions.shape[0]
        normals = (
            g.accessor(attrs["NORMAL"]).astype(np.float32) if "NORMAL" in attrs else None
        )
        if normals is not None:
            lens = np.linalg.norm(normals, axis=1, keepdims=True)
            normals = np.where(lens > 1e-12, normals / np.maximum(lens, 1e-12), normals)
        uvs = (
            g.accessor(attrs["TEXCOORD_0"]).astype(np.float32)[:, :2]
            if "TEXCOORD_0" in attrs
            else np.zeros((count, 2), np.float32)
        )
        if "indices" in prim:
            indices = np.asarray(g.accessor(prim["indices"]), np.uint32)
        else:
            indices = np.arange(count, dtype=np.uint32)
        tangents = _compute_uv_tangents(positions, uvs, indices)
        mat_id = prim.get("material", -1)
        if mat_id == -1:
            mat_id = 0
        mesh_id = scene.create_mesh(positions, indices, normals=normals, uvs=uvs, tangents=tangents)
        scene.create_instance(InstanceType.eMesh, mesh_id, mat_id, transform)

    def _load_animation(self, g: _Gltf, scene: Scene) -> None:
        """loadAnimation (gltfloader.cpp:452-554)."""
        for animation in g.doc.get("animations", []):
            anim = Animation(name=animation.get("name", ""))
            for sampler in animation.get("samplers", []):
                samp = AnimationSampler(interpolation=sampler.get("interpolation", "LINEAR"))
                inputs = g.accessor(sampler["input"]).astype(np.float32)
                samp.inputs = [float(v) for v in np.atleast_1d(inputs)]
                anim.start = min([anim.start] + samp.inputs)
                anim.end = max([anim.end] + samp.inputs)
                outputs = g.accessor(sampler["output"]).astype(np.float32)
                if outputs.ndim == 1:
                    outputs = outputs[:, None]
                if outputs.shape[1] == 3:
                    outputs = np.concatenate([outputs, np.zeros((len(outputs), 1), np.float32)], 1)
                samp.outputs_vec4 = [outputs[i] for i in range(len(outputs))]
                anim.samplers.append(samp)
            for channel in animation.get("channels", []):
                path = channel.get("target", {}).get("path", "")
                node = channel.get("target", {}).get("node", -1)
                if path == "weights" or node < 0:
                    continue
                anim.channels.append(
                    AnimationChannel(path=path, node=node, sampler_index=channel["sampler"])
                )
            scene.animations.append(anim)


def _compute_uv_tangents(positions: np.ndarray, uvs: np.ndarray, indices: np.ndarray) -> np.ndarray:
    """Per-face tangents from UV derivatives (computeTangent, gltfloader.cpp:64-94).

    The reference assigns the LAST face's tangent to its 3 vertices as faces
    stream in; we accumulate per-vertex (last write wins like the reference's
    overwrite order) using the same formula.
    """
    tangents = np.tile(np.array([[0.0, 0.0, 1.0]], np.float32), (len(positions), 1))
    tri = indices.reshape(-1, 3).astype(np.int64)
    p0, p1, p2 = positions[tri[:, 0]], positions[tri[:, 1]], positions[tri[:, 2]]
    uv0, uv1, uv2 = uvs[tri[:, 0]], uvs[tri[:, 1]], uvs[tri[:, 2]]
    dp1 = p1 - p0
    dp2 = p2 - p0
    du1 = uv1 - uv0
    du2 = uv2 - uv0
    d = du1[:, 0] * du2[:, 1] - du1[:, 1] * du2[:, 0]
    ok = np.abs(d) > 1e-6
    r = np.where(ok, 1.0 / np.where(ok, d, 1.0), 0.0)
    t = (dp1 * du2[:, 1:2] - dp2 * du1[:, 1:2]) * r[:, None]
    t = np.where(ok[:, None], t, [0.0, 0.0, 1.0])
    for k in range(3):
        tangents[tri[:, k]] = t
    return tangents.astype(np.float32)
