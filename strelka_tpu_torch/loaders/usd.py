"""USD scene ingestion — the HdStrelka render-delegate capability without pxr.

Replicates what the reference's Hydra stack bakes into oka::Scene
(HdStrelka/RenderPass.cpp:132-289 _BakeMeshes + the prim Sync methods):

  * Mesh prims: triangulation (fan, HdMeshUtil-equivalent), vertex/faceVarying
    normals + primvars:st, smooth-normal fallback (Mesh.cpp:205-303)
  * Xform composition incl. matrix ops (USD row-vector matrices transposed
    into our column-vector convention)
  * Cameras: focal length + apertures -> fov, world-transform decompose with
    conjugated quaternion (Camera.cpp:44-105)
  * UsdLux lights: rect/disk/sphere/distant with intensity * 2^exposure,
    color temperature via the Catmull-Rom blackbody table (Light.cpp:32-103),
    distant-light normalization /(pi sin^2 theta) (Light.cpp:206)
  * UsdPreviewSurface material networks incl. UsdUVTexture file inputs
    (Material.cpp:52-163 + MaterialNetworkTranslator param mapping)
  * BasisCurves -> scene curves (BasisCurves.cpp:5-160)
  * references/payloads to sibling usda layers (flattened subset)

Binary .usdc stages are read through the pure-Python crate reader
(loaders/crate.py) — the same Prim tree feeds both text and binary paths.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from strelka_tpu_torch import log
from strelka_tpu_torch.loaders.usda_parser import Attr, Prim, parse_usda
from strelka_tpu_torch.scene.camera import Camera
from strelka_tpu_torch.scene.scene import (
    CurveType,
    InstanceType,
    MaterialDescription,
    Scene,
    UniformLightDesc,
)
from strelka_tpu_torch.utils import math3d as m3
from strelka_tpu_torch.utils import profiling as P

# Blackbody table from HdStrelka/Light.cpp:32-56 (public UsdLux-derived data)
_BLACKBODY_RGB = np.array(
    [
        [1.000000, 0.027490, 0.000000],
        [1.000000, 0.027490, 0.000000],
        [1.000000, 0.149664, 0.000000],
        [1.000000, 0.256644, 0.008095],
        [1.000000, 0.372033, 0.067450],
        [1.000000, 0.476725, 0.153601],
        [1.000000, 0.570376, 0.259196],
        [1.000000, 0.653480, 0.377155],
        [1.000000, 0.726878, 0.501606],
        [1.000000, 0.791543, 0.628050],
        [1.000000, 0.848462, 0.753228],
        [1.000000, 0.898581, 0.874905],
        [1.000000, 0.942771, 0.991642],
        [0.906947, 0.890456, 1.000000],
        [0.828247, 0.841838, 1.000000],
        [0.765791, 0.801896, 1.000000],
        [0.715255, 0.768579, 1.000000],
        [0.673683, 0.740423, 1.000000],
        [0.638992, 0.716359, 1.000000],
        [0.609681, 0.695588, 1.000000],
        [0.609681, 0.695588, 1.000000],
        [0.609681, 0.695588, 1.000000],
    ]
)

_BASIS = np.array(
    [[-0.5, 1.5, -1.5, 0.5], [1.0, -2.5, 2.0, -0.5], [-0.5, 0.0, 0.5, 0.0], [0.0, 1.0, 0.0, 0.0]]
)


def blackbody_temperature_as_rgb(temp: float) -> np.ndarray:
    """Catmull-Rom blackbody spline, luma-normalized (Light.cpp:68-103)."""
    num_knots = len(_BLACKBODY_RGB)
    u = float(np.clip((temp - 1000.0) / 9000.0, 0.0, 1.0))
    num_segs = num_knots - 4
    x = u * num_segs
    seg = int(np.floor(x))
    useg = x - seg
    k = _BLACKBODY_RGB[seg : seg + 4]
    coeffs = _BASIS @ k
    rgb = ((coeffs[0] * useg + coeffs[1]) * useg + coeffs[2]) * useg + coeffs[3]
    luma = float(rgb @ [0.2126, 0.7152, 0.0722])
    rgb = rgb / max(luma, 1e-9)
    return np.maximum(rgb, 0.0)


def _vec(v, n=3, default=0.0) -> np.ndarray:
    if v is None:
        return np.full(n, default)
    if isinstance(v, (int, float)):
        return np.full(n, float(v))
    return np.asarray([float(x) for x in v], np.float64)[:n]


def _attr_val(prim: Prim, name: str, default=None):
    a = prim.attrs.get(name)
    if a is None or a.value is None:
        return default
    return a.value


def _usd_matrix_to_row_major(rows) -> np.ndarray:
    """USD matrix4d (row-vector convention, translation in last row) ->
    our row-major column-vector convention: transpose."""
    m = np.asarray([[float(c) for c in row] for row in rows], np.float64)
    return m.T


def local_transform(prim: Prim) -> np.ndarray:
    """Compose xformOps in xformOpOrder (column-vector convention)."""
    order = _attr_val(prim, "xformOpOrder")
    if order is None:
        order = [k for k in prim.attrs if k.startswith("xformOp:")]
    xf = m3.identity4()
    for op_name in order:
        if not isinstance(op_name, str):
            continue
        inverted = op_name.startswith("!invert!")
        key = op_name.replace("!invert!", "")
        a = prim.attrs.get(key)
        if a is None or a.value is None:
            continue
        v = a.value
        op = key.split(":")[1] if ":" in key else key
        if op == "translate":
            M = m3.translate(_vec(v))
        elif op == "scale":
            M = m3.scale(_vec(v, default=1.0))
        elif op.startswith("rotateXYZ"):
            r = np.radians(_vec(v))
            M = (
                m3.quat_to_mat4(m3.quat_axis_angle([1, 0, 0], r[0]))
                @ m3.quat_to_mat4(m3.quat_axis_angle([0, 1, 0], r[1]))
                @ m3.quat_to_mat4(m3.quat_axis_angle([0, 0, 1], r[2]))
            )
        elif op.startswith("rotateZYX"):
            r = np.radians(_vec(v))
            M = (
                m3.quat_to_mat4(m3.quat_axis_angle([0, 0, 1], r[2]))
                @ m3.quat_to_mat4(m3.quat_axis_angle([0, 1, 0], r[1]))
                @ m3.quat_to_mat4(m3.quat_axis_angle([1, 0, 0], r[0]))
            )
        elif op.startswith("rotateX"):
            M = m3.quat_to_mat4(m3.quat_axis_angle([1, 0, 0], np.radians(float(v))))
        elif op.startswith("rotateY"):
            M = m3.quat_to_mat4(m3.quat_axis_angle([0, 1, 0], np.radians(float(v))))
        elif op.startswith("rotateZ"):
            M = m3.quat_to_mat4(m3.quat_axis_angle([0, 0, 1], np.radians(float(v))))
        elif op == "transform":
            M = _usd_matrix_to_row_major(v)
        elif op == "orient":
            # quatf (w, x, y, z) in usda text is (w, x, y, z)? USD serializes (w, x, y, z)
            q = _vec(v, 4)
            M = m3.quat_to_mat4([q[0], q[1], q[2], q[3]])
        else:
            continue
        if inverted:
            M = np.linalg.inv(M)
        xf = xf @ M
    return xf


def _triangulate(counts: List[int], indices: List[int], left_handed: bool) -> np.ndarray:
    """Fan triangulation of n-gons (HdMeshUtil equivalent). Returns [F,3] of
    face-vertex SLOT indices (positions into the flat faceVertexIndices)."""
    tris = []
    ofs = 0
    for c in counts:
        c = int(c)
        for k in range(1, c - 1):
            if left_handed:
                tris.append((ofs, ofs + k + 1, ofs + k))
            else:
                tris.append((ofs, ofs + k, ofs + k + 1))
        ofs += c
    return np.asarray(tris, np.int64).reshape(-1, 3)


# Node-id tables for network translation (the reverse of the reference's
# Usd* -> ND_* rename table, MaterialNetworkTranslator.cpp:79-151).
_PREVIEW_SURFACE_IDS = {"UsdPreviewSurface", "ND_UsdPreviewSurface_surfaceshader"}
_STANDARD_SURFACE_IDS = {"ND_standard_surface_surfaceshader", "standard_surface"}
_TEXTURE_NODE_IDS = {
    "UsdUVTexture", "ND_UsdUVTexture", "ND_image_color3", "ND_image_float",
    "ND_image_vector3", "ND_tiledimage_color3", "ND_tiledimage_float",
}
_TRANSFORM2D_IDS = {"UsdTransform2d", "ND_UsdTransform2d", "ND_place2d_vector2"}
_MULTIPLY_NODE_IDS = {
    "ND_multiply_color3", "ND_multiply_color3FA", "ND_multiply_float",
    "ND_multiply_vector3",
}
# standard_surface input -> UsdPreviewSurface input (subset we consume)
_STD_SURFACE_INPUT_MAP = {
    "diffuseColor": "base_color",
    "roughness": "specular_roughness",
    "metallic": "metalness",
    "emissiveColor": "emission_color",
    "ior": "specular_IOR",
    "opacity": "opacity",
    "normal": "normal",
}


def node_attrs_of(prim):
    return prim.attrs


class UsdLoader:
    """Load a flattened .usda stage into a Scene."""

    def __init__(self) -> None:
        self._layer_cache: Dict[str, Prim] = {}
        self._material_ids: Dict[str, int] = {}
        self._mesh_cache: Dict[str, tuple] = {}  # prim path -> (mesh_id, mat_id)
        self._base_dir = ""

    def load(self, path: str, scene: Scene) -> bool:
        with P.setup_span("scene.load"):
            return self._load(path, scene)

    def _load(self, path: str, scene: Scene) -> bool:
        is_crate = False
        if path.lower().endswith((".usdc", ".usd")):
            # .usd may be text or crate; sniff the magic
            with open(path, "rb") as f:
                head = f.read(8)
            is_crate = head == b"PXR-USDC"
            if not is_crate and not head.startswith(b"#usda"):
                log.error("Unrecognized USD file header in {}", path)
                return False
        try:
            if is_crate:
                # binary crate stage (reference workflow: hdRunner/main.cpp:566-591)
                from strelka_tpu_torch.loaders.crate import read_usdc

                root = read_usdc(path)
            else:
                with open(path, "r", encoding="utf-8") as f:
                    text = f.read()
                root = parse_usda(text)
        except (OSError, ValueError, SyntaxError) as e:
            log.error("USD parse failed for {}: {}", path, e)
            return False
        self._base_dir = os.path.dirname(os.path.abspath(path))
        scene.model_path = path
        self._compose_sublayers(root)
        self._resolve_references(root)
        self._resolve_inherits(root, root)
        self._root = root
        # bake pass (RenderPass._BakeMeshes equivalent)
        for prim in root.children:
            self._walk(prim, m3.identity4(), scene)
        if not scene.cameras:
            cam = Camera(name="default")
            cam.set_position([0.0, 0.0, -10.0])
            scene.add_camera(cam)
        if not scene.lights:
            log.warning("No lights in USD stage; adding default distant light")
            scene.create_light(
                UniformLightDesc(
                    type=3,
                    orientation=np.array([-45.0, 15.0, 0.0]),
                    half_angle=np.radians(5.0),
                    intensity=100000.0,
                    color=np.ones(3),
                )
            )
        if not scene.materials:
            scene.add_material(MaterialDescription(type="mdl", file="default.mdl", name="default"))
        return True

    # ------------------------------------------------------------------
    def _compose_sublayers(self, root: Prim, depth: int = 0) -> None:
        """Merge `subLayers = [@a.usda@, ...]` into the root prim tree.

        LIVRPS 'L' step (sublayer composition): the root layer's local
        opinions are strongest, then sublayers in authored order (first
        strongest). The reference gets this from UsdStage::Open
        (hdRunner/main.cpp:566-591); here each sublayer is parsed and merged
        weaker-under-stronger (attrs/metadata setdefault, prim union)."""
        if depth > 8:
            return
        subs = root.metadata.get("subLayers")
        if not isinstance(subs, list):
            return
        for s in subs:
            asset = s[1] if isinstance(s, tuple) and s and s[0] == "__asset__" else None
            if not asset:
                continue
            layer = self._load_layer(asset)
            if layer is None:
                continue
            self._compose_sublayers(layer, depth + 1)  # nested sublayers
            self._merge_weaker(root, layer)

    @staticmethod
    def _merge_weaker(dst: Prim, src: Prim) -> None:
        """Merge src's opinions into dst with dst (stronger) winning."""
        for k, v in src.attrs.items():
            dst.attrs.setdefault(k, v)
        for k, v in src.metadata.items():
            if k != "subLayers":
                dst.metadata.setdefault(k, v)
        if not dst.type:
            dst.type = src.type
        # an `over` that some weaker layer defines becomes concrete
        if dst.specifier == "over" and src.specifier in ("def", "class"):
            dst.specifier = src.specifier
        index = {c.name: c for c in dst.children}
        for c in src.children:
            if c.name in index:
                UsdLoader._merge_weaker(index[c.name], c)
            else:
                dst.children.append(c)

    def _resolve_inherits(self, prim: Prim, root: Prim, depth: int = 0) -> None:
        """Graft `inherits = </Class/X>` class-prim opinions (LIVRPS 'I':
        weaker than local/variant, stronger than references)."""
        if depth > 16:
            return
        for key in ("inherits", "prepend inherits", "specializes"):
            tgt = prim.metadata.get(key)
            if tgt is None:
                continue
            tgts = tgt if isinstance(tgt, list) else [tgt]
            for t in tgts:
                path = t[1] if isinstance(t, tuple) and t and t[0] == "__path__" else None
                if not path:
                    continue
                src = root.find(path)
                if src is None or src is prim:
                    continue
                for k, v in src.attrs.items():
                    prim.attrs.setdefault(k, v)
                if not prim.type:
                    prim.type = src.type
                names = {c.name for c in prim.children}
                for c in src.children:
                    if c.name not in names:
                        c.specifier = "def"  # concrete on the instance side
                        prim.children.append(c)
        for c in prim.children:
            self._resolve_inherits(c, root, depth + 1)

    # ------------------------------------------------------------------
    def _resolve_references(self, prim: Prim, depth: int = 0) -> None:
        """Graft referenced/payloaded usda layers (flattened subset)."""
        if depth > 16:
            return
        for key in ("references", "payload", "prepend references", "prepend payload"):
            ref = prim.metadata.get(key)
            if ref is None:
                continue
            refs = ref if isinstance(ref, list) else [ref]
            for r in refs:
                asset, target = None, None
                if isinstance(r, tuple) and r and r[0] == "__asset__":
                    asset = r[1]
                elif isinstance(r, tuple) and len(r) == 2 and isinstance(r[0], tuple):
                    if r[0][0] == "__asset__":
                        asset = r[0][1]
                    if isinstance(r[1], tuple) and r[1][0] == "__path__":
                        target = r[1][1]
                if not asset:
                    continue
                layer = self._load_layer(asset)
                if layer is None:
                    continue
                src = None
                if target:
                    src = layer.find(target)
                else:
                    dp = layer.metadata.get("defaultPrim")
                    if isinstance(dp, str):
                        src = layer.find("/" + dp)
                    elif layer.children:
                        src = layer.children[0]
                if src is not None:
                    # graft: child prims + attrs (weaker than local opinions)
                    for k, v in src.attrs.items():
                        prim.attrs.setdefault(k, v)
                    prim.children.extend(src.children)
                    if not prim.type:
                        prim.type = src.type
        for c in prim.children:
            self._resolve_references(c, depth + 1)

    def _load_layer(self, asset: str) -> Optional[Prim]:
        full = asset if os.path.isabs(asset) else os.path.join(self._base_dir, asset)
        if full in self._layer_cache:
            return self._layer_cache[full]
        if not os.path.exists(full):
            log.warning("Referenced layer not found: {}", asset)
            return None
        try:
            with open(full, "r", encoding="utf-8") as f:
                layer = parse_usda(f.read())
        except (ValueError, SyntaxError) as e:
            log.warning("Referenced layer parse failed {}: {}", asset, e)
            return None
        self._layer_cache[full] = layer
        return layer

    # ------------------------------------------------------------------
    def _walk(self, prim: Prim, parent_xf: np.ndarray, scene: Scene) -> None:
        if prim.metadata.get("active") is False:
            return
        if prim.specifier == "class":
            return  # abstract class prims never bake (pxr semantics)
        xf = parent_xf @ local_transform(prim)
        t = prim.type
        if t == "Mesh":
            self._bake_mesh(prim, xf, scene)
        elif t == "Camera":
            self._bake_camera(prim, xf, scene)
        elif t in ("RectLight", "DiskLight", "SphereLight", "DistantLight"):
            self._bake_light(prim, xf, scene, t)
        elif t == "BasisCurves":
            self._bake_curves(prim, xf, scene)
        elif t == "PointInstancer":
            self._bake_point_instancer(prim, xf, scene)
            return  # prototypes are instanced, not walked as scene geometry
        for c in prim.children:
            self._walk(c, xf, scene)

    # ------------------------------------------------------------------
    def _bake_point_instancer(self, prim: Prim, xf: np.ndarray, scene: Scene) -> None:
        """UsdGeomPointInstancer (HdStrelkaInstancer ComputeInstanceTransforms,
        Instancer.cpp:74-190): positions/orientations/scales per instance
        composed with the prototype subtree."""
        proto_rel = prim.attrs.get("prototypes")
        indices = _attr_val(prim, "protoIndices")
        positions = _attr_val(prim, "positions")
        if proto_rel is None or indices is None or positions is None:
            log.warning("PointInstancer {} missing prototypes/protoIndices/positions", prim.path)
            return
        protos: List[Optional[Prim]] = [self._root.find(t) for t in proto_rel.targets]
        positions = np.asarray([[float(c) for c in p] for p in positions], np.float64)
        indices = [int(i) for i in indices]
        orientations = _attr_val(prim, "orientations")
        scales = _attr_val(prim, "scales")
        n = len(indices)
        for i in range(n):
            proto = protos[indices[i]] if 0 <= indices[i] < len(protos) else None
            if proto is None:
                continue
            m = m3.translate(positions[i])
            if orientations is not None:
                # quath serialized (real, i, j, k)
                q = [float(c) for c in orientations[i]]
                m = m @ m3.quat_to_mat4([q[0], q[1], q[2], q[3]])
            if scales is not None:
                m = m @ m3.scale([float(c) for c in scales[i]])
            inst_xf = xf @ m
            # the prototype root's own xformOps apply inside the instance
            self._walk_proto(proto, inst_xf, scene)

    def _walk_proto(self, prim: Prim, xf: np.ndarray, scene: Scene) -> None:
        """Walk a prototype subtree for one instance (geometry only).

        Nested PointInstancers compose recursively with the parent instance
        transform — HdStrelkaInstancer walks parent instancers the same way
        (Instancer.cpp:74-190)."""
        xf = xf @ local_transform(prim)
        if prim.type == "Mesh":
            self._bake_mesh(prim, xf, scene)
        elif prim.type == "BasisCurves":
            self._bake_curves(prim, xf, scene)
        elif prim.type == "PointInstancer":
            self._bake_point_instancer(prim, xf, scene)
            return  # nested prototypes are instanced, not walked as geometry
        for c in prim.children:
            self._walk_proto(c, xf, scene)

    # ------------------------------------------------------------------
    def _bake_mesh(self, prim: Prim, xf: np.ndarray, scene: Scene) -> None:
        points = _attr_val(prim, "points")
        fvi = _attr_val(prim, "faceVertexIndices")
        fvc = _attr_val(prim, "faceVertexCounts")
        if points is None or fvi is None or fvc is None:
            return
        pts = np.asarray([[float(c) for c in p] for p in points], np.float32)
        fvi = np.asarray([int(i) for i in fvi], np.int64)
        fvc = [int(c) for c in fvc]
        left_handed = _attr_val(prim, "orientation") == "leftHanded"
        tri_slots = _triangulate(fvc, fvi, left_handed)
        if len(tri_slots) == 0:
            return

        # flatten to per-face-vertex arrays (Mesh.cpp:123-179)
        slot_to_point = fvi
        tri_pts = pts[slot_to_point[tri_slots]]

        normals_attr = _attr_val(prim, "normals")
        interp = None
        if "normals:__interp__" in prim.attrs:
            interp = prim.attrs["normals:__interp__"].value
        if normals_attr is not None:
            nrm = np.asarray([[float(c) for c in p] for p in normals_attr], np.float32)
            if len(nrm) == len(pts) and interp in (None, "vertex", "varying"):
                tri_nrm = nrm[slot_to_point[tri_slots]]
            elif len(nrm) == len(fvi):  # faceVarying
                tri_nrm = nrm[tri_slots]
            else:
                tri_nrm = None
        else:
            tri_nrm = None

        st_attr = _attr_val(prim, "primvars:st") or _attr_val(prim, "primvars:uv")
        tri_uv = None
        if st_attr is not None:
            st = np.asarray([[float(c) for c in p] for p in st_attr], np.float32)
            st_interp = None
            for key in ("primvars:st:__interp__", "primvars:uv:__interp__"):
                if key in prim.attrs:
                    st_interp = prim.attrs[key].value
            idx_attr = _attr_val(prim, "primvars:st:indices")
            if idx_attr is not None:
                st = st[np.asarray([int(i) for i in idx_attr], np.int64)]
            if len(st) == len(fvi) and st_interp != "vertex":
                tri_uv = st[tri_slots]
            elif len(st) == len(pts):
                tri_uv = st[slot_to_point[tri_slots]]

        cached = self._mesh_cache.get(prim.path)
        if cached is not None:
            scene.create_instance(InstanceType.eMesh, cached[0], cached[1], xf)
            return

        nface = len(tri_slots)
        flat_pos = tri_pts.reshape(-1, 3)
        if tri_nrm is None:
            # smooth-normal fallback per face (Mesh.cpp:241-255 equivalent)
            fn = np.cross(tri_pts[:, 1] - tri_pts[:, 0], tri_pts[:, 2] - tri_pts[:, 0])
            fn /= np.maximum(np.linalg.norm(fn, axis=1, keepdims=True), 1e-12)
            flat_nrm = np.repeat(fn, 3, axis=0)
        else:
            flat_nrm = tri_nrm.reshape(-1, 3)
        flat_uv = tri_uv.reshape(-1, 2) if tri_uv is not None else np.zeros((nface * 3, 2), np.float32)
        indices = np.arange(nface * 3, dtype=np.uint32)
        mesh_id = scene.create_mesh(flat_pos, indices, normals=flat_nrm, uvs=flat_uv)
        mat_id = self._resolve_material(prim, scene)
        self._mesh_cache[prim.path] = (mesh_id, mat_id)
        scene.create_instance(InstanceType.eMesh, mesh_id, mat_id, xf)

    # ------------------------------------------------------------------
    def _bake_camera(self, prim: Prim, xf: np.ndarray, scene: Scene) -> None:
        """HdStrelka/Camera.cpp:44-105."""
        focal = float(_attr_val(prim, "focalLength", 50.0))
        v_ap = float(_attr_val(prim, "verticalAperture", 15.2908))
        h_ap = float(_attr_val(prim, "horizontalAperture", 20.955))
        fov = np.degrees(2.0 * np.arctan(v_ap / (2.0 * focal)))
        clip = _attr_val(prim, "clippingRange", (0.1, 100000.0))
        cam = Camera(
            name=prim.name,
            fov=float(fov),
            aspect=h_ap / v_ap,
            znear=float(clip[0]),
            zfar=float(clip[1]),
        )
        rot = xf[:3, :3].copy()
        sc = np.linalg.norm(rot, axis=0)
        rot = rot / np.maximum(sc, 1e-20)
        cam.orientation = m3.quat_conjugate(m3.quat_from_mat3(rot))
        cam.position = xf[:3, 3]
        cam.update_view_matrix()
        scene.add_camera(cam)

    # ------------------------------------------------------------------
    def _bake_light(self, prim: Prim, xf: np.ndarray, scene: Scene, light_type: str) -> None:
        """HdStrelkaLight::Sync (Light.cpp:113-209)."""
        color = _vec(_attr_val(prim, "inputs:color", (1.0, 1.0, 1.0)))
        if _attr_val(prim, "inputs:enableColorTemperature", False):
            temp = _attr_val(prim, "inputs:colorTemperature")
            if temp is not None:
                color = color * blackbody_temperature_as_rgb(float(temp))
        intensity = float(_attr_val(prim, "inputs:intensity", 1.0))
        exposure = float(_attr_val(prim, "inputs:exposure", 0.0))
        intensity *= 2.0 ** np.clip(exposure, -50.0, 50.0)

        desc = UniformLightDesc(color=color, intensity=intensity, xform=xf, use_xform=True)
        if light_type == "RectLight":
            desc.type = 0
            desc.width = float(_attr_val(prim, "inputs:width", 1.0))
            desc.height = float(_attr_val(prim, "inputs:height", 1.0))
            # update_light composes xform @ scale(width, height, 1) itself
        elif light_type in ("DiskLight", "SphereLight"):
            desc.type = 1 if light_type == "DiskLight" else 2
            radius = float(_attr_val(prim, "inputs:radius", 0.5))
            desc.radius = radius * float(xf[0, 0])  # uniform scale (Light.cpp:196)
        elif light_type == "DistantLight":
            desc.type = 3
            angle = float(_attr_val(prim, "inputs:angle", 0.53))
            desc.half_angle = angle * 0.5 * (np.pi / 180.0)
            desc.intensity = desc.intensity / (np.pi * np.sin(desc.half_angle) ** 2)
        scene.create_light(desc)

    # ------------------------------------------------------------------
    def _bake_curves(self, prim: Prim, xf: np.ndarray, scene: Scene) -> None:
        """One BasisCurves prim. Its bake, up to the curve's creation and
        before its material is resolved, is the set-up span usd.curves.
        points and widths convert in one array conversion each (the same
        f32 roundings as converting element by element)."""
        with P.setup_span("usd.curves"):
            points = _attr_val(prim, "points")
            counts = _attr_val(prim, "curveVertexCounts")
            if points is None or counts is None:
                return
            pts = np.asarray(points, np.float32).reshape(-1, 3)
            counts = np.asarray([int(c) for c in counts], np.uint32)
            widths = _attr_val(prim, "widths")
            if widths is not None:
                widths = np.asarray(widths, np.float32).reshape(-1) * 0.5  # width -> radius
            curve_id = scene.create_curve(CurveType.eCubic, counts, pts, widths)
        mat_id = self._resolve_material(prim, scene)
        scene.create_instance(InstanceType.eCurve, curve_id, mat_id, xf)

    # ------------------------------------------------------------------
    def _resolve_material(self, prim: Prim, scene: Scene) -> int:
        rel = prim.attrs.get("material:binding")
        if rel is None or not rel.targets:
            # unbound mesh with an authored displayColor gets a constant
            # material of that color (the reference's HdStrelkaMesh
            # displayColor fallback, Mesh.cpp _ConvertColor path)
            dc = _attr_val(prim, "primvars:displayColor")
            if dc is not None:
                col = _vec(dc[0] if isinstance(dc, list) and dc else dc, 3, 1.0)
                key = "__displayColor_%.5f_%.5f_%.5f" % tuple(col)
                if key in self._material_ids:
                    return self._material_ids[key]
                mid = scene.add_material(
                    MaterialDescription(
                        type="mdl", file="default.mdl", name=key[2:],
                        has_color=True, color=np.asarray(col, np.float32),
                    )
                )
                self._material_ids[key] = mid
                return mid
            return self._default_material(scene)
        target = rel.targets[0]
        if target in self._material_ids:
            return self._material_ids[target]
        mat_prim = self._root.find(target)
        if mat_prim is None:
            return self._default_material(scene)
        desc = self._material_from_network(mat_prim)
        mid = scene.add_material(desc)
        self._material_ids[target] = mid
        return mid

    def _resolve_network_input(self, node: Prim, name: str, depth: int = 0) -> dict:
        """Follow one shader input through intermediate network nodes.

        Handles (MaterialNetworkTranslator.cpp:79-300 capability): texture
        nodes (UsdUVTexture / ND_image_*), their inputs:scale value
        multipliers and UsdTransform2d st transforms (through
        UsdPrimvarReader), and multiply/scale arithmetic nodes between a
        texture and the surface. Returns {value, tex, mult, uv_scale,
        uv_offset} (all optional).
        """
        out: dict = {}
        a = node.attrs.get(f"inputs:{name}")
        if a is None:
            return out
        if not a.connect:
            if a.value is not None:
                out["value"] = a.value
            return out
        if depth > 4:
            return out
        target = self._root.find(a.connect.split(".")[0])
        if target is None:
            return out
        tid = _attr_val(target, "info:id")
        if tid in _TEXTURE_NODE_IDS:
            f = _attr_val(target, "inputs:file")
            if isinstance(f, tuple) and f and f[0] == "__asset__":
                out["tex"] = f[1]
            fb = _attr_val(target, "inputs:fallback")
            if fb is not None:
                out["value"] = fb
            scale = _attr_val(target, "inputs:scale")
            if isinstance(scale, (tuple, list)) and len(scale) >= 3:
                out["mult"] = [float(x) for x in scale[:3]]
            # st chain: PrimvarReader or UsdTransform2d(st)
            st = target.attrs.get("inputs:st")
            if st is not None and st.connect:
                st_node = self._root.find(st.connect.split(".")[0])
                if st_node is not None and _attr_val(st_node, "info:id") in _TRANSFORM2D_IDS:
                    sc = _attr_val(st_node, "inputs:scale")
                    tr = _attr_val(st_node, "inputs:translation")
                    if isinstance(sc, (tuple, list)):
                        out["uv_scale"] = [float(x) for x in sc[:2]]
                    if isinstance(tr, (tuple, list)):
                        out["uv_offset"] = [float(x) for x in tr[:2]]
            return out
        if tid in _MULTIPLY_NODE_IDS:
            # texture (or value) * constant factor: recurse on in1/in, take
            # the constant side as the multiplier
            inner = {}
            factor = None
            for in_name in ("in1", "in", "a"):
                if f"inputs:{in_name}" in node_attrs_of(target):
                    inner = self._resolve_network_input(target, in_name, depth + 1)
                    if inner:
                        break
            for in_name in ("in2", "b", "scale"):
                v = _attr_val(target, f"inputs:{in_name}")
                if v is not None:
                    factor = v
                    break
            if factor is not None:
                prev = inner.get("mult")
                fac = [float(x) for x in factor[:3]] if isinstance(factor, (tuple, list)) else float(factor)
                if prev is None:
                    inner["mult"] = fac
                else:
                    p = np.asarray(prev, np.float32)
                    inner["mult"] = (p * np.asarray(fac, np.float32)).tolist()
            return inner
        # pass-through nodes (color conversions etc.): follow their main input
        for in_name in ("in", "in1", "a"):
            if f"inputs:{in_name}" in node_attrs_of(target):
                return self._resolve_network_input(target, in_name, depth + 1)
        return out

    def _material_from_network(self, mat_prim: Prim) -> MaterialDescription:
        """UsdPreviewSurface network -> material description
        (HdStrelkaMaterial::Sync param collection, Material.cpp:52-163)."""
        desc = MaterialDescription(type="mtlx", name=mat_prim.name, file="OmniPBR.mdl")
        # find surface shader (mdl output preferred like the reference's
        # material contexts, RenderDelegate.cpp:222-230)
        shader = None
        for out_name in ("outputs:mdl:surface", "outputs:surface"):
            surf = mat_prim.attrs.get(out_name)
            if surf is not None and surf.connect:
                shader = self._root.find(surf.connect.split(".")[0])
                if shader is not None:
                    break
        if shader is None:
            for c in mat_prim.children:
                if c.type == "Shader":
                    shader = c
                    break
        if shader is None:
            return desc

        # single-node MDL network (HdStrelkaMaterial::Sync, Material.cpp:181):
        # info:mdl:sourceAsset = @File.mdl@ + sourceAsset:subIdentifier
        src_asset = _attr_val(shader, "info:mdl:sourceAsset")
        if isinstance(src_asset, tuple) and src_asset and src_asset[0] == "__asset__":
            desc.type = "mdl"
            desc.file = os.path.basename(src_asset[1])
            sub = _attr_val(shader, "info:mdl:sourceAsset:subIdentifier")
            if isinstance(sub, str):
                desc.name = sub
            # typed inputs become instance params (Material.cpp:52-163)
            for key, attr in shader.attrs.items():
                if not key.startswith("inputs:") or attr.value is None:
                    continue
                pname = key[len("inputs:") :]
                val = attr.value
                if isinstance(val, tuple) and val and val[0] == "__asset__":
                    desc.params[pname] = val[1]
                elif isinstance(val, (tuple, list)):
                    desc.params[pname] = np.asarray([float(x) for x in val], np.float32)
                else:
                    desc.params[pname] = val
            return desc
        shader_id = _attr_val(shader, "info:id")
        std_surface = shader_id in _STANDARD_SURFACE_IDS
        if shader_id not in _PREVIEW_SURFACE_IDS and not std_surface:
            # unknown network: fall back to defaults (Material.cpp:181-187)
            return desc

        def shader_input(name, default=None):
            """Resolve an input through the node network
            (MaterialNetworkTranslator.cpp:79-300: multi-node graphs with
            Usd*->ND_* name aliasing, scale/multiply nodes, texture nodes
            with UsdTransform2d st transforms)."""
            if std_surface:
                name = _STD_SURFACE_INPUT_MAP.get(name, name)
            r = self._resolve_network_input(shader, name)
            if r.get("uv_scale") is not None:
                desc.params["uv_scale"] = np.asarray(r["uv_scale"], np.float32)
            if r.get("uv_offset") is not None:
                desc.params["uv_offset"] = np.asarray(r["uv_offset"], np.float32)
            val = r.get("value", default)
            if val is None:
                val = default
            mult = r.get("mult")
            if mult is not None and val is not None:
                v = np.atleast_1d(np.asarray(val, np.float32))
                m = np.atleast_1d(np.asarray(mult, np.float32))
                k = min(len(v), len(m)) if len(v) > 1 and len(m) > 1 else max(len(v), len(m))
                out = (v[:k] if len(v) > 1 else v) * (m[:k] if len(m) > 1 else m)
                val = float(out[0]) if out.size == 1 else out.tolist()
            return val, r.get("tex")

        def _scalar(v):
            if isinstance(v, (tuple, list, np.ndarray)):
                return float(v[0]) if len(v) else 0.0
            return float(v)

        dc, dc_tex = shader_input("diffuseColor", (0.18, 0.18, 0.18))
        desc.has_color = True
        desc.color = _vec(dc, default=0.18).astype(np.float32)
        desc.params["diffuse_color_constant"] = desc.color
        if dc_tex:
            desc.params["diffuse_texture"] = dc_tex
        rough, rough_tex = shader_input("roughness", 0.5)
        desc.params["reflection_roughness_constant"] = _scalar(rough)
        if rough_tex:
            desc.params["reflectionroughness_texture"] = rough_tex
        metal, metal_tex = shader_input("metallic", 0.0)
        desc.params["metallic_constant"] = _scalar(metal)
        if metal_tex:
            desc.params["metallic_texture"] = metal_tex
        _, nrm_tex = shader_input("normal")
        if nrm_tex:
            desc.params["normalmap_texture"] = nrm_tex
        ior, _ = shader_input("ior", 1.5)
        desc.params["ior"] = _scalar(ior)
        opacity, _ = shader_input("opacity", 1.0)
        desc.params["opacity"] = _scalar(opacity)
        emissive, _ = shader_input("emissiveColor", (0.0, 0.0, 0.0))
        desc.params["emissive_color"] = _vec(emissive).astype(np.float32)
        return desc

    def _default_material(self, scene: Scene) -> int:
        if "__default__" in self._material_ids:
            return self._material_ids["__default__"]
        mid = scene.add_material(
            MaterialDescription(type="mdl", file="default.mdl", name="default", has_color=True)
        )
        self._material_ids["__default__"] = mid
        return mid
