"""The port's glTF loader against the JAX package's.

The port keeps its own copy of `loaders/gltf.py`. On the assets that
tests/test_gltf.py synthesises (a .gltf with a data URI, a .glb, the light
sidecar) and on the same quad with a translation channel on its camera node:

(a) `GltfLoader().load_gltf` gives the same Scene in both packages, field by
    field (tests/test_torch_usd.py:same: numpy arrays bit-equal, floats
    equal, no tolerance: the port runs the same numpy code);
(b) the animated camera node moves the same way in both packages at every
    time asked (`Scene.update_animation`), and test_gltf.py's own camera-node
    case (:185) holds on the port;
(c) the device tables built from the loaded quad are bit-equal to the JAX
    build's;
(d) a 16x16 render of the loaded quad on the port has no NaN and a positive
    maximum (the default distant light reaches it).
"""

import base64
import json
import struct

import numpy as np
import pytest
import torch

from strelka_tpu.loaders.gltf import GltfLoader as JaxGltfLoader
from strelka_tpu.render.device_scene import build_device_scene as jax_build
from strelka_tpu.scene.scene import Scene as JaxScene
from strelka_tpu_torch.loaders.gltf import GltfLoader
from strelka_tpu_torch.render.device_scene import TABLES, build_device_scene
from strelka_tpu_torch.scene.scene import Scene

from test_gltf import _quad_gltf_doc  # the JAX package's own glTF fixture
from test_torch_usd import same

_LIGHTS = {"lights": [{"position": [0, 3, 0], "orientation": [-90, 0, 0], "width": 2.0, "height": 1.5,
                       "color": [1, 0.9, 0.8], "intensity": 500.0}]}  # test_gltf.py:127-138


def _data_uri(doc, blob):
    doc["buffers"][0]["uri"] = "data:application/octet-stream;base64," + base64.b64encode(blob).decode()
    return doc


def _animated(doc, blob):
    """The quad with a LINEAR translation channel on the camera node (node 1): (0, 3, 5) at t=0 to (2, 3, 1) at t=1."""
    times = np.array([0.0, 1.0], np.float32).tobytes()
    moves = np.array([[0, 3, 5], [2, 3, 1]], np.float32).tobytes()
    off = len(blob)
    blob = blob + times + moves
    doc["buffers"][0]["byteLength"] = len(blob)
    doc["bufferViews"] += [{"buffer": 0, "byteOffset": off, "byteLength": 8},
                           {"buffer": 0, "byteOffset": off + 8, "byteLength": 24}]
    doc["accessors"] += [{"bufferView": 4, "componentType": 5126, "count": 2, "type": "SCALAR"},
                         {"bufferView": 5, "componentType": 5126, "count": 2, "type": "VEC3"}]
    doc["animations"] = [{"name": "fly", "samplers": [{"input": 4, "output": 5, "interpolation": "LINEAR"}],
                          "channels": [{"sampler": 0, "target": {"node": 1, "path": "translation"}}]}]
    return doc, blob


def _write(tmp_path, kind: str) -> str:
    doc, blob = _quad_gltf_doc()
    if kind == "glb":  # as test_gltf.py:102-112 packs it
        json_bytes = json.dumps(doc).encode()
        json_bytes += b" " * ((4 - len(json_bytes) % 4) % 4)
        blob += b"\x00" * ((4 - len(blob) % 4) % 4)
        glb = struct.pack("<III", 0x46546C67, 2, 12 + 8 + len(json_bytes) + 8 + len(blob))
        glb += struct.pack("<II", len(json_bytes), 0x4E4F534A) + json_bytes
        glb += struct.pack("<II", len(blob), 0x004E4942) + blob
        path = tmp_path / "quad.glb"
        path.write_bytes(glb)
        return str(path)
    if kind == "animated":
        doc, blob = _animated(doc, blob)
    path = tmp_path / ("scene.gltf" if kind == "sidecar" else "quad.gltf")
    path.write_text(json.dumps(_data_uri(doc, blob)))
    if kind == "sidecar":
        (tmp_path / "scene_light.json").write_text(json.dumps(_LIGHTS))
    return str(path)


def _both(path):
    jax_scene, port_scene = JaxScene(), Scene()
    assert JaxGltfLoader().load_gltf(path, jax_scene)
    assert GltfLoader().load_gltf(path, port_scene)
    return jax_scene, port_scene


@pytest.mark.parametrize("kind", ["data_uri", "glb", "sidecar", "animated"])
def test_scene_matches_jax(tmp_path, kind):
    jax_scene, port_scene = _both(_write(tmp_path, kind))
    assert port_scene.instances and len(port_scene.materials) == 2
    same(jax_scene, port_scene, "scene")


def test_light_sidecar_gives_a_rect_light(tmp_path):
    _, port_scene = _both(_write(tmp_path, "sidecar"))
    assert len(port_scene.lights) == 1 and port_scene.lights[0].type == 0
    pts = port_scene.lights[0].points[:, :3]
    area = np.linalg.norm(np.cross(pts[1] - pts[0], pts[3] - pts[0]))
    assert area == pytest.approx(3.0, rel=1e-4)


def test_animated_camera_node_matches_jax(tmp_path):
    jax_scene, port_scene = _both(_write(tmp_path, "animated"))
    assert port_scene.animations[0].end == 1.0
    for t in (0.0, 0.25, 0.5, 1.0):
        jax_scene.update_animation(t)
        port_scene.update_animation(t)
        same(jax_scene.get_camera(0), port_scene.get_camera(0), f"camera at t={t}")
    np.testing.assert_allclose(port_scene.get_camera(0).position, [2, 3, 1], atol=1e-6)


def test_update_animation_moves_camera_node():
    """tests/test_gltf.py:185 on the port's Scene."""
    from strelka_tpu_torch.scene.camera import Camera
    from strelka_tpu_torch.scene.scene import Animation, AnimationChannel, AnimationSampler, Node

    scene = Scene()
    scene.nodes.append(Node(name="camnode"))
    cam = Camera(name="Main", fov=45.0, aspect=1.0)
    cam.node = 0
    scene.add_camera(cam)
    scene.animations.append(Animation(
        samplers=[AnimationSampler(inputs=[0.0, 1.0], outputs_vec4=[np.array([0.0, 0.0, 5.0, 0.0]),
                                                                    np.array([3.0, 0.0, 5.0, 0.0])])],
        channels=[AnimationChannel(path="translation", node=0, sampler_index=0)], start=0.0, end=1.0))
    scene.update_animation(0.0)
    v0 = np.asarray(scene.get_camera(0).matrices.view).copy()
    np.testing.assert_allclose(scene.get_camera(0).position, [0.0, 0.0, 5.0], atol=1e-6)
    scene.update_animation(0.5)
    np.testing.assert_allclose(scene.get_camera(0).position, [1.5, 0.0, 5.0], atol=1e-6)
    assert not np.allclose(v0, scene.get_camera(0).matrices.view)


def test_device_tables_match_jax(tmp_path):
    jax_scene, port_scene = _both(_write(tmp_path, "data_uri"))
    jds = jax_build(jax_scene)
    tds = build_device_scene(port_scene, device="cpu")
    assert tds.num_triangles == 2 and tds.bvh is None
    for name in TABLES:
        same(np.asarray(getattr(jds, name)), getattr(tds, name).numpy(), name)


def test_render_loaded_gltf(tmp_path):
    """tests/test_gltf.py:157 on the port, at 16x16 on the CPU."""
    from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu_torch.render.render import RenderFactory
    from strelka_tpu_torch.settings import SharedContext, make_default_settings

    _, scene = _both(_write(tmp_path, "data_uri"))
    s = make_default_settings(16, 16)
    s.set("render/pt/sppTotal", 2)
    s.set("render/pt/spp", 2)
    r = RenderFactory.create_render(device="cpu")
    r.set_scene(scene)
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(16, 16, BufferFormat.FLOAT4))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        r.render(buf)
    finally:
        torch.set_num_threads(threads)
    img = buf.map()
    assert img.shape == (16, 16, 4) and not np.isnan(img).any()
    assert img[..., :3].max() > 0.0
