"""The port's USD text loader against the JAX package's.

The port keeps its own copies of `loaders/usda_parser.py` and
`loaders/usd.py`; these tests hold them equal to the JAX package's on the
bench's coffeetable stage and on the stages that tests/test_usd.py
synthesises (structure, scene build, references, sublayers, inherits, point
instancers, nested instancers, time samples, an MDL shader node, a
multi-node material network), and on kitchen's binary stage through the
port's crate reader:

(a) `parse_usda` gives the same Prim tree (every prim, attribute, value and
    metadata entry equal);
(b) `UsdLoader().load` gives the same Scene, field by field: vertex pools
    and indices bit-equal, materials' type, file, name and params equal,
    lights and cameras bit-equal (exact equality, no tolerance: the port
    runs the same numpy code);
(c) the blackbody table lookup is bit-equal over 1000-40000 K;
(d) the device tables that the port builds from coffeetable equal the JAX
    build's bit for bit.
"""

import dataclasses
import enum
import os

import numpy as np
import pytest

from strelka_tpu.loaders.usd import UsdLoader as JaxUsdLoader
from strelka_tpu.loaders.usd import blackbody_temperature_as_rgb as jax_blackbody
from strelka_tpu.loaders.usda_parser import parse_usda as jax_parse_usda
from strelka_tpu.render.device_scene import build_device_scene as jax_build
from strelka_tpu.scene.scene import Scene as JaxScene
from strelka_tpu_torch.loaders.usd import UsdLoader, blackbody_temperature_as_rgb
from strelka_tpu_torch.loaders.usda_parser import parse_usda
from strelka_tpu_torch.render.device_scene import TABLES, build_device_scene
from strelka_tpu_torch.scene.kitchen import ensure_kitchen
from strelka_tpu_torch.scene.scene import Scene

from test_usd import _NETWORK_STAGE, _STAGE  # the JAX package's own text fixtures

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COFFEETABLE = os.path.join(ROOT, "data", "scenes", "coffeetable.usda")

_TRI = """
    def Mesh "tri"
    {
        point3f[] points = [(0, 0, 0), (1, 0, 0), (0, 1, 0)]
        int[] faceVertexIndices = [0, 1, 2]
        int[] faceVertexCounts = [3]
    }"""

# name -> ({file name: text}, the file to load); as tests/test_usd.py writes them
STAGES = {
    "structure": ({"stage.usda": _STAGE}, "stage.usda"),
    "references": ({
        "geo.usda": '#usda 1.0\n(\n    defaultPrim = "Model"\n)\ndef Xform "Model"\n{' + _TRI + "\n}\n",
        "main.usda": """#usda 1.0
(
    defaultPrim = "World"
)
def Xform "World"
{
    def Xform "inst1" (
        references = @./geo.usda@
    )
    {
        double3 xformOp:translate = (5, 0, 0)
        uniform token[] xformOpOrder = ["xformOp:translate"]
    }
}
"""}, "main.usda"),
    "mdl_shader_node": ({"mdl.usda": """#usda 1.0
(
    defaultPrim = "World"
)
def Xform "World"
{
    def Mesh "quad"
    {
        point3f[] points = [(0,0,0), (1,0,0), (0,1,0)]
        int[] faceVertexIndices = [0, 1, 2]
        int[] faceVertexCounts = [3]
        rel material:binding = </World/Looks/Metal>
    }
    def Scope "Looks"
    {
        def Material "Metal"
        {
            token outputs:mdl:surface.connect = </World/Looks/Metal/Shader.outputs:out>

            def Shader "Shader"
            {
                uniform token info:implementationSource = "sourceAsset"
                uniform asset info:mdl:sourceAsset = @OmniPBR.mdl@
                uniform token info:mdl:sourceAsset:subIdentifier = "OmniPBR"
                color3f inputs:diffuse_color_constant = (0.9, 0.7, 0.2)
                float inputs:metallic_constant = 1.0
                float inputs:reflection_roughness_constant = 0.15
                token outputs:out
            }
        }
    }
}
"""}, "mdl.usda"),
    "point_instancer": ({"pi.usda": """#usda 1.0
(
    defaultPrim = "World"
)
def Xform "World"
{
    def PointInstancer "scatter"
    {
        rel prototypes = [</World/scatter/protos/tri>]
        int[] protoIndices = [0, 0, 0]
        point3f[] positions = [(0, 0, 0), (5, 0, 0), (0, 0, 5)]
        float3[] scales = [(1, 1, 1), (2, 2, 2), (1, 1, 1)]
        def Scope "protos"
        {""" + _TRI.replace("\n    ", "\n            ") + """
        }
    }
}
"""}, "pi.usda"),
    "network": ({"net.usda": _NETWORK_STAGE}, "net.usda"),
    "nested_instancer": ({"nested.usda": """#usda 1.0
def Xform "World"
{
    def PointInstancer "outer"
    {
        rel prototypes = [</World/outer/protoA>]
        int[] protoIndices = [0, 0]
        point3f[] positions = [(0, 0, 0), (10, 0, 0)]

        def Xform "protoA"
        {
            def PointInstancer "inner"
            {
                rel prototypes = [</World/outer/protoA/inner/leaf>]
                int[] protoIndices = [0, 0, 0]
                point3f[] positions = [(0, 0, 0), (1, 0, 0), (2, 0, 0)]

                def Xform "leaf"
                {
                    def Mesh "tri"
                    {
                        point3f[] points = [(0, 0, 0), (0.1, 0, 0), (0, 0.1, 0)]
                        int[] faceVertexIndices = [0, 1, 2]
                        int[] faceVertexCounts = [3]
                    }
                }
            }
        }
    }
}
"""}, "nested.usda"),
    "time_samples": ({"t.usda": """#usda 1.0
def Xform "World"
{
    def Mesh "tri"
    {
        point3f[] points.timeSamples = {
            0: [(0, 0, 0), (1, 0, 0), (0, 1, 0)],
            10: [(5, 0, 0), (6, 0, 0), (5, 1, 0)],
        }
        int[] faceVertexIndices = [0, 1, 2]
        int[] faceVertexCounts = [3]
        double3 xformOp:translate.timeSamples = { 0: (2, 0, 0), 5: (9, 9, 9) }
        uniform token[] xformOpOrder = ["xformOp:translate"]
    }
}
"""}, "t.usda"),
    "sublayers": ({
        "base.usda": """#usda 1.0
(
    defaultPrim = "World"
)
def Xform "World"
{
    def Mesh "ground"
    {
        point3f[] points = [(-5, 0, -5), (5, 0, -5), (5, 0, 5), (-5, 0, 5)]
        int[] faceVertexIndices = [0, 3, 2, 1]
        int[] faceVertexCounts = [4]
        color3f[] primvars:displayColor = [(0.2, 0.2, 0.2)]
    }
    def SphereLight "lamp"
    {
        float inputs:radius = 1.0
        float inputs:intensity = 5.0
    }
}
""",
        "override.usda": """#usda 1.0
def Xform "World"
{
    def Mesh "ground"
    {
        color3f[] primvars:displayColor = [(0.9, 0.1, 0.1)]
    }
    def Mesh "extra"
    {
        point3f[] points = [(0, 1, 0), (1, 1, 0), (0, 2, 0)]
        int[] faceVertexIndices = [0, 1, 2]
        int[] faceVertexCounts = [3]
    }
}
""",
        "main.usda": """#usda 1.0
(
    defaultPrim = "World"
    subLayers = [@override.usda@, @base.usda@]
)
over "World"
{
    over "lamp"
    {
        float inputs:intensity = 42.0
    }
}
"""}, "main.usda"),
    "inherits": ({"inh.usda": """#usda 1.0
(
    defaultPrim = "World"
)
class Xform "Shapes"
{
    class Mesh "TriBase"
    {
        point3f[] points = [(0, 0, 0), (1, 0, 0), (0, 1, 0)]
        int[] faceVertexIndices = [0, 1, 2]
        int[] faceVertexCounts = [3]
        color3f[] primvars:displayColor = [(0, 0, 1)]
    }
}
def Xform "World"
{
    def Mesh "tri" (
        inherits = </Shapes/TriBase>
    )
    {
        color3f[] primvars:displayColor = [(1, 1, 0)]
    }
}
"""}, "inh.usda"),
    "blackbody_lights": ({"bb.usda": """#usda 1.0
def Xform "World"
{""" + _TRI + """
    def RectLight "warm"
    {
        float inputs:intensity = 20
        float inputs:colorTemperature = 2700
        bool inputs:enableColorTemperature = 1
        float inputs:width = 1
        float inputs:height = 2
        double3 xformOp:translate = (0, 3, 0)
        uniform token[] xformOpOrder = ["xformOp:translate"]
    }
    def DiskLight "disk"
    {
        float inputs:intensity = 8
        float inputs:radius = 0.5
        float inputs:colorTemperature = 9000
        bool inputs:enableColorTemperature = 1
    }
    def Camera "cam"
    {
        float focalLength = 35
        float horizontalAperture = 36
        float verticalAperture = 24
        double3 xformOp:translate = (1, 2, 6)
        double3 xformOp:rotateXYZ = (-10, 20, 0)
        uniform token[] xformOpOrder = ["xformOp:translate", "xformOp:rotateXYZ"]
    }
}
"""}, "bb.usda"),
}


def same(a, b, where="") -> None:
    """a (JAX package) == b (port), recursively: numpy arrays bit-equal with
    the same dtype and shape, dataclasses and plain objects attribute by
    attribute (their class names equal), floats equal (NaN equals NaN)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{where}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
        assert np.array_equal(a, b, equal_nan=a.dtype.kind in "fc"), f"{where}: values differ"
    elif isinstance(a, enum.Enum):
        assert type(a).__name__ == type(b).__name__ and a.value == b.value, f"{where}: {a} vs {b}"
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), f"{where}: keys {list(a)} vs {list(b)}"
        for k in a:
            same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), f"{where}: {type(a)}[{len(a)}] vs {type(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{where}[{i}]")
    elif isinstance(a, set):
        assert a == b, f"{where}: {a} vs {b}"
    elif isinstance(a, float):
        assert isinstance(b, float) and (a == b or (a != a and b != b)), f"{where}: {a} vs {b}"
    elif dataclasses.is_dataclass(a) or hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, f"{where}: {type(a)} vs {type(b)}"
        same(vars(a), vars(b), f"{where}.")
    else:
        assert type(a) is type(b) and a == b, f"{where}: {a!r} vs {b!r}"


def _write(tmp_path, name):
    files, main = STAGES[name]
    for fname, text in files.items():
        (tmp_path / fname).write_text(text)
    return str(tmp_path / main)


def _both_scenes(path):
    jax_scene, port_scene = JaxScene(), Scene()
    assert JaxUsdLoader().load(path, jax_scene)
    assert UsdLoader().load(path, port_scene)
    return jax_scene, port_scene


@pytest.mark.parametrize("name", sorted(STAGES))
def test_parse_usda_matches_jax(tmp_path, name):
    files, _ = STAGES[name]
    for text in files.values():
        same(jax_parse_usda(text), parse_usda(text), "root")


@pytest.mark.parametrize("name", sorted(STAGES))
def test_scene_matches_jax(tmp_path, name):
    jax_scene, port_scene = _both_scenes(_write(tmp_path, name))
    assert port_scene.instances, "the stage baked no instance"
    same(jax_scene, port_scene, "scene")


def test_coffeetable_parse_matches_jax():
    with open(COFFEETABLE) as f:
        text = f.read()
    same(jax_parse_usda(text), parse_usda(text), "root")


def test_coffeetable_scene_matches_jax():
    jax_scene, port_scene = _both_scenes(COFFEETABLE)
    same(jax_scene, port_scene, "scene")
    pools = port_scene.vertex_pools()
    assert pools[0].shape == (190, 3) and pools[4].shape == (192,)
    assert len(port_scene.materials) == 4 and len(port_scene.lights) == 2
    assert all(m.type in ("mtlx", "mdl") and not m.code for m in port_scene.materials)


def test_kitchen_scene_matches_jax():
    """The binary stage through both crate readers and both loaders."""
    from strelka_tpu.scene.kitchen_gen import ensure_kitchen as jax_ensure_kitchen

    path = ensure_kitchen()
    assert os.path.samefile(path, jax_ensure_kitchen())
    jax_scene, port_scene = _both_scenes(path)
    same(jax_scene, port_scene, "scene")
    assert len(port_scene.materials) == 10 and len(port_scene.lights) == 4
    textures = sorted(m.params["diffuse_texture"] for m in port_scene.materials if "diffuse_texture" in m.params)
    assert textures == ["textures/checker.png", "textures/fabric.png", "textures/wallpaper.png",
                        "textures/wood.png"]


def test_kitchen_path_checks_files(tmp_path, monkeypatch):
    """A stage missing its .usdc or any texture is generated again
    (scene/kitchen_gen.py, held byte-equal to the JAX generator in
    test_torch_kitchen_gen.py); a complete one is taken as it is."""
    from strelka_tpu_torch.scene import kitchen_gen

    built = []
    monkeypatch.setattr(kitchen_gen, "build_kitchen_stage",
                        lambda d: built.append(d) or os.path.join(d, "kitchen.usdc"))
    usdc = str(tmp_path / "kitchen.usdc")
    assert ensure_kitchen(str(tmp_path)) == usdc and built == [str(tmp_path)]
    (tmp_path / "kitchen.usdc").write_bytes(b"")
    ensure_kitchen(str(tmp_path))
    assert len(built) == 2  # the textures are missing
    (tmp_path / "textures").mkdir()
    for name in ("checker.png", "wood.png", "wallpaper.png", "fabric.png"):
        (tmp_path / "textures" / name).write_bytes(b"")
    assert ensure_kitchen(str(tmp_path)) == usdc and len(built) == 2


def test_blackbody_matches_jax():
    for kelvin in np.linspace(1000.0, 40000.0, 97):
        same(jax_blackbody(float(kelvin)), blackbody_temperature_as_rgb(float(kelvin)), f"{kelvin} K")


def test_coffeetable_device_tables_match_jax():
    jax_scene, port_scene = _both_scenes(COFFEETABLE)
    jds = jax_build(jax_scene)
    tds = build_device_scene(port_scene, device="cpu")
    assert tds.bvh is None and tds.textures is None and tds.num_triangles == 64
    assert tuple(tds.v0.shape) == (128, 3)  # padded to 128: 4 groups of 32 for K2/K3
    for name in TABLES:
        same(np.asarray(getattr(jds, name)), getattr(tds, name).numpy(), name)


def test_comparison_sees_one_changed_value():
    """`same` is not vacuous: one vertex moved by one ulp, one light colour
    component and one material param changed are each caught."""
    jax_scene, port_scene = _both_scenes(COFFEETABLE)
    port_scene.positions[0][0, 0] = np.nextafter(port_scene.positions[0][0, 0], np.float32(np.inf))
    with pytest.raises(AssertionError, match="positions"):
        same(jax_scene, port_scene, "scene")
    jax_scene, port_scene = _both_scenes(COFFEETABLE)
    port_scene.lights[1].color[0] *= 1.0 + 2.0 ** -20
    with pytest.raises(AssertionError, match="lights"):
        same(jax_scene, port_scene, "scene")
    jax_scene, port_scene = _both_scenes(COFFEETABLE)
    port_scene.materials[0].params["ior"] = 1.25
    with pytest.raises(AssertionError, match="materials"):
        same(jax_scene, port_scene, "scene")
