"""The port's kitchen generator (strelka_tpu_torch/scene/kitchen_gen.py)
against the JAX package's (strelka_tpu/scene/kitchen_gen.py).

Each generator writes the stage once for the module into its own temporary
directory (about 2 s each). The port's files must be byte-equal to the JAX
generator's: kitchen.usdc through the port's crate writer, the four PNGs
through utils/image.py:write_png(as_pil=True), PIL's encoder rebuilt on
zlib. The committed data/gen/kitchen/ stage came from an older writer: its
kitchen.usdc differs in bytes and, read back, only by the root's
defaultPrim, which the loader does not read, so both load into equal scenes.
"""

import hashlib
import os

import pytest

from strelka_tpu.scene.kitchen_gen import build_kitchen_stage as jax_build_kitchen_stage
from strelka_tpu_torch.loaders.crate import read_usdc
from strelka_tpu_torch.loaders.usd import UsdLoader
from strelka_tpu_torch.scene.kitchen import KITCHEN_TEXTURES, ensure_kitchen, kitchen_dir
from strelka_tpu_torch.scene.scene import Scene

from test_torch_usd import same

_FILES = ("kitchen.usdc",) + tuple(os.path.join("textures", t) for t in KITCHEN_TEXTURES)


def _digests(root):
    out = {}
    for rel in _FILES:
        with open(os.path.join(root, rel), "rb") as f:
            out[rel] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    committed = _digests(kitchen_dir())
    port = str(tmp_path_factory.mktemp("port_kitchen"))
    jax = str(tmp_path_factory.mktemp("jax_kitchen"))
    port_usdc = ensure_kitchen(port)  # nothing there: generated by the port
    jax_build_kitchen_stage(jax)
    yield port, jax, port_usdc
    assert _digests(kitchen_dir()) == committed, "a generator rewrote the committed stage"


@pytest.mark.parametrize("rel", _FILES)
def test_generated_file_is_byte_equal_to_jax(stages, rel):
    port, jax, _ = stages
    with open(os.path.join(port, rel), "rb") as a, open(os.path.join(jax, rel), "rb") as b:
        assert a.read() == b.read()


def test_generated_stage_is_complete(stages):
    port, _, port_usdc = stages
    assert port_usdc == os.path.join(port, "kitchen.usdc")
    assert ensure_kitchen(port) == port_usdc  # complete now: taken as it is
    assert _digests(port) == _digests(stages[1])


def test_committed_stage_loads_as_the_generated_one(stages):
    """The committed kitchen.usdc and the regenerated one differ in bytes;
    their trees differ only by the root's defaultPrim (the committed file
    has none), and the two load into equal scenes."""
    _, _, port_usdc = stages
    committed = os.path.join(kitchen_dir(), "kitchen.usdc")
    old, new = read_usdc(committed), read_usdc(port_usdc)
    assert "defaultPrim" not in old.metadata and new.metadata.pop("defaultPrim") == "World"
    same(old, new, "root")
    scenes = []
    for path in (committed, port_usdc):
        scene = Scene()
        assert UsdLoader().load(path, scene)
        scenes.append(scene)
    assert scenes[1].model_path == port_usdc
    scenes[1].model_path = committed  # the one field that names the file read
    same(scenes[0], scenes[1], "scene")
