"""Port device-scene tables against the JAX CPU build, bit for bit.

The tables are host numpy packing (no arithmetic beyond the JAX build's own
numpy), so every table must be BIT-EQUAL.
"""

import dataclasses

import numpy as np
import pytest
import torch

from strelka_tpu.ops import integrator as JI
from strelka_tpu.render.device_scene import build_device_scene as jax_build
from strelka_tpu.scene import testscenes as JTS
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.render.device_scene import (
    TABLES,
    build_device_scene,
    device_scene_from_arrays,
    frame_state_from_arrays,
)
from strelka_tpu_torch.scene import testscenes as TTS

_CORNELL = dict(light_intensity=5000.0, metal_box=True, glass_sphere=True)


@pytest.fixture(scope="module")
def scenes():
    return jax_build(JTS.cornell_box(**_CORNELL)), build_device_scene(TTS.cornell_box(**_CORNELL), device="cpu")


def _assert_bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("table", TABLES)
def test_cornell_table_bit_equal(scenes, table):
    jds, tds = scenes
    _assert_bits_equal(getattr(jds, table), getattr(tds, table).numpy())


def test_cornell_counts(scenes):
    jds, tds = scenes
    assert (tds.num_lights, tds.num_triangles) == (jds.num_lights, jds.num_triangles) == (1, 548)
    assert tds.v0.shape == (640, 3) and tds.attr_table.shape == (640, 68)
    assert tds.mat_table.shape == (5, 24) and tds.light_table.shape == (1, 20)


def test_default_cornell_variant_bit_equal():
    jds = jax_build(JTS.cornell_box())
    tds = build_device_scene(TTS.cornell_box(), device="cpu")
    for table in TABLES:
        _assert_bits_equal(getattr(jds, table), getattr(tds, table).numpy())


def test_device_scene_from_jax_arrays(scenes):
    """The JAX scene carried across field by field gives the same tables."""
    jds, _ = scenes
    arrays = {f.name: np.asarray(getattr(jds, f.name)) for f in dataclasses.fields(jds)
              if not isinstance(getattr(jds, f.name), tuple) or f.name in ("world_lo", "world_hi")}
    ported = device_scene_from_arrays(arrays, "cpu")
    for table in TABLES:
        _assert_bits_equal(getattr(jds, table), getattr(ported, table).numpy())
    assert (ported.num_lights, ported.num_triangles) == (jds.num_lights, jds.num_triangles)


def test_frame_state_round_trip():
    rng = np.random.default_rng(3)
    h, w = 6, 5
    st = JI.FrameState(
        accum=rng.random((3, h, w)).astype(np.float32),
        diffuse=rng.random((3, h, w)).astype(np.float32),
        diffuse_counter=rng.integers(0, 9, (h, w)).astype(np.int32),
        specular=rng.random((3, h, w)).astype(np.float32),
        specular_counter=rng.integers(0, 9, (h, w)).astype(np.int32),
    )
    ported = frame_state_from_arrays({k: np.asarray(v) for k, v in st._asdict().items()}, "cpu")
    assert isinstance(ported, TI.FrameState)
    for k, v in st._asdict().items():
        _assert_bits_equal(v, getattr(ported, k).numpy())
    back = frame_state_from_arrays({k: v.numpy() for k, v in ported._asdict().items()}, "cpu")
    for k in st._fields:
        assert torch.equal(getattr(back, k), getattr(ported, k))


def test_later_slice_scenes_raise():
    with pytest.raises(NotImplementedError, match="A.8"):
        build_device_scene(TTS.box_field(grid=10), device="cpu")
    with pytest.raises(NotImplementedError, match="A.9"):
        build_device_scene(TTS.hair_patch(n_curves=4), device="cpu")


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_device_scene(TTS.cornell_box())
