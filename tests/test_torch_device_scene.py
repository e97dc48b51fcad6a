"""Port device-scene tables against the JAX CPU build, bit for bit.

The tables are host numpy packing (no arithmetic beyond the JAX build's own
numpy), so every table must be BIT-EQUAL. Above 1024 triangles both builds
reorder the triangles into the leaf order of their BVH builder (the same
C++ source compiled with the same flags on this host, or the same numpy
code), so the tables and the threaded BVH are bit-equal too.
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
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)  # a BVH field may be a strided view of the node rows
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
    # textures are the slice still to come; curves and hair materials build
    ds = build_device_scene(TTS.hair_patch(n_curves=4), device="cpu")
    assert ds.has_curves and ds.num_cones == 160 and ds.has_hair
    arrays = {f.name: getattr(ds, f.name) for f in dataclasses.fields(ds)}
    with pytest.raises(NotImplementedError, match="A.7"):
        device_scene_from_arrays({**arrays, "textures": np.zeros((4, 4, 4), np.float32)}, "cpu")
    # a scene above 1024 triangles does not raise: it gets a BVH
    assert build_device_scene(TTS.box_field(grid=3), device="cpu").bvh is not None


_BVH_FIELDS = ("bb_min", "bb_max", "skip", "start", "count")


@pytest.fixture(scope="module")
def box_scenes():
    return jax_build(JTS.box_field(grid=6)), build_device_scene(TTS.box_field(grid=6), device="cpu")


@pytest.mark.parametrize("table", TABLES)
def test_box_field_table_bit_equal(box_scenes, table):
    """6,436 triangles: every per-triangle table is in the BVH's leaf order."""
    jds, tds = box_scenes
    _assert_bits_equal(getattr(jds, table), getattr(tds, table).numpy())


@pytest.mark.parametrize("field", _BVH_FIELDS)
def test_box_field_bvh_bit_equal(box_scenes, field):
    jds, tds = box_scenes
    assert jds.bvh is not None and tds.bvh is not None
    _assert_bits_equal(getattr(jds.bvh, field), getattr(tds.bvh, field).numpy())


def test_box_field_counts_and_leaf_order(box_scenes):
    jds, tds = box_scenes
    assert (tds.num_lights, tds.num_triangles) == (jds.num_lights, jds.num_triangles) == (2, 6436)
    assert tds.v0.shape == (6528, 3) and tds.bvh.nodes.shape == (tds.bvh.num_nodes, 8)
    assert tds.bvh.builder in ("native", "numpy")
    # every real triangle lies inside the box of the leaf that holds it
    start, count = tds.bvh.start.numpy(), tds.bvh.count.numpy()
    leaves = np.nonzero(count > 0)[0]
    assert count[leaves].sum() == tds.num_triangles and count.max() <= 4
    leaf_of = np.repeat(leaves, count[leaves])
    order = np.concatenate([np.arange(start[i], start[i] + count[i]) for i in leaves])
    v0, e1, e2 = (t.numpy()[order] for t in (tds.v0, tds.e1, tds.e2))
    lo, hi = tds.bvh.bb_min.numpy()[leaf_of], tds.bvh.bb_max.numpy()[leaf_of]
    for p in (v0, v0 + e1, v0 + e2):
        assert (p >= lo - 1e-4).all() and (p <= hi + 1e-4).all()
    # the attr table moved with the triangles: its first columns are v0
    np.testing.assert_array_equal(tds.attr_table.numpy()[:, 0:3], tds.v0.numpy())


def test_use_bvh_false_keeps_the_scene_flat():
    jds = jax_build(JTS.box_field(grid=6), use_bvh=False)
    tds = build_device_scene(TTS.box_field(grid=6), device="cpu", use_bvh=False)
    assert tds.bvh is None and jds.bvh is None
    for table in TABLES:
        _assert_bits_equal(getattr(jds, table), getattr(tds, table).numpy())


def test_use_bvh_true_builds_a_tree_for_a_small_scene():
    jds = jax_build(JTS.cornell_box(**_CORNELL), use_bvh=True)
    tds = build_device_scene(TTS.cornell_box(**_CORNELL), device="cpu", use_bvh=True)
    for field in _BVH_FIELDS:
        _assert_bits_equal(getattr(jds.bvh, field), getattr(tds.bvh, field).numpy())
    for table in TABLES:
        _assert_bits_equal(getattr(jds, table), getattr(tds, table).numpy())


@pytest.mark.parametrize("as_dict", [False, True])
def test_device_scene_from_jax_arrays_with_bvh(box_scenes, as_dict):
    """A JAX scene with a BVH carried across: tables and tree arrive bit-equal."""
    jds, tds = box_scenes
    arrays = {f.name: np.asarray(getattr(jds, f.name)) for f in dataclasses.fields(jds)
              if not isinstance(getattr(jds, f.name), tuple) or f.name in ("world_lo", "world_hi")}
    bvh = tuple(np.asarray(x) for x in jds.bvh)
    arrays["bvh"] = dict(zip(_BVH_FIELDS, bvh)) if as_dict else bvh
    ported = device_scene_from_arrays(arrays, "cpu")
    for table in TABLES:
        _assert_bits_equal(getattr(jds, table), getattr(ported, table).numpy())
    for field in _BVH_FIELDS:
        _assert_bits_equal(getattr(jds.bvh, field), getattr(ported.bvh, field).numpy())
    assert ported.bvh.builder == "carried"
    assert torch.equal(ported.bvh.nodes, tds.bvh.nodes)


def test_default_device_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_device_scene(TTS.cornell_box())
