"""Port sampler (strelka_tpu_torch.ops.sampler) against the JAX sampler.

Everything here is integer bit math, so the port must be BIT-EQUAL: no
tolerance. Inputs come from a numpy seed and go through both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strelka_tpu.ops import sampler as JS
from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.ops import sampler as TS

_EDGES = np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32)


def _indices(seed: int, n: int = 4096) -> np.ndarray:
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    return np.concatenate([_EDGES, idx])


def _t(a: np.ndarray) -> torch.Tensor:
    """u32 numpy -> the port's int64 carrier."""
    return torch.tensor(a.astype(np.int64))


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


@pytest.mark.parametrize("depth", range(6))
def test_random_dims_bit_equal(depth):
    idx = _indices(depth)
    dims = (0, 1, 2, 3, 4)
    ref = np.asarray(JS.random_dims(jnp.asarray(idx), depth, dims))
    out = TS.random_dims(_t(idx), depth, dims).numpy()
    assert out.dtype == np.float32 and out.shape == (5, idx.size)
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_random_dims_pixel_jitter_dims():
    """The camera jitter draw (ePixelX, ePixelY) at depth 0, and dims given
    unfolded (Dim % 5 happens inside)."""
    idx = _indices(11)
    ref = np.asarray(JS.random_dims(jnp.asarray(idx), 0, (0, 1)))
    out = TS.random_dims(_t(idx), 0, (TS.SampleDimension.ePixelX, TS.SampleDimension.ePixelY)).numpy()
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    ref9 = np.asarray(JS.random_dims(jnp.asarray(idx), 2, (9, 7)))
    out9 = TS.random_dims(_t(idx), 2, (9, 7)).numpy()
    np.testing.assert_array_equal(_bits(out9), _bits(ref9))


def test_random_dims_on_cpu_runs_no_kernel():
    K.reset_counts()
    TS.random_dims(_t(_indices(3, 64)), 1, (0, 1, 2, 3, 4))
    assert K.launch_counts["sobol"] == 0
    assert K.plain_cuda_calls["sobol"] == 0


def test_make_sample_index_bit_equal():
    rng = np.random.default_rng(5)
    px = rng.integers(0, 4096, 4096).astype(np.uint32)
    py = rng.integers(0, 4096, 4096).astype(np.uint32)
    for sample_index, max_count in ((0, 1), (7, 16), (123, 100000), (2**20 + 5, 2**16 + 3)):
        ref = np.asarray(JS.make_sample_index(jnp.asarray(px), jnp.asarray(py), sample_index, max_count))
        out = TS.make_sample_index(_t(px), _t(py), sample_index, max_count).numpy()
        np.testing.assert_array_equal(out, ref.astype(np.int64))


def test_hashes_bit_equal():
    idx = _indices(7)
    np.testing.assert_array_equal(TS.hash_u32(_t(idx)).numpy(), np.asarray(JS.hash_u32(jnp.asarray(idx))).astype(np.int64))
    seeds = _indices(8)
    np.testing.assert_array_equal(
        TS.hash_combine(_t(seeds), _t(idx)).numpy(),
        np.asarray(JS.hash_combine(jnp.asarray(seeds), jnp.asarray(idx))).astype(np.int64),
    )
    np.testing.assert_array_equal(TS.pcg_hash(_t(idx)).numpy(), np.asarray(JS.pcg_hash(jnp.asarray(idx))).astype(np.int64))


def test_scramble_and_morton_bit_equal():
    idx = _indices(9)
    seed = int(np.asarray(JS.hash_u32(jnp.uint32(55))))
    np.testing.assert_array_equal(
        TS.nested_uniform_scramble(_t(idx), seed).numpy(),
        np.asarray(JS.nested_uniform_scramble(jnp.asarray(idx), jnp.uint32(seed))).astype(np.int64),
    )
    np.testing.assert_array_equal(
        TS.reverse_bits(_t(idx)).numpy(), np.asarray(JS.reverse_bits(jnp.asarray(idx))).astype(np.int64)
    )
    x, y = idx & 0xFFFF, (idx >> 16) & 0xFFFF
    np.testing.assert_array_equal(
        TS.encode_morton2(_t(x), _t(y)).numpy(),
        np.asarray(JS.encode_morton2(jnp.asarray(x), jnp.asarray(y))).astype(np.int64),
    )


@pytest.mark.parametrize("depth", [0, 3])
def test_uniform_hash_bit_equal(depth):
    idx = _indices(20 + depth)
    ref = np.asarray(JS.uniform_hash(jnp.asarray(idx), depth))
    out = TS.uniform_hash(_t(idx), depth).numpy()
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_count_launch_counts_by_name_and_by_shape():
    """A wrapper's one call after a launch feeds both counters; reset_counts clears both."""
    K.reset_counts()
    K.count_launch("sobol", (8, 5))
    K.count_launch("sobol", (8, 5))
    K.count_launch("sobol", (8, 2))
    assert K.launch_counts["sobol"] == 3
    assert K.launch_shapes == {("sobol", (8, 5)): 2, ("sobol", (8, 2)): 1}
    K.reset_counts()
    assert K.launch_counts["sobol"] == 0 and not K.launch_shapes


@pytest.mark.parametrize("dims", [(4, 3, 2, 1, 0), (2, 2), (3, 0, 3, 1, 1), (4,), (1, 4), (0,)])
def test_random_dims_any_list_bit_equal(dims):
    """Lists in any order and with repeats (K1 has one instance per set of
    dimensions drawn and writes each to the rows that name it)."""
    idx = _indices(30 + len(dims))
    ref = np.asarray(JS.random_dims(jnp.asarray(idx), 2, dims))
    out = TS.random_dims(_t(idx), 2, dims).numpy()
    assert out.shape == (len(dims), idx.size)
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_kernel_launch_arguments_once_per_depth_and_dims():
    from strelka_tpu_torch.kernels import sobol as KS

    seed, packed = KS.launch_args(3, (0, 1, 2, 3, 4))
    assert seed == KS.scramble_seed(3) and packed == 0x43210
    assert KS.launch_args(3, (0, 1, 2, 3, 4)) is KS.launch_args(3, (0, 1, 2, 3, 4))  # cached
    assert KS.launch_args(0, (1, 1)) == (KS.scramble_seed(0), 0x11)
    for bad in ((), (5,), (0, 1, 2, 3, 4, 0)):
        with pytest.raises(ValueError, match="dims"):
            KS.launch_args(0, bad)


def test_camera_jitter_is_rows_0_and_1_of_the_depth0_draw(monkeypatch):
    """render_launch draws depth 0 once: its camera jitter (ePixelX, ePixelY)
    is rows 0 and 1 of the (0, 1, 2, 3, 4) draw, bit for bit the (0, 1)
    draw it used to make, and trace_paths takes the whole draw for its
    first bounce."""
    from strelka_tpu_torch.ops import integrator as I
    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.scene import testscenes as TTS

    idx = _t(_indices(40, 512))
    both = TS.random_dims(idx, 0, (0, 1, 2, 3, 4))
    jitter = TS.random_dims(idx, 0, (TS.SampleDimension.ePixelX, TS.SampleDimension.ePixelY))
    assert torch.equal(both[0:2].view(torch.int32), jitter.view(torch.int32))

    host = TTS.cornell_box()
    scene = build_device_scene(host, device="cpu")
    cam = host.get_camera(0)
    cam.update_aspect_ratio(1.0)
    params = I.LaunchParams(0, np.asarray(cam.clip_to_view(), np.float32), np.asarray(cam.view_to_world(), np.float32),
                            np.full(3, 6.25e-4, np.float32), np.zeros(3, np.float32))
    kw = dict(width=4, height=4, samples_per_launch=2, max_sample_count=100000, max_depth=2, enable_accumulation=True)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as tests/test_torch_render.py: torch's CPU first-call sqrt fault (ROADMAP C)
    try:
        with monkeypatch.context() as m:
            calls, cams = [], []
            real_dims, real_cam = I.S.random_dims, I.generate_camera_rays
            m.setattr(I.S, "random_dims", lambda i, depth, dims: calls.append(
                (int(depth), tuple(int(d) for d in dims), real_dims(i, depth, dims))) or calls[-1][2])
            m.setattr(I, "generate_camera_rays", lambda p, px, py, jx, jy, w, h: cams.append((jx, jy)) or real_cam(
                p, px, py, jx, jy, w, h))
            I.render_launch(scene, params, I.make_frame_state(4, 4, "cpu"), **kw)
    finally:
        torch.set_num_threads(threads)
    assert [c[:2] for c in calls] == [(0, (0, 1, 2, 3, 4)), (1, (0, 1, 2, 3, 4))]
    (jx, jy), = cams
    assert torch.equal(jx.view(torch.int32), calls[0][2][0].view(torch.int32))
    assert torch.equal(jy.view(torch.int32), calls[0][2][1].view(torch.int32))
