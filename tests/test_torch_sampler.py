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
