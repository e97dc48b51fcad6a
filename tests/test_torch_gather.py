"""Port row gather (plain version of kernel K4) against the JAX package.

A gather copies, so it must be BIT-EQUAL to pallas_gather_rows_t (interpret
mode; it clips indices to [0, T-1]) and to ops.vec.gather_rows_t (the JAX
CPU path; in-range indices).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strelka_tpu.ops import vec as JV
from strelka_tpu.ops.pallas_gather import pallas_gather_rows_t
from strelka_tpu.render.device_scene import build_device_scene as jax_build
from strelka_tpu.scene import testscenes as JTS
from strelka_tpu_torch.kernels import gather as KG
from strelka_tpu_torch.ops import vec as TV


@pytest.fixture(scope="module")
def attr_table():
    ds = jax_build(JTS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True))
    return np.asarray(ds.attr_table)


def _bits(a):
    return np.asarray(a).view(np.uint32)


def test_gather_matches_pallas_interpret(attr_table):
    rng = np.random.default_rng(0)
    idx = rng.integers(-5, attr_table.shape[0] + 5, 1000).astype(np.int32)  # some out of range
    ref = pallas_gather_rows_t(jnp.asarray(attr_table), jnp.asarray(idx), tile=512, interpret=True)
    out = TV.gather_rows_t(torch.tensor(attr_table), torch.tensor(idx))
    assert out.shape == (attr_table.shape[1], idx.size)
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize("cols", [20, 24, 68])
def test_gather_matches_vec_gather_rows_t(cols):
    rng = np.random.default_rng(cols)
    table = rng.normal(size=(300, cols)).astype(np.float32)
    table[0, :3] = [0.0, -0.0, 1e-30]  # signed zero and a tiny value ride unchanged
    idx = rng.integers(0, 300, 4096).astype(np.int32)
    ref = JV.gather_rows_t(jnp.asarray(table), jnp.asarray(idx))
    out = KG.gather_rows_t(torch.tensor(table), torch.tensor(idx))
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))


@pytest.mark.parametrize("cols,n,offset", KG.GATHER_EDGES)
def test_gather_edge_shapes_match_vec_gather_rows_t(cols, n, offset):
    rng = np.random.default_rng(cols * 7 + n % 97 + offset)
    rows = 300
    buf = rng.normal(size=offset + rows * cols).astype(np.float32)
    table = torch.tensor(buf)[offset:].view(rows, cols)
    assert table.is_contiguous() and table.storage_offset() == offset
    idx = rng.integers(0, rows, n).astype(np.int32)
    ref = JV.gather_rows_t(jnp.asarray(table.numpy()), jnp.asarray(idx))
    out = KG.gather_rows_t_plain(table, torch.tensor(idx))
    assert out.shape == (cols, n) and out.is_contiguous()
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(ref))
