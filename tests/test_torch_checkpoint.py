"""Port checkpoints against the JAX package's: same npz, both ways, and a bit-exact resume.

The file format is the reference's (state_0..state_4 in FrameState field
order, subframe_index, meta_*), so every comparison here is BIT-EQUAL: the
arrays go through numpy unchanged, and a resumed render runs the same
launches on the same accumulator as an uninterrupted one.
"""

import numpy as np
import pytest
import torch

from strelka_tpu.ops import integrator as JI
from strelka_tpu.render import checkpoint as JC
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.render import checkpoint as TC
from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
from strelka_tpu_torch.render.render import TorchRender
from strelka_tpu_torch.scene import testscenes as TTS
from strelka_tpu_torch.settings import SharedContext, make_default_settings

_KEYS = {"state_0", "state_1", "state_2", "state_3", "state_4", "subframe_index"}


def _random_state(rng, h=6, w=5):
    return dict(
        accum=rng.random((3, h, w)).astype(np.float32),
        diffuse=rng.random((3, h, w)).astype(np.float32),
        diffuse_counter=rng.integers(0, 9, (h, w)).astype(np.int32),
        specular=rng.random((3, h, w)).astype(np.float32),
        specular_counter=rng.integers(0, 9, (h, w)).astype(np.int32),
    )


def _assert_state_bits(state, arrays):
    for name, ref in arrays.items():
        got = np.asarray(getattr(state, name))
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_array_equal(got.view(np.uint8), ref.view(np.uint8))


def test_save_load_round_trip(tmp_path):
    arrays = _random_state(np.random.default_rng(0))
    state = TI.FrameState(**{k: torch.tensor(v) for k, v in arrays.items()})
    path = str(tmp_path / "ckpt.npz")
    TC.save_checkpoint(path, state, 12, meta={"scene": "cornell", "spp": 4})
    with np.load(path) as data:
        assert set(data.files) == _KEYS | {"meta_scene", "meta_spp"}
        assert data["subframe_index"].dtype == np.int64
    loaded, subframe = TC.load_checkpoint(path, "cpu")
    assert isinstance(loaded, TI.FrameState) and subframe == 12
    _assert_state_bits(loaded, arrays)
    assert all(t.device.type == "cpu" for t in loaded)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    arrays = _random_state(np.random.default_rng(1))
    path = str(tmp_path / "jax.npz")
    JC.save_checkpoint(path, JI.FrameState(**arrays), 40)
    loaded, subframe = TC.load_checkpoint(path, "cpu")
    assert subframe == 40
    _assert_state_bits(loaded, arrays)


def test_port_checkpoint_loads_in_the_jax_package(tmp_path):
    arrays = _random_state(np.random.default_rng(2))
    path = str(tmp_path / "torch.npz")
    TC.save_checkpoint(path, TI.FrameState(**{k: torch.tensor(v) for k, v in arrays.items()}), 7)
    loaded, subframe = JC.load_checkpoint(path)
    assert subframe == 7
    _assert_state_bits(loaded, arrays)


def _renderer(spp_total):
    s = make_default_settings(16, 16)
    s.set("render/pt/sppTotal", spp_total)
    s.set("render/pt/spp", 1)
    r = TorchRender(device="cpu")
    r.set_scene(TTS.cornell_box())
    r.set_shared_context(SharedContext(s))
    return r, r.create_buffer(BufferDesc(16, 16, BufferFormat.FLOAT4))


def test_resume_is_bit_exact(tmp_path):
    """3 launches in one renderer == 2 launches, a checkpoint, and the third launch in a fresh renderer."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # torch's multi-threaded CPU sqrt can differ on a first call (ROADMAP.md, C)
    try:
        straight, buf = _renderer(3)
        for _ in range(3):
            straight.render(buf)
        want = buf.map().copy()

        first, buf1 = _renderer(3)
        with pytest.raises(RuntimeError, match="nothing rendered"):
            first.save_checkpoint(str(tmp_path / "none.npz"))
        first.render(buf1)
        first.render(buf1)
        path = str(tmp_path / "resume.npz")
        first.save_checkpoint(path)

        second, buf2 = _renderer(3)
        second.load_checkpoint(path)
        assert second.get_shared_context().subframe_index == 2
        second.render(buf2)
    finally:
        torch.set_num_threads(threads)
    assert second.get_shared_context().subframe_index == 3
    np.testing.assert_array_equal(buf2.map().view(np.uint32), want.view(np.uint32))
    for a, b in zip(second._state, straight._state):
        assert torch.equal(a, b)
