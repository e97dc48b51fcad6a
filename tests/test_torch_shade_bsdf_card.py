"""Kernel K10 (kernels/shade.py, csrc/shade.cu) against its plain version on the card.

(a) Random lanes (tests/torch_lanes.py:random_bsdf_lanes) of each material
    type alone and all mixed, through each of the three kernel instances (no
    fibre, the Chiang fibre, the Kajiya-Kay fibre: the last, in the kernel
    and in its plain version, through ops/bsdf.py's switch), at depth 0 and
    at a later depth: every output bit-equal to
    shade_bsdf_plain on the lanes that hit a surface, the masks and the
    path state on every lane. The lanes hold mirrors, glass from inside
    (total internal reflection) and thin-walled, the cutout (opacity under
    1), k1 below the surface and emissive lanes.
(b) The same at N of 1, 1,023, 2^19 and 2^20 + 3.
(c) Whole launches of Cornell 64x64, kitchen 128x96 and hair_patch 64x64
    through TorchRender (eager, captured, replayed): the images with K10
    bit-equal to those with the plain phase in its place; K10 launched once
    a bounce and the plain phase never run on CUDA.

These tests need a CUDA card and skip without one. The tests' conftest.py
imports jax, which the card's machine lacks; run them there with

    python -m pytest --noconftest -m card tests/test_torch_shade_bsdf_card.py
"""

import numpy as np
import pytest
import torch
import torch_lanes as TL

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import lanes as L
from strelka_tpu_torch.kernels import shade as KS
from strelka_tpu_torch.ops import bsdf as B

TYPES = {"diffuse": (0,), "omni_pbr": (1,), "omni_glass": (2,), "hair": (3,), "mixed": (0, 1, 2, 3)}
VARIANTS = {"no_fibre": L.NO_FIBRE, "chiang": L.CHIANG, "kajiya_kay": L.KAJIYA_KAY}
SIZES = (1, 1023, 2 ** 19, 2 ** 20 + 3)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def held_off(lanes: dict, depth: int, variant: int, monkeypatch) -> dict:
    """K10 and the plain phase on the same lanes, both with the hair lobes of
    the kernel instance `variant` -> the lanes off by output."""
    K.reset_counts()
    with monkeypatch.context() as m:
        m.setattr(B, "_HAIR_KAJIYA_KAY", variant == L.KAJIYA_KAY)
        got = KS.shade_bsdf(**lanes, depth=depth, enable_hair=variant != L.NO_FIBRE)
        assert K.launch_counts["shade_bsdf"] == 1
        assert K.launch_shapes[("shade_bsdf", (lanes["sample_idx"].shape[0], variant))] == 1
        want = KS.shade_bsdf_plain(**lanes, depth=depth, enable_hair=variant != L.NO_FIBRE)
    return TL.lanes_off(got, want, {"smp": lanes["hit_surface"]})


@pytest.mark.card
@pytest.mark.parametrize("depth", (0, 2))
@pytest.mark.parametrize("types", TYPES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_k10_bit_equal_by_material(card, variant, types, depth, monkeypatch):
    lanes = TL.random_bsdf_lanes(65537, 11 + depth, card, TYPES[types])
    off = held_off(lanes, depth, VARIANTS[variant], monkeypatch)
    assert not any(off.values()), off


@pytest.mark.card
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_k10_bit_equal_at_sizes(card, variant, n, monkeypatch):
    for depth in (0, 1):
        lanes = TL.random_bsdf_lanes(n, n % 1009 + depth, card)
        off = held_off(lanes, depth, VARIANTS[variant], monkeypatch)
        assert not any(off.values()), (depth, off)


def _scene(name: str):
    from strelka_tpu_torch.loaders.usd import UsdLoader
    from strelka_tpu_torch.scene import testscenes as TS
    from strelka_tpu_torch.scene.kitchen import ensure_kitchen
    from strelka_tpu_torch.scene.scene import Scene

    if name == "cornell":
        return TS.cornell_box(), (64, 64)
    if name == "hair_patch":
        return TS.hair_patch(), (64, 64)
    host = Scene()
    assert UsdLoader().load(ensure_kitchen(), host)
    return host, (128, 96)


def _images(name: str, device, frames: int = 4):
    """`frames` TorchRender frames of the scene from the same start (1 spp,
    depth 4): the key's eager launch, its capture and replay, replays."""
    from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu_torch.render.render import TorchRender
    from strelka_tpu_torch.settings import SharedContext, make_default_settings

    host, (w, h) = _scene(name)
    s = make_default_settings(w, h)
    s.set("render/pt/spp", 1)
    s.set("render/pt/depth", 4)
    s.set("render/pt/sppTotal", 64)
    r = TorchRender(device=device)
    r.set_scene(host)
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(w, h, BufferFormat.FLOAT4))
    images = []
    for _ in range(frames):
        r.render(buf)
        images.append(buf.map().copy())
    return images


@pytest.mark.card
@pytest.mark.parametrize("name", ("cornell", "kitchen", "hair_patch"))
def test_whole_launch_bit_equal_to_the_plain_phase(card, name, monkeypatch):
    monkeypatch.setattr(K, "count_replays", True)
    K.reset_counts()
    frames = 4
    kernel = _images(name, card, frames)
    assert K.launch_counts["shade_bsdf"] == 4 * frames  # one a bounce, replays counted
    assert K.plain_cuda_calls["shade_bsdf"] == 0
    monkeypatch.setattr(KS, "shade_bsdf", KS.shade_bsdf_plain)
    K.reset_counts()
    plain = _images(name, card, frames)
    assert K.launch_counts["shade_bsdf"] == 0 and K.plain_cuda_calls["shade_bsdf"] > 0
    assert all(np.isfinite(a).all() for a in kernel)
    off = [int((a.view(np.int32) != b.view(np.int32)).sum()) for a, b in zip(kernel, plain)]
    assert not any(off), off
