"""Kernels K11 and K12 (kernels/nee.py, csrc/nee.cu) against their plain versions on the card.

(a) Random lanes (tests/torch_lanes.py:random_nee_lanes) of each light type alone and
    all mixed (rect lights by both sampling methods, a disc), one light and
    four, with NaN planted in a light's colour and in the materials (both
    canaries), through K11 and then, on K11's handoff, through each of the
    three instances of K12 (no fibre, the Chiang fibre, the Kajiya-Kay fibre:
    the last, in the kernel and in its plain version, through ops/bsdf.py's
    switch) on lanes of each material type: every output
    bit-equal to nee_light_plain and nee_shade_plain on every lane. The
    lanes hold `inside` both ways, normals facing away from the light and
    lights facing away from the lane, positions inside sphere lights and far
    away, occluded lanes and lanes that are not nee_able.
(b) The same at N of 1, 1,023, 2^19 and 2^20 + 3.
(c) Whole launches of Cornell 64x64, kitchen 128x96 and hair_patch 64x64
    through TorchRender (eager, captured, replayed): the images with K11 and
    K12 bit-equal to those with the plain phase in their place; each kernel
    launched once a bounce and the plain phase never run on CUDA.

These tests need a CUDA card and skip without one. The tests' conftest.py
imports jax, which the card's machine lacks; run them there with

    python -m pytest --noconftest -m card tests/test_torch_shade_nee_card.py
"""

import numpy as np
import pytest
import torch
import torch_lanes as TL

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import lanes as L
from strelka_tpu_torch.kernels import nee as KN
from strelka_tpu_torch.ops import bsdf as B

LIGHTS = {"rect": (0,), "disc": (1,), "sphere": (2,), "distant": (3,), "mixed": (0, 1, 2, 3)}
TYPES = {"diffuse": (0,), "omni_pbr": (1,), "omni_glass": (2,), "hair": (3,), "mixed": (0, 1, 2, 3)}
VARIANTS = {"no_fibre": L.NO_FIBRE, "chiang": L.CHIANG, "kajiya_kay": L.KAJIYA_KAY}
SIZES = (1, 1023, 2 ** 19, 2 ** 20 + 3)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def light_off(lanes: dict, method: int) -> tuple:
    """K11 and its plain version on the same lanes -> (K11's handoff, the lanes off by output)."""
    K.reset_counts()
    got = KN.nee_light(**TL.light_args(lanes), method=method)
    assert K.launch_counts["nee_light"] == 1
    return got, TL.lanes_off(got, KN.nee_light_plain(**TL.light_args(lanes), method=method))


def shade_off(lanes: dict, nl, variant: int, monkeypatch) -> dict:
    """K12 and its plain version on the same lanes and handoff, both with the
    hair lobes of the kernel instance `variant` -> the lanes off by output."""
    K.reset_counts()
    with monkeypatch.context() as m:
        m.setattr(B, "_HAIR_KAJIYA_KAY", variant == L.KAJIYA_KAY)
        got = KN.nee_shade(nl, **TL.shade_args(lanes), enable_hair=variant != L.NO_FIBRE)
        assert K.launch_counts["nee_shade"] == 1
        assert K.launch_shapes[("nee_shade", (lanes["occluded"].shape[0], variant))] == 1
        want = KN.nee_shade_plain(nl, **TL.shade_args(lanes), enable_hair=variant != L.NO_FIBRE)
    return TL.lanes_off(got, want)


@pytest.mark.card
@pytest.mark.parametrize("num_lights", (1, 4))
@pytest.mark.parametrize("method", KN.METHODS)
@pytest.mark.parametrize("lights", LIGHTS)
def test_k11_bit_equal_by_light(card, lights, method, num_lights):
    lanes = TL.random_nee_lanes(65537, 5 + method + num_lights, card, light_types=LIGHTS[lights],
                            num_lights=num_lights, nan_share=0.02)
    _, off = light_off(lanes, method)
    assert not any(off.values()), off


@pytest.mark.card
@pytest.mark.parametrize("types", TYPES)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("method", KN.METHODS)
def test_k12_bit_equal_by_material(card, method, variant, types, monkeypatch):
    lanes = TL.random_nee_lanes(65537, 17 + method, card, TYPES[types], nan_share=0.02)
    nl, off = light_off(lanes, method)
    assert not any(off.values()), off
    off = shade_off(lanes, nl, VARIANTS[variant], monkeypatch)
    assert not any(off.values()), off


@pytest.mark.card
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("variant", VARIANTS)
def test_k11_k12_bit_equal_at_sizes(card, variant, n, monkeypatch):
    for method in KN.METHODS:
        lanes = TL.random_nee_lanes(n, n % 1009 + method, card, nan_share=0.01)
        nl, off = light_off(lanes, method)
        assert not any(off.values()), (method, off)
        off = shade_off(lanes, nl, VARIANTS[variant], monkeypatch)
        assert not any(off.values()), (method, off)


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
    for kname in ("nee_light", "nee_shade"):
        assert K.launch_counts[kname] == 4 * frames  # one a bounce, replays counted
        assert K.plain_cuda_calls[kname] == 0
    monkeypatch.setattr(KN, "nee_light", KN.nee_light_plain)
    monkeypatch.setattr(KN, "nee_shade", KN.nee_shade_plain)
    K.reset_counts()
    plain = _images(name, card, frames)
    assert K.launch_counts["nee_light"] == 0 and K.launch_counts["nee_shade"] == 0
    assert K.plain_cuda_calls["nee_light"] > 0 and K.plain_cuda_calls["nee_shade"] > 0
    assert all(np.isfinite(a).all() for a in kernel)
    off = [int((a.view(np.int32) != b.view(np.int32)).sum()) for a, b in zip(kernel, plain)]
    assert not any(off), off
