"""Kernel K13 (kernels/surface.py, csrc/surface.cu) against its plain version on the card.

(a) Random lanes (tests/torch_lanes.py:random_surface_lanes) through each of the six
    kernel instances (curves or not, the refinement or not, the uv outputs or
    not), at bounce 0 and later, with one light and four: every output
    bit-equal to shade_surface_plain on every lane. The lanes hold misses,
    dead lanes, triangle hits from inside and outside with barycentrics in and
    out of the triangle, light hits of every light type, and curve hits whose
    refinement converges, grazes or finds a ghost, beside nearer and farther
    triangles.
(b) The same for every instance at N of 1, 1,023, 196,608, 786,432 (the
    benchmark's wavefronts) and 2^20 + 3.
(c) Whole launches of Cornell 64x64, kitchen 128x96 and hair_patch 64x64
    through TorchRender (eager, captured, replayed): the images with K13
    bit-equal to those with the plain phase in its place; K13 launched once a
    bounce and the plain phase never run on CUDA.

These tests need a CUDA card and skip without one. The tests' conftest.py
imports jax, which the card's machine lacks; run them there with

    python -m pytest --noconftest -m card tests/test_torch_shade_surface_card.py
"""

import numpy as np
import pytest
import torch
import torch_lanes as TL

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import surface as KSF

# (curves, refine, uv): the kernel's instances
INSTANCES = {"triangles": (False, False, False), "textured": (False, False, True), "curves": (True, False, False),
             "curves_refined": (True, True, False), "curves_textured": (True, False, True),
             "curves_refined_textured": (True, True, True)}
SIZES = (1, 1023, 196608, 786432, 2 ** 20 + 3)


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def surface_off(lanes: dict, depth: int) -> dict:
    """K13 and its plain version on the same lanes -> the lanes off by output."""
    K.reset_counts()
    got = KSF.shade_surface(**lanes, depth=depth)
    assert K.launch_counts["shade_surface"] == 1 and K.plain_cuda_calls["shade_surface"] == 0
    return TL.lanes_off(got, KSF.shade_surface_plain(**lanes, depth=depth))


@pytest.mark.card
@pytest.mark.parametrize("num_lights", (1, 4))
@pytest.mark.parametrize("depth", (0, 1))
@pytest.mark.parametrize("instance", INSTANCES)
def test_k13_bit_equal_by_instance(card, instance, depth, num_lights):
    curves, refine, uv = INSTANCES[instance]
    lanes = TL.random_surface_lanes(65537, 31 + depth + 2 * num_lights, card, curves=curves, refine=refine, uv=uv,
                             num_lights=num_lights)
    off = surface_off(lanes, depth)
    assert not any(off.values()), off


@pytest.mark.card
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("instance", INSTANCES)
def test_k13_bit_equal_at_sizes(card, instance, n):
    curves, refine, uv = INSTANCES[instance]
    lanes = TL.random_surface_lanes(n, n % 1009, card, curves=curves, refine=refine, uv=uv)
    off = surface_off(lanes, 1)
    assert not any(off.values()), off


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
    assert K.launch_counts["shade_surface"] == 4 * frames  # one a bounce, replays counted
    assert K.plain_cuda_calls["shade_surface"] == 0
    monkeypatch.setattr(KSF, "shade_surface", KSF.shade_surface_plain)
    K.reset_counts()
    plain = _images(name, card, frames)
    assert K.launch_counts["shade_surface"] == 0 and K.plain_cuda_calls["shade_surface"] > 0
    assert all(np.isfinite(a).all() for a in kernel)
    off = [int((a.view(np.int32) != b.view(np.int32)).sum()) for a, b in zip(kernel, plain)]
    assert not any(off), off
