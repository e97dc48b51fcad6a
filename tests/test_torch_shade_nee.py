"""Kernels K11 and K12's wrappers (kernels/nee.py) on the CPU: CPU tensors go to
the plain versions, a wrong method or light count is refused, and the plain
phase split around the shadow sweep computes what the phase computed in one
piece, lane by lane and in whole renders. The refusals, counters and field
order shared by the lane kernels are in tests/test_torch_lanes.py; the kernels
themselves are held against the plain versions on the card
(tests/test_torch_shade_nee_card.py)."""

import os

import numpy as np
import pytest
import torch
import torch_lanes as TL

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import nee as KN
from strelka_tpu_torch.ops import bsdf as B
from strelka_tpu_torch.ops import light_sampling as LS
from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.intersect import offset_ray_vec

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "strelka_tpu_torch", "csrc")


def _one_piece(stash: dict):
    """The NEE phase as the integrator ran it in one piece, its two halves cut
    at the sweep without moving an operation: (light half, shade half), with
    nee_light's and nee_shade's signatures, the second reading what the first
    left in `stash`."""

    def light(shade, event_type, u_light, u_x, u_y, position, frame, is_curve, prim, light_table, *, num_lights,
              method):
        nee_able = shade & ((event_type & (B.BSDF_EVENT_DIFFUSE | B.BSDF_EVENT_GLOSSY)) != 0)
        light_id = torch.clamp((num_lights * u_light).to(torch.int32), 0, num_lights - 1)
        lp = LS.gather_light(light_table, light_id)
        ls = LS.sample_light(lp, u_x, u_y, position, method)
        to_light = ls.L
        li_all_nonzero = V.all_nonzero(lp.color)
        cos_nl = V.dot(frame.normal, to_light)
        geom_ok = (cos_nl > 0.0) & (-V.dot(to_light, ls.normal) > 0.0) & li_all_nonzero
        shadow_org = offset_ray_vec(position, frame.geom_normal)
        shadow_excl = torch.where(is_curve, -1, prim)
        stash.update(nee_able=nee_able, lp=lp, ls=ls, cos_nl=cos_nl, geom_ok=geom_ok, num_lights=num_lights)
        return KN.NeeLight(shadow_org, to_light, ls.dist_to_light, shadow_excl, nee_able & geom_ok, nee_able,
                           None, None)

    def shade_(nl, occluded, inside, mat, frame, direction, radiance, throughput, shade, light_table, *,
               enable_hair):
        n, dev = occluded.shape[0], occluded.device
        nee_able, lp, ls, cos_nl, geom_ok = (stash[k] for k in ("nee_able", "lp", "ls", "cos_nl", "geom_ok"))
        num_lights = stash["num_lights"]
        visibility = torch.where(geom_ok & ~occluded, 1.0, 0.0)
        nee_w = visibility * torch.clamp(cos_nl, 0.0, 1.0)
        nee_radiance = lp.color * nee_w
        light_pdf = torch.where(geom_ok, ls.pdf, 0.0) * (1.0 / num_lights)
        nan1 = nee_able & (V.any_nan(nee_radiance) | torch.isnan(light_pdf))
        next_event_valid = ((cos_nl > 0.0) != inside) & (light_pdf != 0.0) & nee_able
        ev = B.bsdf_evaluate(mat, frame, -direction, ls.L, enable_hair=enable_hair)
        nan2 = nee_able & (V.any_nan(ev.bsdf_diffuse) | V.any_nan(ev.bsdf_glossy))
        contribute = next_event_valid & (ev.pdf > 0.0) & ~nan1 & ~nan2
        inv_lpdf = 1.0 / torch.clamp(light_pdf, min=1e-20)
        mis_w = LS.mis_weight_balance(torch.clamp(light_pdf, min=1e-20), ev.pdf)
        nee_contrib = throughput * nee_radiance * (inv_lpdf * mis_w) * (ev.bsdf_diffuse + ev.bsdf_glossy)
        radiance = V.where(contribute, radiance + nee_contrib, radiance)
        canary = nan1 | nan2
        radiance = V.where(canary, V.splat((1e4, 0.0, 0.0), n, dev), radiance)
        throughput = V.where(canary, V.full(n, 0.0, dev), throughput)
        return KN.NeeShaded(radiance, throughput, shade & ~canary)

    return light, shade_


@pytest.mark.parametrize("enable_hair", (False, True))
@pytest.mark.parametrize("method", KN.METHODS)
@pytest.mark.parametrize("n", (1, 257))
def test_cpu_tensors_take_the_plain_versions(n, method, enable_hair):
    lanes = TL.random_nee_lanes(n, 3 + n + method, "cpu", nan_share=0.05)
    K.reset_counts()
    nl = KN.nee_light(**TL.light_args(lanes), method=method)
    assert not any(TL.lanes_off(nl, KN.nee_light_plain(**TL.light_args(lanes), method=method)).values())
    got = KN.nee_shade(nl, **TL.shade_args(lanes), enable_hair=enable_hair)
    want = KN.nee_shade_plain(nl, **TL.shade_args(lanes), enable_hair=enable_hair)
    assert not any(TL.lanes_off(got, want).values())
    for name in ("nee_light", "nee_shade"):
        assert K.launch_counts[name] == 0 and K.plain_cuda_calls[name] == 0
    assert nl.light_id.dtype == torch.int32 and nl.exclude.dtype == torch.int32 and got.shade.dtype == torch.bool
    assert not (nl.active & ~nl.nee_able).any() and not (got.shade & ~lanes["shade"]).any()


@pytest.mark.parametrize("hair", ("none", "chiang", "kajiya_kay"))
@pytest.mark.parametrize("num_lights", (1, 4))
@pytest.mark.parametrize("method", KN.METHODS)
def test_split_phase_is_the_phase_in_one_piece(method, num_lights, hair, monkeypatch):
    """Every output of the split plain phase bit-equal to the phase in one
    piece, on every lane: lights of every type, NaN colours and materials."""
    monkeypatch.setattr(B, "_HAIR_KAJIYA_KAY", hair == "kajiya_kay")
    lanes = TL.random_nee_lanes(2000, 40 + 2 * num_lights + method, "cpu", num_lights=num_lights, nan_share=0.03)
    light, shade_ = _one_piece({})
    whole_nl = light(**TL.light_args(lanes), method=method)
    whole = shade_(whole_nl, **TL.shade_args(lanes), enable_hair=hair != "none")
    nl = KN.nee_light_plain(**TL.light_args(lanes), method=method)
    split = KN.nee_shade_plain(nl, **TL.shade_args(lanes), enable_hair=hair != "none")
    # the one piece has no light_pdf or light_id here: the shade half's outputs hold them
    off = TL.lanes_off(nl, whole_nl._replace(light_pdf=nl.light_pdf, light_id=nl.light_id))
    assert not any(off.values()), off
    assert not any(TL.lanes_off(split, whole).values()), TL.lanes_off(split, whole)
    assert (split.shade != lanes["shade"]).any() and (split.radiance.x == 1e4).any()  # a canary fired


def _render(name: str, frames: int = 2):
    from strelka_tpu_torch.loaders.usd import UsdLoader
    from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu_torch.render.render import TorchRender
    from strelka_tpu_torch.scene import testscenes as TS
    from strelka_tpu_torch.scene.scene import Scene
    from strelka_tpu_torch.settings import SharedContext, make_default_settings

    if name == "coffeetable":
        scene = Scene()
        assert UsdLoader().load(os.path.join(os.path.dirname(CSRC), "..", "data", "scenes", "coffeetable.usda"), scene)
    else:
        scene = TS.cornell_box() if name.startswith("cornell") else TS.hair_patch(n_curves=16)
    s = make_default_settings(16, 16)
    s.set("render/pt/spp", 1)
    s.set("render/pt/depth", 4)
    s.set("render/pt/sppTotal", 64)
    s.set("render/pt/rectLightSamplingMethod", int(name.endswith("_sq")))
    r = TorchRender(device="cpu")
    r.set_scene(scene)
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(16, 16, BufferFormat.FLOAT4))
    images = []
    for _ in range(frames):
        r.render(buf)
        images.append(buf.map().copy())
    return images


@pytest.mark.parametrize("name", ("cornell", "cornell_sq", "hair_patch", "coffeetable"))
def test_render_split_phase_bit_equal_to_the_phase_in_one_piece(name, monkeypatch):
    torch.set_num_threads(1)  # torch 2.13's CPU first-call sqrt fault (ROADMAP C)
    split = _render(name)
    light, shade_ = _one_piece({})
    monkeypatch.setattr(KN, "nee_light", light)
    monkeypatch.setattr(KN, "nee_shade", shade_)
    whole = _render(name)
    assert all(np.isfinite(a).all() for a in split)
    off = [int((a.view(np.int32) != b.view(np.int32)).sum()) for a, b in zip(split, whole)]
    assert not any(off), off


def test_method_variant_and_lights_refused():
    lanes = TL.random_nee_lanes(8, 1, "cpu")
    with pytest.raises(ValueError, match="no rect light sampling method"):
        KN.nee_light(**TL.light_args(lanes), method=2)
    with pytest.raises(ValueError, match="without lights"):
        KN.nee_light(**{**TL.light_args(lanes), "num_lights": 0}, method=0)

