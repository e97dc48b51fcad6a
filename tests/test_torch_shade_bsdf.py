"""Kernel K10's wrapper (kernels/shade.py) on the CPU: CPU tensors go to the
plain version, wrong inputs are refused before either runs, the counters
know the kernel, and the CUDA source's constants and argument order match
the Python side's. The kernel itself is held against the plain version on
the card (tests/test_torch_shade_bsdf_card.py)."""

import math
import os
import re

import pytest
import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import shade as KS
from strelka_tpu_torch.ops import bsdf as B
from strelka_tpu_torch.ops import hair as H

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "strelka_tpu_torch", "csrc")


def _read(name: str) -> str:
    with open(os.path.join(CSRC, name), encoding="utf-8") as f:
        return f.read()


@pytest.mark.parametrize("enable_hair", (False, True))
@pytest.mark.parametrize("depth", (0, 3))
@pytest.mark.parametrize("n", (1, 257))
def test_cpu_tensors_take_the_plain_version(n, depth, enable_hair):
    lanes = KS.random_lanes(n, 5 + n + depth, "cpu")
    K.reset_counts()
    got = KS.shade_bsdf(**lanes, depth=depth, enable_hair=enable_hair)
    want = KS.shade_bsdf_plain(**lanes, depth=depth, enable_hair=enable_hair)
    assert not any(KS.lanes_off(got, want, lanes["hit_surface"]).values())
    assert K.launch_counts["shade_bsdf"] == 0 and K.plain_cuda_calls["shade_bsdf"] == 0
    assert got.first_event.dtype == torch.int32 and got.smp.event_type.dtype == torch.int32
    assert not (got.shade & ~lanes["hit_surface"]).any() and not (got.cut & ~lanes["hit_surface"]).any()


def test_the_plain_version_is_the_integrators_phase():
    """The phase's pieces as the integrator ran them before K10, step by step."""
    lanes = KS.random_lanes(300, 2, "cpu")
    got = KS.shade_bsdf_plain(**lanes, depth=0, enable_hair=False)
    mat, d = lanes["mat"], lanes["direction"]
    ior1 = torch.where(lanes["inside"], mat.ior, 1.0)
    ior2 = torch.where(lanes["inside"], 1.0, mat.ior)
    smp = B.bsdf_sample(mat, lanes["frame"], -d, lanes["xi"], ior1, ior2)
    keep = lanes["hit_surface"] & ~got.cut
    assert torch.equal(got.smp.pdf[keep], smp.pdf[keep]) and torch.equal(got.smp.k2.x[keep], smp.k2.x[keep])
    assert (got.smp.event_type[got.cut] == B.BSDF_EVENT_SPECULAR_TRANSMISSION).all()
    assert torch.equal(got.smp.k2.y[got.cut], d.y[got.cut])
    absorbed = lanes["hit_surface"] & (got.smp.event_type == B.BSDF_EVENT_ABSORB)
    assert (got.first_event[absorbed] == B.EventType.eAbsorb).all()
    assert (got.throughput.z[absorbed] == 0.0).all()
    assert torch.equal(got.throughput.z[~absorbed], lanes["throughput"].z[~absorbed])


def _lanes_with(name: str, value):
    lanes = KS.random_lanes(64, 1, "cpu")
    mat = lanes["mat"]
    if name in mat._fields:
        lanes["mat"] = mat._replace(**{name: value(getattr(mat, name))})
    else:
        lanes[name] = value(lanes[name])
    return lanes


@pytest.mark.parametrize("name, value", [
    ("metallic", lambda t: t.double()),
    ("bsdf_type", lambda t: t.to(torch.int64)),
    ("sample_idx", lambda t: t.to(torch.int32)),
    ("hit_surface", lambda t: t.to(torch.uint8)),
    ("first_event", lambda t: t.float()),
])
def test_wrong_dtype_refused(name, value):
    with pytest.raises(ValueError, match="shade_bsdf"):
        KS.shade_bsdf(**_lanes_with(name, value), depth=0, enable_hair=False)


@pytest.mark.parametrize("name", ("roughness", "inside", "sample_idx"))
def test_non_contiguous_input_refused(name):
    lanes = _lanes_with(name, lambda t: torch.stack([t, t], dim=1)[:, 0])
    with pytest.raises(ValueError, match="non-contiguous"):
        KS.shade_bsdf(**lanes, depth=0, enable_hair=False)


def test_wrong_length_refused():
    with pytest.raises(ValueError, match="shade_bsdf: ior"):
        KS.shade_bsdf(**_lanes_with("ior", lambda t: t[:-1].contiguous()), depth=0, enable_hair=False)


@pytest.mark.parametrize("name", ("opacity", "specular_bounce"))
def test_mixed_devices_refused(name):
    lanes = _lanes_with(name, lambda t: torch.empty_like(t, device="meta"))
    with pytest.raises(ValueError, match="is on meta"):
        KS.shade_bsdf(**lanes, depth=0, enable_hair=False)


def test_forced_variant_on_the_cpu_refused():
    lanes = KS.random_lanes(8, 1, "cpu")
    with pytest.raises(ValueError, match="plain version"):
        KS.shade_bsdf(**lanes, depth=0, enable_hair=True, variant=KS.KAJIYA_KAY)
    with pytest.raises(ValueError, match="no kernel instance"):
        KS.shade_bsdf(**lanes, depth=0, enable_hair=False, variant=7)


def test_fibre_variant_follows_the_plain_codes_choice(monkeypatch):
    assert KS.fibre_variant(False) == KS.NO_FIBRE
    monkeypatch.setattr(B, "_HAIR_KAJIYA_KAY", False)
    assert KS.fibre_variant(True) == KS.CHIANG
    monkeypatch.setattr(B, "_HAIR_KAJIYA_KAY", True)
    assert KS.fibre_variant(True) == KS.KAJIYA_KAY


def test_counters_know_the_kernel():
    assert "shade_bsdf" in K.KERNEL_NAMES
    K.reset_counts()
    K.count_launch("shade_bsdf", (1023, KS.CHIANG))
    K.note_plain("shade_bsdf", torch.device("cuda"))
    assert K.launch_counts["shade_bsdf"] == 1 and K.launch_shapes[("shade_bsdf", (1023, 1))] == 1
    assert K.plain_cuda_calls["shade_bsdf"] == 1
    K.reset_counts()
    assert K.launch_counts["shade_bsdf"] == 0 and K.plain_cuda_calls["shade_bsdf"] == 0 and not K.launch_shapes


def _enum(text: str, first: str) -> list:
    body = re.search(r"enum : int \{\s*(" + first + r",.*?)\};", text, re.S).group(1)
    return [w.strip() for w in body.split(",") if w.strip()]


@pytest.mark.parametrize("first, fields, count", [("kType", KS.IN_FIELDS, "kInCount"),
                                                  ("kK2X", KS.OUT_FIELDS, "kOutCount")])
def test_argument_order_matches_the_source(first, fields, count):
    names = _enum(_read("shade.cu"), first)
    assert names[-1] == count
    camel = ["k" + "".join(w.capitalize() for w in f.split("_")) for f in fields]
    assert [n.lower() for n in names[:-1]] == [c.lower() for c in camel]


def test_header_constants_are_the_python_modules():
    text = _read("bsdf.cuh")

    def const(name):
        return float(re.search(r"\b" + name + r" = ([-0-9.e]+)", text).group(1))

    for name, value in (("kS1", H._S1), ("kC1", H._C1), ("kS2", H._S2), ("kC2", H._C2), ("kS4", H._S4),
                        ("kC4", H._C4), ("kNegLog2Pi", -math.log(2.0 * H.M_PI)), ("kSqrtPiOver8", H._SQRT_PI_OVER_8),
                        ("kPi", B.M_PI)):
        assert const(name) == value, name
    events = {"kEventAbsorb": B.BSDF_EVENT_ABSORB, "kEventDiffuse": B.BSDF_EVENT_DIFFUSE,
              "kEventGlossy": B.BSDF_EVENT_GLOSSY, "kEventSpecular": B.BSDF_EVENT_SPECULAR,
              "kEventReflection": B.BSDF_EVENT_REFLECTION, "kEventTransmission": B.BSDF_EVENT_TRANSMISSION}
    for name, value in events.items():
        assert int(re.search(r"\b" + name + r" = (\d+);", text).group(1)) == value, name
