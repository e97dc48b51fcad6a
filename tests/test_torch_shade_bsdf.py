"""Kernel K10's wrapper (kernels/shade.py) on the CPU: CPU tensors go to the
plain version, which is the integrator's phase, and the CUDA header's
constants match the Python side's. The refusals, counters and field order
shared by the lane kernels are in tests/test_torch_lanes.py; the kernel itself
is held against the plain version on the card
(tests/test_torch_shade_bsdf_card.py)."""

import math
import os
import re

import pytest
import torch
import torch_lanes as TL

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import shade as KS
from strelka_tpu_torch.ops import bsdf as B
from strelka_tpu_torch.ops import hair as H

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "strelka_tpu_torch", "csrc")


@pytest.mark.parametrize("enable_hair", (False, True))
@pytest.mark.parametrize("depth", (0, 3))
@pytest.mark.parametrize("n", (1, 257))
def test_cpu_tensors_take_the_plain_version(n, depth, enable_hair):
    lanes = TL.random_bsdf_lanes(n, 5 + n + depth, "cpu")
    K.reset_counts()
    got = KS.shade_bsdf(**lanes, depth=depth, enable_hair=enable_hair)
    want = KS.shade_bsdf_plain(**lanes, depth=depth, enable_hair=enable_hair)
    assert not any(TL.lanes_off(got, want, {"smp": lanes["hit_surface"]}).values())
    assert K.launch_counts["shade_bsdf"] == 0 and K.plain_cuda_calls["shade_bsdf"] == 0
    assert got.first_event.dtype == torch.int32 and got.smp.event_type.dtype == torch.int32
    assert not (got.shade & ~lanes["hit_surface"]).any() and not (got.cut & ~lanes["hit_surface"]).any()


def test_the_plain_version_is_the_integrators_phase():
    """The phase's pieces as the integrator ran them before K10, step by step."""
    lanes = TL.random_bsdf_lanes(300, 2, "cpu")
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


def test_header_constants_are_the_python_modules():
    with open(os.path.join(CSRC, "bsdf.cuh"), encoding="utf-8") as f:
        text = f.read()

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
