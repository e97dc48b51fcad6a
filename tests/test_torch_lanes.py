"""The lane kernels' shared wrapper code (kernels/lanes.py) on the CPU, through
each wrapper that uses it: K10 shade_bsdf (kernels/shade.py), K11 nee_light and
K12 nee_shade (kernels/nee.py), K13 shade_surface (kernels/surface.py). Wrong
inputs and tables are refused before the kernel or its plain version runs, the
counters know the kernels, the fields' order is that of the CUDA sources'
enums, and the kernel instance of K10 and K12 follows ops/bsdf.py's choice of
hair lobes. The kernels themselves are held against their plain versions on the
card (tests/test_torch_shade_*_card.py)."""

import os
import re

import pytest
import torch
import torch_lanes as TL

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import lanes as L
from strelka_tpu_torch.kernels import nee as KN
from strelka_tpu_torch.kernels import shade as KS
from strelka_tpu_torch.kernels import surface as KSF
from strelka_tpu_torch.ops import bsdf as B
from strelka_tpu_torch.ops.vec import Vec3

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "strelka_tpu_torch", "csrc")


def _nee(lanes):
    """nee_light, then nee_shade on its handoff."""
    nl = KN.nee_light(**TL.light_args(lanes), method=0)
    return KN.nee_shade(nl, **TL.shade_args(lanes), enable_hair=False)


# kernel -> (its random lanes, the call that takes them); K11's and K12's lanes
# go through both halves of the phase
KERNELS = {
    "shade_bsdf": (lambda: TL.random_bsdf_lanes(64, 1, "cpu"),
                   lambda lanes: KS.shade_bsdf(**lanes, depth=0, enable_hair=False)),
    "nee_light": (lambda: TL.random_nee_lanes(64, 1, "cpu"), _nee),
    "nee_shade": (lambda: TL.random_nee_lanes(64, 1, "cpu"), _nee),
    "shade_surface": (lambda: TL.random_surface_lanes(64, 1, "cpu", curves=True, uv=True),
                      lambda lanes: KSF.shade_surface(**lanes, depth=0)),
}


def _refused(kernel: str, path: str, change, match: str) -> None:
    """The kernel's lanes with the value at `path` (a key of the lanes, then
    NamedTuple fields, joined by dots; a Vec3 in each component) changed are
    refused with a ValueError matching `match`."""
    def at(v, keys):
        if keys:
            return v._replace(**{keys[0]: at(getattr(v, keys[0]), keys[1:])})
        return Vec3(*(change(c) for c in v)) if isinstance(v, Vec3) else change(v)

    make, call = KERNELS[kernel]
    lanes = make()
    first, *rest = path.split(".")
    lanes[first] = at(lanes[first], rest)
    with pytest.raises(ValueError, match=match):
        call(lanes)


@pytest.mark.parametrize("kernel, path, dtype, field", [
    ("shade_bsdf", "mat.metallic", torch.float64, "metallic"),
    ("shade_bsdf", "mat.bsdf_type", torch.int64, "type"),
    ("shade_bsdf", "sample_idx", torch.int32, "sample_idx"),
    ("shade_bsdf", "hit_surface", torch.uint8, "hit_surface"),
    ("shade_bsdf", "first_event", torch.float32, "first_event"),
    ("nee_light", "event_type", torch.int64, "event_type"),
    ("nee_light", "u_light", torch.float64, "u_light"),
    ("nee_light", "is_curve", torch.uint8, "is_curve"),
    ("nee_light", "prim", torch.float32, "prim"),
    ("nee_shade", "occluded", torch.int32, "occluded"),
    ("nee_shade", "mat.roughness", torch.float64, "roughness"),
    ("nee_shade", "mat.bsdf_type", torch.int64, "type"),
    ("shade_surface", "hit.prim", torch.float32, "prim"),
    ("shade_surface", "hit.t", torch.float64, "hit_t"),
    ("shade_surface", "chit.seg", torch.int64, "seg"),
    ("shade_surface", "inside", torch.uint8, "inside"),
    ("shade_surface", "last_bsdf_pdf", torch.float16, "last_bsdf_pdf"),
    ("shade_surface", "t_total", torch.float64, "t_total"),
])
def test_wrong_dtype_refused(kernel, path, dtype, field):
    _refused(kernel, path, lambda t: t.to(dtype), f"{kernel}: {field} must be")


@pytest.mark.parametrize("kernel, path, field", [
    ("shade_bsdf", "mat.roughness", "roughness"), ("shade_bsdf", "inside", "inside"),
    ("shade_bsdf", "sample_idx", "sample_idx"),
    ("nee_light", "u_x", "u_x"), ("nee_light", "frame.geom_normal", "geom_normal_x"),
    ("nee_shade", "inside", "inside"), ("nee_shade", "throughput", "throughput_x"),
    ("shade_surface", "hit.u", "hit_u"), ("shade_surface", "origin.y", "origin_y"),
    ("shade_surface", "alive", "alive"), ("shade_surface", "chit.seg", "seg"),
])
def test_non_contiguous_input_refused(kernel, path, field):
    _refused(kernel, path, lambda t: torch.stack([t, t], dim=1)[:, 0], f"{kernel}: {field} .*non-contiguous")


@pytest.mark.parametrize("kernel, path, field", [("shade_bsdf", "mat.ior", "ior"), ("nee_light", "u_y", "u_y"),
                                                 ("shade_surface", "hit.v", "hit_v")])
def test_wrong_length_refused(kernel, path, field):
    _refused(kernel, path, lambda t: t[:-1].contiguous(), f"{kernel}: {field} must be")


@pytest.mark.parametrize("kernel, path, field", [
    ("shade_bsdf", "mat.opacity", "opacity"), ("shade_bsdf", "specular_bounce", "specular_bounce"),
    ("nee_light", "prim", "prim"), ("nee_light", "u_light", "u_light"),
    ("nee_shade", "inside", "inside"), ("nee_shade", "mat.ior", "ior"),
    ("shade_surface", "hit.prim", "prim"), ("shade_surface", "specular_bounce", "specular_bounce"),
    ("shade_surface", "chit.u", "curve_u"),
])
def test_mixed_devices_refused(kernel, path, field):
    _refused(kernel, path, lambda t: torch.empty_like(t, device="meta"), f"{kernel}: {field} is on meta")


@pytest.mark.parametrize("kernel, path, change", [
    ("nee_light", "light_table", lambda t: t.double()),
    ("nee_light", "light_table", lambda t: t[:, :19].contiguous()),
    ("nee_light", "light_table", lambda t: t[:0]),
    ("nee_light", "light_table", lambda t: t.t().contiguous().t()),
    ("nee_light", "light_table", lambda t: torch.empty_like(t, device="meta")),
    ("shade_surface", "tables.attr_table", lambda t: t.double()),
    ("shade_surface", "tables.attr_table", lambda t: t[:, :67].contiguous()),
    ("shade_surface", "tables.attr_table", lambda t: t[:0]),
    ("shade_surface", "tables.attr_table", lambda t: t.t().contiguous().t()),
    ("shade_surface", "tables.attr_table", lambda t: torch.cat([t.new_zeros(1), t.reshape(-1)])[1:].view(t.shape)),
    ("shade_surface", "tables.attr_table", lambda t: torch.empty_like(t, device="meta")),
    ("shade_surface", "tables.mat_table", lambda t: t[:, :23].contiguous()),
    ("shade_surface", "tables.mat_table", lambda t: t.double()),
    ("shade_surface", "tables.curves.p2", lambda t: t[:-1].contiguous()),
    ("shade_surface", "tables.curves.w1", lambda t: t.double()),
    ("shade_surface", "tables.curves.material_id", lambda t: t.to(torch.int64)),
    ("shade_surface", "tables.curves.p0", lambda t: t.t().contiguous().t()),
])
def test_table_refused(kernel, path, change):
    _refused(kernel, path, change, f"{kernel}: {path.split('.')[-1]}")


@pytest.mark.parametrize("kernel, shape", [("shade_bsdf", (1023, L.CHIANG)), ("nee_light", (1023, 1)),
                                           ("nee_shade", (1023, 1)), ("shade_surface", (1023, 1, 1, 0))])
def test_counters_know_the_kernel(kernel, shape):
    assert kernel in K.KERNEL_NAMES
    K.reset_counts()
    K.count_launch(kernel, shape)
    K.note_plain(kernel, torch.device("cuda"))
    assert K.launch_counts[kernel] == 1 and K.launch_shapes[(kernel, shape)] == 1
    assert K.plain_cuda_calls[kernel] == 1
    K.reset_counts()
    assert K.launch_counts[kernel] == 0 and K.plain_cuda_calls[kernel] == 0 and not K.launch_shapes


def _enum(source: str, first: str) -> list:
    with open(os.path.join(CSRC, source), encoding="utf-8") as f:
        body = re.search(r"enum : int \{\s*(" + first + r",.*?)\};", f.read(), re.S).group(1)
    return [w.strip() for w in body.split(",") if w.strip()]


@pytest.mark.parametrize("source, first, fields, count", [
    ("shade.cu", "kType", KS.IN_FIELDS, "kInCount"), ("shade.cu", "kK2X", KS.OUT_FIELDS, "kOutCount"),
    ("nee.cu", "kShade", KN.LIGHT_IN_FIELDS, "kInCount"), ("nee.cu", "kOrgX", KN.LIGHT_OUT_FIELDS, "kOutCount"),
    ("nee.cu", "kOccluded", KN.SHADE_IN_FIELDS, "kInCount"),
    ("nee.cu", "kRadianceOutX", KN.SHADE_OUT_FIELDS, "kOutCount"),
    ("surface.cu", "kHitT", KSF.IN_FIELDS, "kInCount"), ("surface.cu", "kRadianceOutX", KSF.OUT_FIELDS, "kOutCount"),
    ("surface.cu", "kAttrTable", KSF.TABLE_FIELDS, "kTableCount"),
])
def test_argument_order_matches_the_source(source, first, fields, count):
    names = _enum(source, first)
    assert names[-1] == count
    camel = ["k" + "".join(w.capitalize() for w in f.split("_")) for f in fields]
    assert [n.lower() for n in names[:-1]] == [c.lower() for c in camel]


def test_fibre_variant_follows_the_plain_codes_choice(monkeypatch):
    assert L.fibre_variant(False) == L.NO_FIBRE
    monkeypatch.setattr(B, "_HAIR_KAJIYA_KAY", False)
    assert L.fibre_variant(True) == L.CHIANG
    monkeypatch.setattr(B, "_HAIR_KAJIYA_KAY", True)
    assert L.fibre_variant(True) == L.KAJIYA_KAY


@pytest.mark.parametrize("kernel", ("shade_bsdf", "nee_shade"))
def test_kajiya_kay_lobes_through_the_switch(kernel, monkeypatch):
    """ops/bsdf.py's switch, read at the call, is what selects the Kajiya-Kay
    lobes: on hair lanes the wrapper then equals its plain version under the
    switch and differs from its Chiang result."""
    if kernel == "shade_bsdf":
        lanes = TL.random_bsdf_lanes(512, 9, "cpu", types=(3,))
        masks = {"smp": lanes["hit_surface"]}

        def wrapper():
            return KS.shade_bsdf(**lanes, depth=1, enable_hair=True)

        def plain():
            return KS.shade_bsdf_plain(**lanes, depth=1, enable_hair=True)
    else:
        lanes = TL.random_nee_lanes(512, 9, "cpu", types=(3,))
        nl = KN.nee_light(**TL.light_args(lanes), method=0)
        masks = None

        def wrapper():
            return KN.nee_shade(nl, **TL.shade_args(lanes), enable_hair=True)

        def plain():
            return KN.nee_shade_plain(nl, **TL.shade_args(lanes), enable_hair=True)

    monkeypatch.setattr(B, "_HAIR_KAJIYA_KAY", False)
    chiang = wrapper()
    monkeypatch.setattr(B, "_HAIR_KAJIYA_KAY", True)
    kajiya_kay = wrapper()
    assert not any(TL.lanes_off(kajiya_kay, plain(), masks).values())
    assert any(TL.lanes_off(kajiya_kay, chiang, masks).values())
