"""Kernels K11 and K12: one bounce's next-event estimation, less its shadow
sweep, as two passes around the sweep.

The phase is bounce.nee in ops/integrator.py:trace_paths. K11 (nee_light)
is its part before the sweep: the light a lane draws and its row of the
light table, the sample of that light (ops/light_sampling.py:sample_light),
the shadow ray (offset_ray), the masks and the light pdf. The sweep (K6 or
K3, and K8 on a scene with curves) stays in ops/intersect.py. K12
(nee_shade) is the part after it: the visibility, bsdf_evaluate
(ops/bsdf.py, with the fibre lobes of ops/hair.py on a hair scene), the
balance heuristic, the radiance and the two NaN canaries. The JAX package
leaves this phase to XLA, so neither kernel has a Pallas counterpart. The
CUDA source is csrc/nee.cu, its BSDF functions csrc/bsdf.cuh (K10's).

Both are bit-equal to their plain versions on the card on every lane. K11
samples every lane's light, as the plain code does: the sweep reads its rays
on every lane. K12 leaves the lanes that are not nee_able as they were, as
the plain masks do.

K11 has one kernel instance per rect light sampling method (0 uniform, 1 the
spherical quad); K12 one per fibre variant, as K10 (kernels/lanes.py:
fibre_variant).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import lanes as L
from strelka_tpu_torch.ops import bsdf as B
from strelka_tpu_torch.ops import light_sampling as LS
from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.intersect import offset_ray_vec
from strelka_tpu_torch.ops.vec import Vec3

METHODS = (0, 1)  # rect_light_sampling_method: uniform, spherical quad
NEE_EVENTS = B.BSDF_EVENT_DIFFUSE | B.BSDF_EVENT_GLOSSY  # the events NEE lights
LIGHT_COLS = 20  # a row of the light table (render/device_scene.py)

# the kernels' inputs and outputs in the order of csrc/nee.cu's enums; each
# an [N] array, f32 unless named in DTYPES
LIGHT_IN_FIELDS = (
    "shade", "event_type", "u_light", "u_x", "u_y", "position_x", "position_y", "position_z",
    "normal_x", "normal_y", "normal_z", "geom_normal_x", "geom_normal_y", "geom_normal_z", "is_curve", "prim",
)
LIGHT_OUT_FIELDS = (
    "org_x", "org_y", "org_z", "to_light_x", "to_light_y", "to_light_z", "dist", "exclude", "active", "nee_able",
    "light_pdf", "light_id",
)
SHADE_IN_FIELDS = (
    "occluded", "active", "nee_able", "light_pdf", "light_id", "to_light_x", "to_light_y", "to_light_z", "inside",
    "type", "diffuse_x", "diffuse_y", "diffuse_z", "metallic", "roughness", "specular_level", "ior",
    "normal_x", "normal_y", "normal_z", "tangent_u_x", "tangent_u_y", "tangent_u_z",
    "tangent_v_x", "tangent_v_y", "tangent_v_z", "direction_x", "direction_y", "direction_z",
    "radiance_x", "radiance_y", "radiance_z", "throughput_x", "throughput_y", "throughput_z", "shade",
)
SHADE_OUT_FIELDS = (
    "radiance_out_x", "radiance_out_y", "radiance_out_z", "throughput_out_x", "throughput_out_y", "throughput_out_z",
    "shade_out",
)
DTYPES = {"event_type": torch.int32, "prim": torch.int32, "exclude": torch.int32, "light_id": torch.int32,
          "type": torch.int32, "shade": torch.bool, "is_curve": torch.bool, "active": torch.bool,
          "nee_able": torch.bool, "occluded": torch.bool, "inside": torch.bool, "shade_out": torch.bool}


class NeeLight(NamedTuple):
    """K11's results: the shadow sweep's inputs and what K12 reads of the
    light (its pdf and its row)."""

    shadow_org: Vec3
    to_light: Vec3
    dist_to_light: torch.Tensor  # [N] f32
    exclude: torch.Tensor  # [N] int32: the hit's triangle, -1 on a curve
    active: torch.Tensor  # [N] bool: nee_able and the light's geometry faces the lane
    nee_able: torch.Tensor  # [N] bool: shaded by a diffuse or glossy event
    light_pdf: torch.Tensor  # [N] f32: the light's pdf over num_lights, 0 where the geometry does not face
    light_id: torch.Tensor  # [N] int32


class NeeShaded(NamedTuple):
    """K12's results: the path state the phase updates."""

    radiance: Vec3
    throughput: Vec3
    shade: torch.Tensor  # [N] bool: a canary kills the path


def nee_light_plain(shade, event_type, u_light, u_x, u_y, position: Vec3, frame: B.ShadingFrame, is_curve, prim,
                    light_table, *, num_lights: int, method: int) -> NeeLight:
    """The phase up to the sweep in plain PyTorch (estimateDirectLighting,
    cu:312-324, and sampleLight, :260-310): what CPU tensors run, and what
    K11 is held to."""
    K.note_plain("nee_light", shade.device)
    nee_able = shade & ((event_type & NEE_EVENTS) != 0)
    light_id = torch.clamp((num_lights * u_light).to(torch.int32), 0, num_lights - 1)
    lp = LS.gather_light(light_table, light_id)
    ls = LS.sample_light(lp, u_x, u_y, position, method)
    cos_nl = V.dot(frame.normal, ls.L)
    geom_ok = (cos_nl > 0.0) & (-V.dot(ls.L, ls.normal) > 0.0) & V.all_nonzero(lp.color)
    return NeeLight(
        shadow_org=offset_ray_vec(position, frame.geom_normal), to_light=ls.L, dist_to_light=ls.dist_to_light,
        exclude=torch.where(is_curve, -1, prim),  # a curve hit excludes no triangle
        active=nee_able & geom_ok, nee_able=nee_able,
        light_pdf=torch.where(geom_ok, ls.pdf, 0.0) * (1.0 / num_lights), light_id=light_id)


def nee_shade_plain(nl: NeeLight, occluded, inside, mat: B.SurfaceParams, frame: B.ShadingFrame, direction: Vec3,
                    radiance: Vec3, throughput: Vec3, shade, light_table, *, enable_hair: bool) -> NeeShaded:
    """The phase after the sweep in plain PyTorch: what CPU tensors run, and
    what K12 is held to."""
    K.note_plain("nee_shade", occluded.device)
    n, dev = occluded.shape[0], occluded.device
    nee_able, light_pdf = nl.nee_able, nl.light_pdf
    color = Vec3(*LS.light_rows(light_table, nl.light_id)[12:15])
    cos_nl = V.dot(frame.normal, nl.to_light)
    # the sweep's mask is geom_ok on every nee_able lane, the only lanes read
    visibility = torch.where(nl.active & ~occluded, 1.0, 0.0)
    nee_w = visibility * torch.clamp(cos_nl, 0.0, 1.0)
    nee_radiance = color * nee_w

    # NaN canary #1 (cu:552-558)
    nan1 = nee_able & (V.any_nan(nee_radiance) | torch.isnan(light_pdf))

    next_event_valid = ((cos_nl > 0.0) != inside) & (light_pdf != 0.0) & nee_able
    ev = B.bsdf_evaluate(mat, frame, -direction, nl.to_light, enable_hair=enable_hair)
    nan2 = nee_able & (V.any_nan(ev.bsdf_diffuse) | V.any_nan(ev.bsdf_glossy))
    contribute = next_event_valid & (ev.pdf > 0.0) & ~nan1 & ~nan2
    inv_lpdf = 1.0 / torch.clamp(light_pdf, min=1e-20)
    mis_w = LS.mis_weight_balance(torch.clamp(light_pdf, min=1e-20), ev.pdf)
    nee_contrib = throughput * nee_radiance * (inv_lpdf * mis_w) * (ev.bsdf_diffuse + ev.bsdf_glossy)
    radiance = V.where(contribute, radiance + nee_contrib, radiance)
    # canary: radiance = (1e4, 0, 0), kill
    canary = nan1 | nan2
    radiance = V.where(canary, V.splat((1e4, 0.0, 0.0), n, dev), radiance)
    throughput = V.where(canary, V.full(n, 0.0, dev), throughput)
    return NeeShaded(radiance, throughput, shade & ~canary)


def nee_light(shade, event_type, u_light, u_x, u_y, position: Vec3, frame: B.ShadingFrame, is_curve, prim,
              light_table, *, num_lights: int, method: int) -> NeeLight:
    """The phase up to the sweep: K11 on CUDA tensors, the plain version on
    CPU tensors. method: the rect lights' sampling method (0 uniform, 1 the
    spherical quad)."""
    ins = L.checked("nee_light", LIGHT_IN_FIELDS,
                    [shade, event_type, u_light, u_x, u_y, *position, *frame.normal, *frame.geom_normal, is_curve,
                     prim], DTYPES, "shade")
    L.table("nee_light", "light_table", light_table, (None, LIGHT_COLS), torch.float32, shade.device)
    if method not in METHODS:
        raise ValueError(f"nee_light: no rect light sampling method {method}")
    if num_lights < 1:
        raise ValueError("nee_light: a scene without lights has no next event")
    if shade.device.type == "cpu":
        return nee_light_plain(shade, event_type, u_light, u_x, u_y, position, frame, is_curve, prim, light_table,
                               num_lights=num_lights, method=method)
    n = shade.shape[0]
    o = L.launch("nee_light", ins, LIGHT_OUT_FIELDS, DTYPES, light_table.data_ptr(), light_table.shape[0], n,
                 int(num_lights), int(method), shape=(n, method))
    return NeeLight(Vec3(o["org_x"], o["org_y"], o["org_z"]), Vec3(o["to_light_x"], o["to_light_y"], o["to_light_z"]),
                    o["dist"], o["exclude"], o["active"], o["nee_able"], o["light_pdf"], o["light_id"])


def nee_shade(nl: NeeLight, occluded, inside, mat: B.SurfaceParams, frame: B.ShadingFrame, direction: Vec3,
              radiance: Vec3, throughput: Vec3, shade, light_table, *, enable_hair: bool) -> NeeShaded:
    """The phase after the sweep: K12 on CUDA tensors, the plain version on
    CPU tensors. The kernel instance is lanes.fibre_variant(enable_hair), the
    plain code's choice of hair lobes."""
    ins = L.checked("nee_shade", SHADE_IN_FIELDS,
                    [occluded, nl.active, nl.nee_able, nl.light_pdf, nl.light_id, *nl.to_light, inside,
                     mat.bsdf_type, *mat.diffuse_color, mat.metallic, mat.roughness, mat.specular_level, mat.ior,
                     *frame.normal, *frame.tangent_u, *frame.tangent_v, *direction, *radiance, *throughput, shade],
                    DTYPES, "occluded")
    L.table("nee_shade", "light_table", light_table, (None, LIGHT_COLS), torch.float32, occluded.device)
    if occluded.device.type == "cpu":
        return nee_shade_plain(nl, occluded, inside, mat, frame, direction, radiance, throughput, shade, light_table,
                               enable_hair=enable_hair)
    n, variant = occluded.shape[0], L.fibre_variant(enable_hair)
    o = L.launch("nee_shade", ins, SHADE_OUT_FIELDS, DTYPES, light_table.data_ptr(), light_table.shape[0], n,
                 variant, shape=(n, variant))
    return NeeShaded(Vec3(o["radiance_out_x"], o["radiance_out_y"], o["radiance_out_z"]),
                     Vec3(o["throughput_out_x"], o["throughput_out_y"], o["throughput_out_z"]), o["shade_out"])
