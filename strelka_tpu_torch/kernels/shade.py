"""Kernel K10: one bounce's BSDF phase of the integrator in one pass.

The phase runs from bounce.bsdf to bounce.nee in ops/integrator.py:
trace_paths: the alpha cutout's decision (a hash uniform of the sample
index), the emission a surface hit collects, bsdf_sample (ops/bsdf.py,
with the fibre lobes of ops/hair.py on a hair scene), the cutout's
override of the sample, the absorbed test, depth 0's first event, the
throughput and the specular flag. The JAX package leaves this phase to
XLA, so K10 has no Pallas counterpart. The CUDA source is csrc/shade.cu,
its BSDF functions csrc/bsdf.cuh.

Bit-equal to shade_bsdf_plain on the card on every lane that hit a surface,
and the path state on every lane. On the other lanes the sample holds
fixed values (no event, zero vectors), which no later reader uses: each
masks the sample by `shade`.

One kernel instance per fibre variant (kernels/lanes.py:fibre_variant):
none on a scene without hair materials (enable_hair False), else the Chiang
model, or the Kajiya-Kay lobes where ops/bsdf.py selects them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import lanes as L
from strelka_tpu_torch.ops import bsdf as B
from strelka_tpu_torch.ops import sampler as S
from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.bsdf import EventType
from strelka_tpu_torch.ops.vec import Vec3

# the kernel's inputs and outputs in the order of csrc/shade.cu's two enums;
# each an [N] array, f32 unless named in DTYPES
IN_FIELDS = (
    "type", "diffuse_x", "diffuse_y", "diffuse_z", "metallic", "roughness", "specular_level", "ior",
    "glass_x", "glass_y", "glass_z", "opacity", "emission_x", "emission_y", "emission_z", "thin_walled",
    "normal_x", "normal_y", "normal_z", "tangent_u_x", "tangent_u_y", "tangent_u_z",
    "tangent_v_x", "tangent_v_y", "tangent_v_z", "geom_normal_x", "geom_normal_y", "geom_normal_z",
    "direction_x", "direction_y", "direction_z", "xi_0", "xi_1", "xi_2", "xi_3", "sample_idx", "inside",
    "hit_surface", "radiance_x", "radiance_y", "radiance_z", "throughput_x", "throughput_y", "throughput_z",
    "first_event", "specular_bounce",
)
OUT_FIELDS = (
    "k2_x", "k2_y", "k2_z", "pdf", "over_pdf_x", "over_pdf_y", "over_pdf_z", "event_type", "cut", "shade",
    "radiance_out_x", "radiance_out_y", "radiance_out_z", "throughput_out_x", "throughput_out_y",
    "throughput_out_z", "first_event_out", "specular_bounce_out",
)
DTYPES = {"type": torch.int32, "first_event": torch.int32, "event_type": torch.int32,
          "first_event_out": torch.int32, "sample_idx": torch.int64, "thin_walled": torch.bool,
          "inside": torch.bool, "hit_surface": torch.bool, "specular_bounce": torch.bool, "cut": torch.bool,
          "shade": torch.bool, "specular_bounce_out": torch.bool}


class Shaded(NamedTuple):
    """The phase's results: the sample (after the cutout's override), the
    cutout and shade masks, and the four state arrays it updates."""

    smp: B.BsdfSample
    cut: torch.Tensor  # [N] bool
    shade: torch.Tensor  # [N] bool: hit a surface and not absorbed
    radiance: Vec3
    throughput: Vec3
    first_event: torch.Tensor  # [N] int32
    specular_bounce: torch.Tensor  # [N] bool


def shade_bsdf_plain(mat: B.SurfaceParams, frame: B.ShadingFrame, direction: Vec3, xi, sample_idx, inside,
                     hit_surface, radiance: Vec3, throughput: Vec3, first_event, specular_bounce, *, depth: int,
                     enable_hair: bool) -> Shaded:
    """The phase in plain PyTorch: what CPU tensors run, and what K10 is held to."""
    K.note_plain("shade_bsdf", sample_idx.device)
    n = sample_idx.shape[0]
    dev = sample_idx.device
    # ---- emissive materials (EDF): added on every BSDF/camera hit, no
    # MIS; the cutout decision comes first (a pass-through collects none)
    u_cut = S.uniform_hash(sample_idx, depth)
    cut = hit_surface & (mat.opacity < 1.0) & (u_cut >= mat.opacity)
    emissive = hit_surface & ~cut & V.any_nonzero(mat.emission_color)
    front = V.dot(frame.geom_normal, direction) < 0.0
    radiance = V.where(emissive & front, radiance + throughput * mat.emission_color, radiance)

    ior1 = torch.where(inside, mat.ior, 1.0)
    ior2 = torch.where(inside, 1.0, mat.ior)
    k1 = -direction
    smp = B.bsdf_sample(mat, frame, k1, xi, ior1, ior2, enable_hair=enable_hair)

    # ---- stochastic alpha cutout (opacity < 1): pass straight through
    # as a specular-transmission event without flipping the medium
    ones3 = V.full(n, 1.0, dev)
    smp = B.BsdfSample(
        k2=V.where(cut, direction, smp.k2),
        pdf=torch.where(cut, 0.0, smp.pdf),
        bsdf_over_pdf=V.where(cut, ones3, smp.bsdf_over_pdf),
        event_type=torch.where(cut, B.BSDF_EVENT_SPECULAR_TRANSMISSION, smp.event_type).to(torch.int32),
    )

    absorbed = hit_surface & (smp.event_type == B.BSDF_EVENT_ABSORB)
    if depth == 0:
        first_event = torch.where(absorbed, EventType.eAbsorb, first_event)
        first_event = torch.where(
            hit_surface & ((smp.event_type & B.BSDF_EVENT_DIFFUSE) != 0), EventType.eDiffuse, first_event
        )
        first_event = torch.where(
            hit_surface & ((smp.event_type & B.BSDF_EVENT_GLOSSY) != 0), EventType.eSpecular, first_event
        ).to(torch.int32)
    throughput = V.where(absorbed, V.full(n, 0.0, dev), throughput)
    shade = hit_surface & ~absorbed
    specular_bounce = torch.where(shade, (smp.event_type & B.BSDF_EVENT_SPECULAR) != 0, specular_bounce)
    return Shaded(smp, cut, shade, radiance, throughput, first_event, specular_bounce)


def shade_bsdf(mat: B.SurfaceParams, frame: B.ShadingFrame, direction: Vec3, xi, sample_idx, inside, hit_surface,
               radiance: Vec3, throughput: Vec3, first_event, specular_bounce, *, depth: int,
               enable_hair: bool) -> Shaded:
    """One bounce's BSDF phase: K10 on CUDA tensors, the plain version on CPU
    tensors. The kernel instance is lanes.fibre_variant(enable_hair), the
    plain code's choice of hair lobes."""
    if len(xi) != 4:
        raise ValueError("shade_bsdf: xi must hold the four BSDF uniforms")
    ins = L.checked("shade_bsdf", IN_FIELDS,
                    [mat.bsdf_type, *mat.diffuse_color, mat.metallic, mat.roughness, mat.specular_level, mat.ior,
                     *mat.glass_color, mat.opacity, *mat.emission_color, mat.thin_walled, *frame.normal,
                     *frame.tangent_u, *frame.tangent_v, *frame.geom_normal, *direction, *xi, sample_idx, inside,
                     hit_surface, *radiance, *throughput, first_event, specular_bounce], DTYPES, "sample_idx")
    if sample_idx.device.type == "cpu":
        return shade_bsdf_plain(mat, frame, direction, xi, sample_idx, inside, hit_surface, radiance, throughput,
                                first_event, specular_bounce, depth=depth, enable_hair=enable_hair)
    n, variant = sample_idx.shape[0], L.fibre_variant(enable_hair)
    o = L.launch("shade_bsdf", ins, OUT_FIELDS, DTYPES, n, int(depth), variant, shape=(n, variant))
    smp = B.BsdfSample(k2=Vec3(o["k2_x"], o["k2_y"], o["k2_z"]), pdf=o["pdf"],
                       bsdf_over_pdf=Vec3(o["over_pdf_x"], o["over_pdf_y"], o["over_pdf_z"]),
                       event_type=o["event_type"])
    return Shaded(smp, o["cut"], o["shade"],
                  Vec3(o["radiance_out_x"], o["radiance_out_y"], o["radiance_out_z"]),
                  Vec3(o["throughput_out_x"], o["throughput_out_y"], o["throughput_out_z"]),
                  o["first_event_out"], o["specular_bounce_out"])
