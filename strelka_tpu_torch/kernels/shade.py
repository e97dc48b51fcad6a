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

One kernel instance per fibre variant: none on a scene without hair
materials (enable_hair False), else the Chiang model, or the Kajiya-Kay
lobes where ops/bsdf.py selects them (STRELKA_HAIR_KK=1 at import).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import build
from strelka_tpu_torch.ops import bsdf as B
from strelka_tpu_torch.ops import sampler as S
from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.bsdf import EventType
from strelka_tpu_torch.ops.vec import Vec3

NO_FIBRE, CHIANG, KAJIYA_KAY = 0, 1, 2  # csrc/bsdf.cuh: kNoFibre, kChiang, kKajiyaKay

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


def fibre_variant(enable_hair: bool) -> int:
    """The kernel instance the plain code's choice of hair lobes asks for."""
    if not enable_hair:
        return NO_FIBRE
    return KAJIYA_KAY if B._HAIR_KAJIYA_KAY else CHIANG


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


def _inputs(mat: B.SurfaceParams, frame: B.ShadingFrame, direction: Vec3, xi, sample_idx, inside, hit_surface,
            radiance: Vec3, throughput: Vec3, first_event, specular_bounce) -> list:
    """The kernel's inputs in IN_FIELDS' order, each checked: a contiguous [N]
    tensor of its dtype on sample_idx's device."""
    if len(xi) != 4:
        raise ValueError("shade_bsdf: xi must hold the four BSDF uniforms")
    ts = [mat.bsdf_type, *mat.diffuse_color, mat.metallic, mat.roughness, mat.specular_level, mat.ior,
          *mat.glass_color, mat.opacity, *mat.emission_color, mat.thin_walled,
          *frame.normal, *frame.tangent_u, *frame.tangent_v, *frame.geom_normal,
          *direction, *xi, sample_idx, inside, hit_surface, *radiance, *throughput, first_event, specular_bounce]
    return checked("shade_bsdf", IN_FIELDS, ts, DTYPES, "sample_idx")


def checked(kernel: str, fields, ts: list, dtypes: dict, like: str) -> list:
    """A lane kernel's inputs `ts` in the order of `fields`, each checked: a
    contiguous [N] tensor of its dtype (f32 unless `dtypes` names it) on the
    device of the input named `like`, whose length is N."""
    ref = ts[fields.index(like)]
    n, dev = ref.shape[0], ref.device
    for name, t in zip(fields, ts):
        want = dtypes.get(name, torch.float32)
        if not isinstance(t, torch.Tensor) or t.dtype != want or t.shape != (n,) or not t.is_contiguous():
            what = (f"{t.dtype} {tuple(t.shape)}{'' if t.is_contiguous() else ' non-contiguous'}"
                    if isinstance(t, torch.Tensor) else type(t).__name__)
            raise ValueError(f"{kernel}: {name} must be a contiguous [{n}] {want} tensor, not {what}")
        if t.device != dev:
            raise ValueError(f"{kernel}: {name} is on {t.device}, {like} on {dev}")
    return ts


def outputs(fields, dtypes: dict, n: int, dev) -> dict:
    """A lane kernel's outputs by name, allocated on the current stream: one
    [k, n] block a dtype (f32 unless `dtypes` names it), a row an output."""
    rows = {}
    for dtype in (torch.float32, torch.int32, torch.bool):
        names = [f for f in fields if dtypes.get(f, torch.float32) == dtype]
        if names:
            rows.update(zip(names, torch.empty((len(names), n), dtype=dtype, device=dev)))
    return rows


def pointers(ts: list):
    """A host array of the tensors' device pointers (NULL for None)."""
    return (ctypes.c_void_p * len(ts))(*(None if t is None else t.data_ptr() for t in ts))


def launch(kernel: str, ins: list, out: list, *args, shape: tuple) -> None:
    """Call a lane kernel's C entry (strelka_<kernel>) with host arrays of its
    inputs' and outputs' device pointers (NULL for None, a field the kernel
    instance does not read or write), `args` and the current stream, and
    count the launch."""
    rc = getattr(build.load(), "strelka_" + kernel)(pointers(ins), pointers(out), *args,
                                                    build.stream_ptr(ins[0].device))
    build.check(rc, kernel)
    K.count_launch(kernel, shape)


def shade_bsdf(mat: B.SurfaceParams, frame: B.ShadingFrame, direction: Vec3, xi, sample_idx, inside, hit_surface,
               radiance: Vec3, throughput: Vec3, first_event, specular_bounce, *, depth: int, enable_hair: bool,
               variant: int | None = None) -> Shaded:
    """One bounce's BSDF phase: K10 on CUDA tensors, the plain version on CPU
    tensors. variant: the kernel instance (NO_FIBRE, CHIANG, KAJIYA_KAY);
    None takes fibre_variant(enable_hair), the plain code's choice."""
    ins = _inputs(mat, frame, direction, xi, sample_idx, inside, hit_surface, radiance, throughput, first_event,
                  specular_bounce)
    if variant is None:
        variant = fibre_variant(enable_hair)
    if variant not in (NO_FIBRE, CHIANG, KAJIYA_KAY):
        raise ValueError(f"shade_bsdf: no kernel instance {variant}")
    if sample_idx.device.type == "cpu":
        if variant != fibre_variant(enable_hair):
            raise ValueError("shade_bsdf: the plain version's lobes follow enable_hair and STRELKA_HAIR_KK")
        return shade_bsdf_plain(mat, frame, direction, xi, sample_idx, inside, hit_surface, radiance, throughput,
                                first_event, specular_bounce, depth=depth, enable_hair=enable_hair)
    K.require_cuda(sample_idx, "shade_bsdf")
    n, dev = sample_idx.shape[0], sample_idx.device
    o = outputs(OUT_FIELDS, DTYPES, n, dev)
    out = [o[f] for f in OUT_FIELDS]
    if n > 0:
        launch("shade_bsdf", ins, out, n, int(depth), int(variant), shape=(n, variant))
    smp = B.BsdfSample(k2=Vec3(o["k2_x"], o["k2_y"], o["k2_z"]), pdf=o["pdf"],
                       bsdf_over_pdf=Vec3(o["over_pdf_x"], o["over_pdf_y"], o["over_pdf_z"]),
                       event_type=o["event_type"])
    return Shaded(smp, o["cut"], o["shade"],
                  Vec3(o["radiance_out_x"], o["radiance_out_y"], o["radiance_out_z"]),
                  Vec3(o["throughput_out_x"], o["throughput_out_y"], o["throughput_out_z"]),
                  o["first_event_out"], o["specular_bounce_out"])


def random_lanes(n: int, seed: int, device, types=(0, 1, 2, 3)) -> dict:
    """shade_bsdf's keyword arguments but depth and enable_hair, for the
    checks of K10 against its plain version: n random lanes of the material
    types `types` (materials.py:BsdfType), made from `seed` on the host and
    then moved to `device`. Random orthonormal frames with a geometric
    normal near the shading normal; directions on the whole sphere (k1
    below the surface on about half the lanes); mirrors (roughness under
    1e-3), black lanes (no albedo, no specular), glass from inside (total
    internal reflection at grazing angles) and thin-walled, opacity under 1
    (the cutout), emissive lanes, lanes that hit no surface; uniforms with
    exact 0 and the sampler's largest value below 1."""
    rng = np.random.default_rng(seed)

    def unit(a):
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    def f32(a):
        return torch.tensor(np.ascontiguousarray(a, dtype=np.float32), device=device)

    def vec(a):
        return Vec3(*(f32(a[:, k]) for k in range(3)))

    def some(share):
        return rng.random(n) < share

    nrm = unit(rng.normal(size=(n, 3)))
    a = rng.normal(size=(n, 3))
    tu = unit(a - nrm * np.sum(a * nrm, axis=1, keepdims=True))
    tv = np.cross(nrm, tu)
    geom = unit(nrm + 0.3 * rng.normal(size=(n, 3)))
    direction = unit(rng.normal(size=(n, 3)))
    black = some(0.03)
    diffuse = np.where(black[:, None], 0.0, rng.random((n, 3)))
    metallic = np.where(black | some(0.2), 0.0, rng.random(n))
    specular = np.where(black, 0.0, rng.random(n))
    roughness = np.where(some(0.15), rng.random(n) * 1e-3, rng.random(n))
    emission = np.where(some(0.1)[:, None] & (rng.random((n, 3)) < 0.7), rng.random((n, 3)) * 4.0, 0.0)
    xi = rng.random((4, n))
    xi[rng.random((4, n)) < 0.01] = 0.0
    xi[rng.random((4, n)) < 0.01] = float(S.FLOAT_ONE_MINUS_EPS)
    mat = B.SurfaceParams(
        bsdf_type=torch.tensor(rng.choice(np.asarray(types, dtype=np.int32), n), device=device),
        diffuse_color=vec(diffuse), metallic=f32(metallic), roughness=f32(roughness), specular_level=f32(specular),
        ior=f32(rng.uniform(1.0, 2.5, n)), glass_color=vec(rng.random((n, 3))),
        opacity=f32(np.where(some(0.2), rng.random(n), 1.0)), emission_color=vec(emission),
        thin_walled=torch.tensor(some(0.3), device=device))
    frame = B.ShadingFrame(vec(nrm), vec(tu), vec(tv), vec(geom))
    return dict(
        mat=mat, frame=frame, direction=vec(direction), xi=tuple(f32(x) for x in xi),
        sample_idx=torch.tensor(rng.integers(0, 2 ** 32, n, dtype=np.int64), device=device),
        inside=torch.tensor(some(0.3), device=device), hit_surface=torch.tensor(some(0.9), device=device),
        radiance=vec(rng.random((n, 3))), throughput=vec(rng.random((n, 3))),
        first_event=torch.tensor(rng.integers(0, 4, n, dtype=np.int32), device=device),
        specular_bounce=torch.tensor(some(0.5), device=device))


def lanes_off(a: Shaded, b: Shaded, hit_surface) -> dict:
    """The lanes where two results of the phase differ, by output: bit for
    bit (NaN beside NaN counts as equal), the sample on the lanes that hit a
    surface, the masks and the state on every lane. All 0: bit-equal."""
    def differ(x, y):
        if x.dtype == torch.float32:
            return (x.view(torch.int32) != y.view(torch.int32)) & ~(torch.isnan(x) & torch.isnan(y))
        return x != y

    fields = {"k2": (a.smp.k2, b.smp.k2), "pdf": ([a.smp.pdf], [b.smp.pdf]),
              "bsdf_over_pdf": (a.smp.bsdf_over_pdf, b.smp.bsdf_over_pdf),
              "event_type": ([a.smp.event_type], [b.smp.event_type]), "cut": ([a.cut], [b.cut]),
              "shade": ([a.shade], [b.shade]), "radiance": (a.radiance, b.radiance),
              "throughput": (a.throughput, b.throughput), "first_event": ([a.first_event], [b.first_event]),
              "specular_bounce": ([a.specular_bounce], [b.specular_bounce])}
    off = {}
    for name, (xs, ys) in fields.items():
        d = torch.zeros_like(hit_surface)
        for x, y in zip(xs, ys):
            d = d | differ(x, y)
        if name in ("k2", "pdf", "bsdf_over_pdf", "event_type"):
            d = d & hit_surface
        off[name] = int(d.sum())
    return off
