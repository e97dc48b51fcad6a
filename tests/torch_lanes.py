"""Random lanes for the lane kernels K10-K13 and their plain versions, and the
bitwise comparison of two results: what the CPU tests, the card tests and
chip_smoke.py hold the kernels with (kernels/shade.py, nee.py, surface.py).

Each random_*_lanes makes a wrapper's arguments from a seed on the host and
moves them to a device; lanes_off counts the lanes where two results differ.
Tests import it as `import torch_lanes` (tests/ is on sys.path under pytest);
chip_smoke.py puts tests/ on sys.path itself.
"""

from __future__ import annotations

import numpy as np
import torch

from strelka_tpu_torch.kernels import nee as KN
from strelka_tpu_torch.kernels import surface as KSF
from strelka_tpu_torch.ops import bsdf as B
from strelka_tpu_torch.ops import sampler as S
from strelka_tpu_torch.ops.curves import CurveHit
from strelka_tpu_torch.ops.intersect import Hit
from strelka_tpu_torch.ops.vec import Vec3
from strelka_tpu_torch.render.device_scene import ATTR_JOINED, DeviceCurves


def to_device(v, device):
    """v with its tensors moved to `device`, through NamedTuples; other
    values (None, numbers) as they are."""
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, tuple):
        return type(v)(*(to_device(x, device) for x in v))
    return v


def differ(x, y):
    """Lanes where two arrays differ bit for bit (NaN beside NaN counts as equal)."""
    if x.dtype == torch.float32:
        return (x.view(torch.int32) != y.view(torch.int32)) & ~(torch.isnan(x) & torch.isnan(y))
    return x != y


def _leaves(v) -> list:
    if v is None:
        return []
    if isinstance(v, torch.Tensor):
        return [v]
    return [t for x in v for t in _leaves(x)]


def lanes_off(a, b, masks=None) -> dict:
    """The lanes where two results of a lane kernel's phase (NamedTuples of
    one type) differ, by field: bit for bit, every array of the field taken
    together, on every lane or, for a field that `masks` names, on that
    mask's lanes only (K10's sample: {"smp": hit_surface}). A field that is
    None in both is left out. All 0: bit-equal."""
    off = {}
    for name, x, y in zip(a._fields, a, b):
        xs, ys = _leaves(x), _leaves(y)
        if len(xs) != len(ys):
            raise ValueError(f"lanes_off: {name} has {len(xs)} arrays in one result and {len(ys)} in the other")
        if not xs:
            continue
        d = torch.zeros_like(xs[0], dtype=torch.bool)
        for u, v in zip(xs, ys):
            d = d | differ(u, v)
        if masks and name in masks:
            d = d & masks[name]
        off[name] = int(d.sum())
    return off


# ---- K10 (kernels/shade.py)


def random_bsdf_lanes(n: int, seed: int, device, types=(0, 1, 2, 3)) -> dict:
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


# ---- K11 and K12 (kernels/nee.py)


def random_lights(rng, count: int, types=(0, 1, 2, 3)) -> np.ndarray:
    """A [count, 20] light table of the light types `types` (0 rect, 1 disc,
    2 sphere, 3 distant) in and around the unit cube: rects of any
    orientation and either winding, spheres and discs (radius in column 0,
    centre in 3-5), distant lights of half angles down to 0; a light in
    eight with a colour channel at 0 (never lit)."""
    rows = np.zeros((count, KN.LIGHT_COLS), np.float64)
    kind = rng.choice(np.asarray(types), count)
    p0 = rng.uniform(-1.0, 1.0, (count, 3))
    e1, e2 = rng.normal(size=(2, count, 3)) * 0.5
    rows[:, 0:3] = p0
    rows[:, 3:6] = p0 + e1
    rows[:, 6:9] = p0 + e1 + e2
    rows[:, 9:12] = p0 + e2
    round_ = (kind == 1) | (kind == 2)
    rows[:, 0] = np.where(round_, rng.uniform(0.05, 0.4, count), rows[:, 0])
    rows[:, 12:15] = rng.uniform(1.0, 50.0, (count, 3))
    rows[rng.random(count) < 0.125, 12 + rng.integers(0, 3)] = 0.0
    nrm = rng.normal(size=(count, 3))
    rows[:, 15:18] = nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
    rows[:, 18] = kind
    rows[:, 19] = np.where(rng.random(count) < 0.1, 0.0, rng.uniform(0.005, 0.3, count))
    return rows.astype(np.float32)


def random_nee_lanes(n: int, seed: int, device, types=(0, 1, 2, 3), light_types=(0, 1, 2, 3),
                     num_lights: int = 4, nan_share: float = 0.0) -> dict:
    """The inputs of both halves of the phase, for the checks of K11 and K12
    against their plain versions: n random lanes made from `seed` on the host
    and moved to `device`. The materials, frames, directions, `inside` and
    the path state are random_bsdf_lanes' (of the material types `types`);
    the light table holds `num_lights` random lights of `light_types`
    (random_lights). Positions in and around the lights' cube,
    a tenth of them at a light's centre (inside a sphere light) and a
    twentieth far away (the spherical quad's small solid angles); normals on
    the whole sphere (cos_nl <= 0 on about half the lanes); events of every
    kind (absorbed lanes included), curve hits, lanes shaded or not, and a
    random occlusion of the shadow rays. With nan_share > 0, the last light's
    colour is NaN and that share of the lanes has a NaN diffuse colour or
    roughness, to take both canaries.

    Returns a dict: the keys of nee_light's arguments, and of nee_shade's but
    the handoff (`light_args` and `shade_args` pick them)."""
    base = random_bsdf_lanes(n, seed, "cpu", types)
    rng = np.random.default_rng(seed + 7919)

    def f32(a):
        return torch.tensor(np.ascontiguousarray(a, dtype=np.float32))

    lights = random_lights(rng, num_lights, light_types)
    if nan_share > 0.0:
        lights[-1, 12 + rng.integers(0, 3)] = np.nan
    pos = rng.uniform(-1.5, 1.5, (n, 3))
    at_centre = rng.random(n) < 0.1
    pos[at_centre] = lights[rng.integers(0, num_lights, n), 3:6][at_centre] + rng.normal(size=(n, 3))[at_centre] * 0.05
    far = rng.random(n) < 0.05
    pos[far] *= 60.0
    events = np.asarray([B.BSDF_EVENT_ABSORB, B.BSDF_EVENT_DIFFUSE_REFLECTION, B.BSDF_EVENT_GLOSSY_REFLECTION,
                         B.BSDF_EVENT_SPECULAR_REFLECTION, B.BSDF_EVENT_SPECULAR_TRANSMISSION], np.int32)
    mat = base["mat"]
    if nan_share > 0.0:
        bad = f32(np.where(rng.random(n) < nan_share, np.nan, 0.0))
        mat = mat._replace(diffuse_color=Vec3(mat.diffuse_color.x + bad, *mat.diffuse_color[1:]),
                           roughness=mat.roughness + f32(np.where(rng.random(n) < nan_share, np.nan, 0.0)))
    lanes = dict(
        shade=torch.tensor(rng.random(n) < 0.85), event_type=torch.tensor(rng.choice(events, n)),
        u_light=base["xi"][0], u_x=base["xi"][1], u_y=base["xi"][2], position=Vec3(*(f32(pos[:, k]) for k in range(3))),
        frame=base["frame"], is_curve=torch.tensor(rng.random(n) < 0.2),
        prim=torch.tensor(rng.integers(-1, 1000, n, dtype=np.int32)), light_table=f32(lights), num_lights=num_lights,
        occluded=torch.tensor(rng.random(n) < 0.3), inside=base["inside"], mat=mat, direction=base["direction"],
        radiance=base["radiance"], throughput=base["throughput"])
    return {k: to_device(v, device) for k, v in lanes.items()}


LIGHT_ARGS = ("shade", "event_type", "u_light", "u_x", "u_y", "position", "frame", "is_curve", "prim",
              "light_table", "num_lights")
SHADE_ARGS = ("occluded", "inside", "mat", "frame", "direction", "radiance", "throughput", "shade", "light_table")


def light_args(lanes: dict) -> dict:
    """nee_light's (and nee_light_plain's) arguments of random_nee_lanes' dict, but method."""
    return {k: lanes[k] for k in LIGHT_ARGS}


def shade_args(lanes: dict) -> dict:
    """nee_shade's (and nee_shade_plain's) arguments of random_nee_lanes' dict, but the handoff and enable_hair."""
    return {k: lanes[k] for k in SHADE_ARGS}


# ---- K13 (kernels/surface.py)


def random_tables(rng, *, curves: bool, refine: bool, uv: bool, num_lights: int = 4, rows: int = 256,
                  materials: int = 16, segments: int = 64, textures: int = 4) -> KSF.SurfaceTables:
    """Random tables on the host for the lane checks: an attr table of `rows`
    triangles (random edges, a few degenerate; random octahedral codes and
    uvs, a few of zero uv area; a third emissive, their joined light rows of
    every light type, random_lights), random material rows of every type
    (texture ids -1 or below `textures`, uv transforms with zero
    and negative scales, emission, thin walls), and with `curves` random
    cubic segments whose material ids run past the table's ends."""
    def mat_rows(k):
        m = np.zeros((k, KSF.MAT_COLS))
        m[:, 0] = rng.integers(0, 4, k)
        m[:, 1:4] = rng.random((k, 3))
        m[:, 4:7] = rng.random((k, 3))
        m[:, 5] = np.where(rng.random(k) < 0.15, rng.random(k) * 1e-3, m[:, 5])
        m[:, 7] = rng.uniform(1.0, 2.5, k)
        m[:, 8:11] = rng.random((k, 3))
        m[:, 11] = np.where(rng.random(k) < 0.2, rng.random(k), 1.0)
        m[:, 12:16] = np.where(rng.random((k, 4)) < 0.5, rng.integers(0, textures, (k, 4)), -1)
        m[:, 16:18] = np.where(rng.random((k, 2)) < 0.1, 0.0, rng.uniform(-3.0, 3.0, (k, 2)))
        m[:, 18:20] = rng.uniform(-1.0, 1.0, (k, 2))
        m[:, 20:23] = np.where(rng.random((k, 1)) < 0.2, rng.random((k, 3)) * 4.0, 0.0)
        m[:, 23] = rng.random(k) < 0.3
        return m

    attr = np.zeros((rows, ATTR_JOINED))
    attr[:, 0:3] = rng.uniform(-1.0, 1.0, (rows, 3))
    attr[:, 3:9] = rng.normal(size=(rows, 6)) * 0.5
    attr[rng.random(rows) < 0.03, 3:9] = 0.0
    attr[:, 9:15] = rng.integers(0, 4095, (rows, 6)) * 4096 + rng.integers(0, 4095, (rows, 6))
    attr[:, 15:21] = rng.uniform(-2.0, 2.0, (rows, 6))
    flat_uv = rng.random(rows) < 0.05
    attr[flat_uv, 15:21] = attr[flat_uv, 15:16]
    attr[:, 21] = rng.integers(0, materials, rows)
    attr[:, 22] = np.where(rng.random(rows) < 0.35, rng.integers(0, max(num_lights, 1), rows), -1)
    attr[:, 23] = 1
    attr[:, 24:48] = mat_rows(rows)
    attr[:, 48:68] = random_lights(rng, rows)

    def f32(a):
        return torch.tensor(np.ascontiguousarray(a, dtype=np.float32))

    segs = None
    if curves:
        p0 = rng.uniform(-1.0, 1.0, (segments, 3))
        steps = rng.normal(size=(3, segments, 3)) * 0.2
        ctrl = [p0, p0 + steps[0], p0 + steps[0] + steps[1], p0 + steps[0] + steps[1] + steps[2]]
        widths = rng.uniform(0.01, 0.06, (4, segments))
        mids = rng.integers(-1, materials + 2, segments)
        segs = DeviceCurves(*(f32(c) for c in ctrl), *(f32(w) for w in widths), torch.tensor(mids.astype(np.int32)))
    return KSF.SurfaceTables(f32(attr), f32(mat_rows(materials)), segs, num_lights, refine, uv)


def _basis(u):
    """The uniform cubic B-spline basis at u (f64 [k])."""
    u2, u3 = u * u, u * u * u
    return (1 - 3 * u + 3 * u2 - u3) / 6, (4 - 6 * u2 + 3 * u3) / 6, (1 + 3 * u + 3 * u2 - 3 * u3) / 6, u3 / 6


def random_surface_lanes(n: int, seed: int, device, *, curves: bool = False, refine: bool = True, uv: bool = False,
                         num_lights: int = 4) -> dict:
    """shade_surface's arguments but depth, for the checks of K13 against its
    plain version: n random lanes made from `seed` on the host and moved to
    `device`, over random_tables. Triangle hits with barycentrics in and out
    of the triangle, misses, dead lanes, `inside` both ways, a third of the
    rows emissive (so light hits of every type); with `curves`, two lanes in
    five aimed at a random point of a segment, at distances from its spine
    inside and just outside its radius and with the sweep's t and u a little
    off (the refinement converges, grazes or finds a ghost), beside triangle
    hits nearer and farther than the curve's; last_bsdf_pdf 0 and NaN on a
    few lanes."""
    rng = np.random.default_rng(seed)
    tables = random_tables(rng, curves=curves, refine=refine, uv=uv, num_lights=num_lights)
    rows = tables.attr_table.shape[0]

    def f32(a):
        return torch.tensor(np.ascontiguousarray(a, dtype=np.float32))

    def unit(a):
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    def some(share):
        return rng.random(n) < share

    prim = np.where(some(0.15), -1, rng.integers(0, rows, n)).astype(np.int32)
    hit_t = np.where(prim < 0, 1e16, rng.uniform(0.05, 8.0, n))
    bary = rng.random((2, n))
    outside = some(0.9)
    bary = np.where(outside & (bary.sum(0) > 1.0), 1.0 - bary[::-1], bary)
    origin = rng.uniform(-2.0, 2.0, (n, 3))
    direction = unit(rng.normal(size=(n, 3)))
    chit = None
    if curves:
        seg = np.full(n, -1, np.int32)
        ct, cu = np.full(n, 1e16), np.zeros(n)
        aim = some(0.4)
        k = int(aim.sum())
        s = rng.integers(0, tables.curves.p0.shape[0], k)
        ctrl = [getattr(tables.curves, f"p{j}").cpu().numpy().astype(np.float64)[s] for j in range(4)]
        radii = [getattr(tables.curves, f"w{j}").cpu().numpy().astype(np.float64)[s] for j in range(4)]
        u0 = rng.random(k)
        basis = _basis(u0)
        point = sum(c * b[:, None] for c, b in zip(ctrl, basis))
        r = sum(w * b for w, b in zip(radii, basis))
        d = direction[aim]
        off = unit(np.cross(d, rng.normal(size=(k, 3))))
        dist = r * np.where(rng.random(k) < 0.7, rng.random(k) * 0.95, rng.uniform(0.95, 1.6, k))
        t0 = rng.uniform(0.3, 4.0, k)
        origin[aim] = point + off * dist[:, None] - d * t0[:, None]
        depth_in = np.sqrt(np.maximum(r * r - dist * dist, 0.0))
        seg[aim] = s
        ct[aim] = t0 - depth_in + rng.normal(size=k) * 0.3 * r
        cu[aim] = np.clip(u0 + rng.normal(size=k) * 0.02, -0.05, 1.05)
        near = aim & some(0.3)
        hit_t[near] = ct[near] * rng.uniform(0.2, 0.99, int(near.sum()))
        prim[near] = rng.integers(0, rows, int(near.sum()))
        chit = CurveHit(f32(ct), torch.tensor(seg), f32(cu))
    lbp = np.where(some(0.1), 0.0, rng.uniform(0.0, 5.0, n))
    lbp[some(0.01)] = np.nan
    lanes = dict(
        tables=tables, hit=Hit(f32(hit_t), torch.tensor(prim), f32(bary[0]), f32(bary[1])), chit=chit,
        origin=Vec3(*(f32(origin[:, j]) for j in range(3))), direction=Vec3(*(f32(direction[:, j]) for j in range(3))),
        inside=torch.tensor(some(0.3)), alive=torch.tensor(some(0.85)), specular_bounce=torch.tensor(some(0.5)),
        last_bsdf_pdf=f32(lbp), radiance=Vec3(*(f32(rng.random(n)) for _ in range(3))),
        throughput=Vec3(*(f32(rng.random(n)) for _ in range(3))), t_total=f32(rng.uniform(0.0, 20.0, n)),
        bg=f32(rng.random(3)))
    return {k: to_device(v, device) for k, v in lanes.items()}
