"""Kernel K13's wrapper (kernels/surface.py) on the CPU: CPU tensors go to the
plain version, a short background and curve hits without curves are refused,
the CUDA source's refinement constants match the Python side's, and the
reordered plain phase (the curve step before the texture lookups, which get no
texture on a curve lane) computes what the phase computed in one piece, lane by
lane and in whole renders. The refusals, counters and field order shared by the
lane kernels are in tests/test_torch_lanes.py; the kernel itself is held
against the plain version on the card (tests/test_torch_shade_surface_card.py)."""

import inspect
import os
import re
import types

import numpy as np
import pytest
import torch
import torch_lanes as TL

from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.kernels import surface as KSF
from strelka_tpu_torch.ops import curve_refine as CR
from strelka_tpu_torch.ops import integrator as I
from strelka_tpu_torch.ops import light_sampling as LS
from strelka_tpu_torch.ops import vec as V
from strelka_tpu_torch.ops.vec import Vec3

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "strelka_tpu_torch", "csrc")
# (curves, refine, uv): the kernel's instances
INSTANCES = [(False, False, False), (False, False, True), (True, False, False), (True, True, False),
             (True, False, True), (True, True, True)]


def _former_head(tables, hit, chit, origin, direction, inside, alive, specular_bounce, last_bsdf_pdf, radiance,
                 throughput, bg, depth):
    """The phase as the integrator ran it in one piece, up to the texture
    lookups: (radiance, throughput, position, frame, mat, material rows,
    uv, hit_surface, is_curve, missed, the refined curve hits)."""
    n, dev = alive.shape[0], alive.device
    is_curve = torch.zeros(n, dtype=torch.bool, device=dev)
    if chit is not None:
        if tables.refine:
            chit = KSF.refine_curve_hit(tables.curves, origin, direction, chit)
        is_curve = alive & (chit.seg >= 0) & (chit.t < hit.t)
    missed = alive & (hit.prim < 0) & ~is_curve
    radiance = V.where(missed, radiance + throughput * Vec3(bg[0], bg[1], bg[2]), radiance)
    throughput = V.where(missed, V.full(n, 0.0, dev), throughput)
    position, frame, raw_light_id, attr_rows, uv = KSF.gather_surface(tables.attr_table, hit, inside, tables.uv)
    prim_light_id = torch.where(hit.prim >= 0, raw_light_id, -1)
    hit_light = alive & ~missed & (prim_light_id >= 0) & ~is_curve
    hit_surface = alive & ~missed & ~hit_light
    if tables.num_lights > 0:
        lp = LS.light_from_rows(attr_rows[48:68])
        hit_point_l = origin + direction * hit.t
        light_n = LS.calc_light_normal(lp, hit_point_l)
        cos_l = -V.dot(direction, light_n)
        direct_vis = specular_bounce if depth > 0 else torch.ones_like(specular_bounce)
        light_pdf_hit = LS.get_light_pdf(lp, hit_point_l, origin) / tables.num_lights
        mis_w = LS.mis_weight_balance(torch.clamp(last_bsdf_pdf, min=1e-20), light_pdf_hit)
        w = cos_l * torch.where(direct_vis, 1.0, mis_w)
        add = hit_light & (cos_l > 0.0)
        radiance = V.where(add, radiance + throughput * lp.color * w, radiance)
    throughput = V.where(hit_light, V.full(n, 0.0, dev), throughput)
    mat_rows = attr_rows[24:48]
    mat = KSF.material_from_rows(mat_rows)
    return radiance, throughput, position, frame, mat, mat_rows, uv, hit_surface, is_curve, missed, chit


def _t_hit(t_total, alive, missed, is_curve, hit, chit):
    t_eff = torch.where(is_curve, chit.t, hit.t) if chit is not None else hit.t
    return t_total + torch.where(alive & ~missed, t_eff, 0.0)


def _one_piece(lookups, tables, hit, chit, origin, direction, inside, alive, specular_bounce, last_bsdf_pdf, radiance,
               throughput, t_total, bg, *, depth):
    """The phase in one piece, the texture lookups (`lookups(mat, frame,
    tex_rows, uv, t_hit)`, on a textured scene) before the curve step."""
    (radiance, throughput, position, frame, mat, mat_rows, uv, hit_surface, is_curve, missed,
     chit) = _former_head(tables, hit, chit, origin, direction, inside, alive, specular_bounce, last_bsdf_pdf,
                          radiance, throughput, bg, depth)
    t_hit = None
    if tables.uv:
        t_hit = _t_hit(t_total, alive, missed, is_curve, hit, chit)
        mat, frame = lookups(mat, frame, tuple(mat_rows[12:20]), uv, t_hit)
    if chit is not None:
        position, frame, mat = KSF.curve_surface(tables.curves, tables.mat_table, chit, is_curve, origin, direction,
                                                 inside, position, frame, mat)
    return radiance, throughput, position, frame, mat, hit_surface, is_curve, t_hit


def _atlas_scene():
    """A scene stand-in with the kitchen's four textures in its atlas, for shade_textures."""
    from strelka_tpu_torch.scene.kitchen import kitchen_dir
    from strelka_tpu_torch.textures import TextureManager, atlas_to_device

    tm = TextureManager()
    for name in ("wood", "fabric", "checker", "wallpaper"):
        tm.load(os.path.join(kitchen_dir(), "textures", name + ".png"), srgb=name == "wood")
    return types.SimpleNamespace(textures=atlas_to_device(tm.build_atlas(), "cpu"), tex_columns=(12, 13, 14, 15))


def _refine_classes(lanes) -> dict:
    """How the refinement ends on the live lanes that hit a cone: converged,
    grazing (the sphere fallback) or a ghost."""
    c, chit, alive = lanes["tables"].curves, lanes["chit"], lanes["alive"]
    sid = torch.clamp(chit.seg, min=0).to(torch.int64)
    ctrl = tuple(Vec3(p[sid, 0], p[sid, 1], p[sid, 2]) for p in (c.p0, c.p1, c.p2, c.p3))
    res = CR.refine_curve_hit(ctrl, tuple(w[sid] for w in (c.w0, c.w1, c.w2, c.w3)), lanes["origin"],
                              lanes["direction"], chit.t, chit.u)
    live = alive & (chit.seg >= 0)
    graze = ~res.converged & res.sphere_hit
    return {"converged": int((live & res.converged).sum()), "graze": int((live & graze).sum()),
            "ghost": int((live & ~res.converged & ~graze).sum())}


@pytest.mark.parametrize("curves, refine, uv", INSTANCES)
@pytest.mark.parametrize("n", (1, 257))
def test_cpu_tensors_take_the_plain_version(n, curves, refine, uv):
    lanes = TL.random_surface_lanes(n, 3 + n, "cpu", curves=curves, refine=refine, uv=uv)
    K.reset_counts()
    got = KSF.shade_surface(**lanes, depth=1)
    assert K.launch_counts["shade_surface"] == 0 and K.plain_cuda_calls["shade_surface"] == 0
    assert not any(TL.lanes_off(got, KSF.shade_surface_plain(**lanes, depth=1)).values())
    assert got.mat.bsdf_type.dtype == torch.int32 and got.is_curve.dtype == torch.bool
    assert (got.tex_rows is not None) == uv and (got.t_hit is not None) == uv
    assert not (got.is_curve & ~lanes["alive"]).any() and not (got.hit_surface & ~lanes["alive"]).any()


@pytest.mark.parametrize("num_lights", (1, 4))
@pytest.mark.parametrize("depth", (0, 2))
@pytest.mark.parametrize("curves, refine, uv", INSTANCES)
def test_reordered_phase_is_the_phase_in_one_piece(curves, refine, uv, depth, num_lights):
    """Every output of the reordered plain phase, the texture lookups after
    it, bit-equal to the phase in one piece on every lane: misses, dead
    lanes, light hits of every type, triangle hits from inside and outside,
    and curve hits that converge, graze or are ghosts, with and without
    textures."""
    torch.set_num_threads(1)  # torch 2.13's CPU first-call sqrt fault (ROADMAP C)
    n = 3000
    lanes = TL.random_surface_lanes(n, 100 + 7 * depth + num_lights, "cpu", curves=curves, refine=refine, uv=uv,
                             num_lights=num_lights)
    scene = _atlas_scene()
    rng = np.random.default_rng(depth)
    sample_idx = torch.tensor(rng.integers(0, 2 ** 32, n, dtype=np.int64))
    slot = torch.arange(n, dtype=torch.int32)

    def lookups(mat, frame, tex_rows, uv_, t_hit):
        return I.shade_textures(scene, mat, frame, tex_rows, uv_, t_hit, 0.002, sample_idx, slot, depth)

    whole = _one_piece(lookups, **lanes, depth=depth)
    sf = KSF.shade_surface_plain(**lanes, depth=depth)
    mat, frame = sf.mat, sf.frame
    if uv:
        mat, frame = lookups(mat, frame, sf.tex_rows, sf.uv, sf.t_hit)
    split = KSF.Surface(sf.radiance, sf.throughput, sf.position, frame, mat, sf.hit_surface, sf.is_curve, None,
                        None, sf.t_hit)
    one = KSF.Surface(*whole[:7], None, None, whole[7])
    off = TL.lanes_off(split, one)
    assert not any(off.values()), off
    alive, prim = lanes["alive"], lanes["hit"].prim
    light_hit = alive & ~sf.hit_surface & (prim >= 0) & ~sf.is_curve
    assert (alive & (prim < 0) & ~sf.is_curve).any() and light_hit.any() and (sf.hit_surface & lanes["inside"]).any()
    assert (sf.radiance.x != lanes["radiance"].x)[light_hit].any()  # a light hit added radiance
    if curves:
        assert (sf.is_curve & lanes["inside"]).any() and (sf.is_curve & (prim >= 0)).any()
        if refine:
            classes = _refine_classes(lanes)
            assert all(v > 0 for v in classes.values()), classes
        if uv:  # a curve lane in front of a textured triangle: the one piece looked it up, then overwrote it
            tri_ids = lanes["tables"].attr_table[torch.clamp(prim, min=0).long(), 36:40]
            assert (sf.is_curve & (tri_ids >= 0).any(1)).any()
            assert (torch.stack(sf.tex_rows[:4])[:, sf.is_curve] == -1.0).all()


def _scene(name: str):
    from strelka_tpu_torch.scene import testscenes as TS
    from strelka_tpu_torch.scene.kitchen import kitchen_dir
    from strelka_tpu_torch.scene.scene import UniformLightDesc

    tex = os.path.join(kitchen_dir(), "textures")
    if name.startswith("cornell"):
        scene = TS.cornell_box()
        if name == "cornell_textured":  # the white walls in kitchen's wood (tests/test_torch_textured_render.py)
            white = scene.materials[0]
            white.params = dict(white.params, diffuse_texture=os.path.join(tex, "wood.png"),
                                uv_scale=np.array([2.0, 2.0], np.float32))
        return scene
    scene = TS.hair_patch(n_curves=16)
    if name == "hair_textured":
        # the ground under the strands textured (a diffuse and a normal map)
        # and a rect light over them: curves, textures and light hits at once
        ground = scene.materials[0]
        ground.params = dict(ground.params, diffuse_texture=os.path.join(tex, "wood.png"),
                             normalmap_texture=os.path.join(tex, "fabric.png"),
                             uv_scale=np.array([2.0, 2.0], np.float32))
        scene.create_light(UniformLightDesc(type=0, position=np.array([0.0, 1.6, 0.0]),
                                            orientation=np.array([-90.0, 0.0, 0.0]), color=np.array([1.0, 0.9, 0.8]),
                                            intensity=800.0, width=0.6, height=0.6))
    return scene


def _render(name: str, frames: int = 2):
    from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
    from strelka_tpu_torch.render.render import TorchRender
    from strelka_tpu_torch.settings import SharedContext, make_default_settings

    s = make_default_settings(16, 16)
    s.set("render/pt/spp", 1)
    s.set("render/pt/depth", 4)
    s.set("render/pt/sppTotal", 64)
    r = TorchRender(device="cpu")
    r.set_scene(_scene(name))
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(16, 16, BufferFormat.FLOAT4))
    images = []
    for _ in range(frames):
        r.render(buf)
        images.append(buf.map().copy())
    return images


def _patch_one_piece(monkeypatch):
    """The integrator's surface phase and texture lookups as they ran in one
    piece: the lookups on every lane's triangle material, then the curve
    step (its position, which no lookup changes, already in the phase's)."""
    lookups = I.shade_textures
    pending = {}

    def surface(tables, hit, chit, origin, direction, inside, alive, specular_bounce, last_bsdf_pdf, radiance,
                throughput, t_total, bg, *, depth):
        pending.clear()
        (radiance, throughput, position, frame, mat, mat_rows, uv, hit_surface, is_curve, missed,
         chit) = _former_head(tables, hit, chit, origin, direction, inside, alive, specular_bounce, last_bsdf_pdf,
                              radiance, throughput, bg, depth)
        if chit is not None:
            step = dict(curves=tables.curves, mat_table=tables.mat_table, chit=chit, is_curve=is_curve, origin=origin,
                        direction=direction, inside=inside, position=position)
            if tables.uv:
                pending.update(step)
                position = KSF.curve_surface(**step, frame=frame, mat=mat)[0]
            else:
                position, frame, mat = KSF.curve_surface(**step, frame=frame, mat=mat)
        tex_rows = t_hit = None
        if tables.uv:
            tex_rows, t_hit = tuple(mat_rows[12:20]), _t_hit(t_total, alive, missed, is_curve, hit, chit)
        return KSF.Surface(radiance, throughput, position, frame, mat, hit_surface, is_curve, tex_rows, uv, t_hit)

    def textures(scene, mat, frame, *args):
        mat, frame = lookups(scene, mat, frame, *args)
        if pending:
            _, frame, mat = KSF.curve_surface(**pending, frame=frame, mat=mat)
        return mat, frame

    monkeypatch.setattr(KSF, "shade_surface", surface)
    monkeypatch.setattr(I, "shade_textures", textures)


@pytest.mark.parametrize("name", ("cornell", "hair_patch", "cornell_textured", "hair_textured"))
def test_render_reordered_phase_bit_equal_to_the_phase_in_one_piece(name, monkeypatch):
    torch.set_num_threads(1)  # torch 2.13's CPU first-call sqrt fault (ROADMAP C)
    calls = []
    lookups = I.shade_textures
    monkeypatch.setattr(I, "shade_textures", lambda *a, **k: calls.append(1) or lookups(*a, **k))
    split = _render(name)
    # trace_paths looks the lookups up in the module at each bounce (the
    # benchmark's texture range wraps them there)
    assert len(calls) == (8 if name.endswith("_textured") else 0)
    monkeypatch.setattr(I, "shade_textures", lookups)
    _patch_one_piece(monkeypatch)
    whole = _render(name)
    assert all(np.isfinite(a).all() for a in split)
    off = [int((a.view(np.int32) != b.view(np.int32)).sum()) for a, b in zip(split, whole)]
    assert not any(off), off


def test_background_and_curves_refused():
    lanes = TL.random_surface_lanes(16, 2, "cpu")
    with pytest.raises(ValueError, match="shade_surface: bg"):
        KSF.shade_surface(**{**lanes, "bg": lanes["bg"][:2]}, depth=0)
    curved = TL.random_surface_lanes(16, 2, "cpu", curves=True)
    with pytest.raises(ValueError, match="curve segments"):
        KSF.shade_surface(**{**lanes, "chit": curved["chit"]}, depth=0)


def test_untextured_phase_takes_no_path_length():
    """t_total is read on a textured scene only: None passes elsewhere."""
    lanes = TL.random_surface_lanes(16, 2, "cpu")
    assert KSF.shade_surface(**{**lanes, "t_total": None}, depth=0).t_hit is None
    with pytest.raises(ValueError, match="shade_surface: t_total"):
        KSF.shade_surface(**{**TL.random_surface_lanes(16, 2, "cpu", uv=True), "t_total": None}, depth=0)


def test_refinement_constants_match_the_source():
    with open(os.path.join(CSRC, "surface.cu"), encoding="utf-8") as f:
        src = f.read()
    iters = int(re.search(r"constexpr int kIters = (\d+);", src).group(1))
    tol = float(re.search(r"constexpr double kTol = ([0-9.e-]+);", src).group(1))
    assert iters == inspect.signature(CR.refine_scene_curve_hit).parameters["iters"].default
    assert tol == inspect.signature(CR.refine_curve_hit).parameters["tol"].default
