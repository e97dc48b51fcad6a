"""Closed-form oracles rerun on the port (no JAX on the port's side).

The oracles of tests/test_radiometric_oracle.py and tests/test_physics.py
that need only ported modules, with their tolerances unchanged: rendered
frames against closed-form radiometry (white furnace, unit-albedo furnace,
inverse-square sphere light), BSDF sample/eval consistency and energy
bounds (diffuse, OmniPBR, OmniGlass), light-sampling pdfs against
Monte-Carlo and closed forms, the accumulate recurrence and the tonemapper
formulas. The ground truth is analytic, so a bug mirrored from the JAX
package into the port cannot satisfy them. The hair cases wait for the
hair BSDF.

Frames are smaller than in the reference's tests (32x32 and 24x24 against
48x48, 128 against 256 spp for the sphere light): the port's CPU path is
eager PyTorch, and the estimators are low-variance (cosine-sampled furnace,
cone-sampled sphere light), so the tolerances hold unchanged.

The port runs on the CPU under one torch thread (torch's multi-threaded CPU
sqrt can differ on a first call, ROADMAP.md section C).
"""

import numpy as np
import pytest
import torch

from strelka_tpu_torch.materials import BsdfType
from strelka_tpu_torch.ops import bsdf as B
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.ops import light_sampling as LS
from strelka_tpu_torch.ops import tonemap as TM
from strelka_tpu_torch.ops.vec import Vec3
from strelka_tpu_torch.render.buffer import BufferDesc, BufferFormat
from strelka_tpu_torch.render.render import RenderFactory, RenderType
from strelka_tpu_torch.scene.camera import Camera
from strelka_tpu_torch.scene.scene import InstanceType, Scene, UniformLightDesc
from strelka_tpu_torch.scene.testscenes import _diffuse_material, _quad, furnace_scene
from strelka_tpu_torch.settings import SharedContext, make_default_settings
from strelka_tpu_torch.utils import math3d as m3


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _v3(rows) -> Vec3:
    rows = np.asarray(rows, np.float32)
    return Vec3(*(torch.tensor(np.ascontiguousarray(rows[:, k])) for k in range(3)))


def _rows(v: Vec3) -> np.ndarray:
    return torch.stack(list(v), dim=1).numpy()


def _t(a, dtype=np.float32):
    return torch.tensor(np.asarray(a, dtype))


# ---------------------------------------------------------------------------
# rendered frames against closed-form radiometry
# ---------------------------------------------------------------------------


def _render_raw(scene, width=48, height=48, spp=8, total=64, depth=4, bg=(0, 0, 0)):
    s = make_default_settings(width, height)
    s.set("render/pt/sppTotal", total)
    s.set("render/pt/spp", spp)
    s.set("render/pt/depth", depth)
    s.set("render/pt/tonemapperType", 3)  # none
    s.set("render/post/gamma", 0.0)  # raw linear
    s.set("render/bgColor", tuple(float(c) for c in bg))
    r = RenderFactory.create_render(RenderType.eTorch, device="cpu")
    r.set_scene(scene)
    r.set_shared_context(SharedContext(s))
    r.init()
    buf = r.create_buffer(BufferDesc(width, height, BufferFormat.FLOAT4))
    for _ in range(max(1, total // spp)):
        r.render(buf)
    return np.asarray(buf.map())[..., :3]


def test_furnace_closed_form():
    """Sphere of albedo rho in a unit environment -> pixel == rho exactly."""
    rho = 0.7
    img = _render_raw(furnace_scene(albedo=rho), width=32, height=32, bg=(1.0, 1.0, 1.0), depth=3)
    h, w = img.shape[:2]
    center = img[h // 2 - 2 : h // 2 + 2, w // 2 - 2 : w // 2 + 2]
    np.testing.assert_allclose(center.mean(axis=(0, 1)), [rho] * 3, atol=0.02)
    # background pixels see the environment directly
    np.testing.assert_allclose(img[1, 1], [1.0] * 3, atol=0.01)


def test_furnace_invisible_at_unit_albedo():
    """rho == 1: the sphere is radiometrically invisible, up to the
    shading-normal leak of a tessellated sphere (mean and tail bounded)."""
    img = _render_raw(furnace_scene(albedo=1.0), width=32, height=32, bg=(1.0, 1.0, 1.0), depth=6)
    assert np.isfinite(img).all()
    assert abs(float(img.mean()) - 1.0) < 0.01
    d = np.abs(img - 1.0)
    assert np.quantile(d, 0.95) < 0.02
    assert float(np.median(d)) < 0.002


def test_sphere_light_inverse_square():
    """Plane point under a sphere light: L_o = rho * L * r^2 / D^2."""
    rho, L, r, D = 0.6, 40.0, 0.25, 2.0
    scene = Scene()
    desc = _diffuse_material("ground", [rho] * 3)
    # pure Lambert: drop the uber material's GGX lobe
    desc.params = {"specular_level": 0.0, "reflection_roughness_constant": 1.0}
    mat = scene.add_material(desc)
    pos, idx, nrm, uv = _quad([-4, 0, 4], [4, 0, 4], [4, 0, -4], [-4, 0, -4])
    mesh = scene.create_mesh(pos, idx, normals=nrm, uvs=uv)
    scene.create_instance(InstanceType.eMesh, mesh, mat, m3.identity4())
    scene.create_light(UniformLightDesc(type=2, position=np.array([0.0, D, 0.0]), color=np.array([1.0, 1.0, 1.0]),
                                        intensity=L, radius=r))
    cam = Camera(name="Main", fov=8.0, aspect=1.0)
    cam.set_position([2.0, 2.0, 2.0])
    cam.look_at([2.0, 2.0, 2.0], [0.0, 0.0, 0.0])
    scene.add_camera(cam)

    img = _render_raw(scene, width=24, height=24, spp=16, total=128, depth=2)
    h, w = img.shape[:2]
    center = img[h // 2 - 2 : h // 2 + 2, w // 2 - 2 : w // 2 + 2].mean(axis=(0, 1))
    np.testing.assert_allclose(center, [rho * L * (r / D) ** 2] * 3, rtol=0.06)


# ---------------------------------------------------------------------------
# BSDFs
# ---------------------------------------------------------------------------


def _frame(n):
    normal = _v3(np.tile([0.0, 0.0, 1.0], (n, 1)))
    tu = _v3(np.tile([1.0, 0.0, 0.0], (n, 1)))
    tv = _v3(np.tile([0.0, 1.0, 0.0], (n, 1)))
    return B.ShadingFrame(normal=normal, tangent_u=tu, tangent_v=tv, geom_normal=normal)


def _params(n, bsdf_type, **over):
    d = dict(
        diffuse_color=np.tile([0.6, 0.5, 0.4], (n, 1)),
        metallic=np.full(n, 0.3),
        roughness=np.full(n, 0.4),
        specular_level=np.full(n, 0.5),
        ior=np.full(n, 1.5),
        glass_color=np.tile([0.9, 0.9, 0.9], (n, 1)),
        opacity=np.ones(n),
        emission_color=np.zeros((n, 3)),
    )
    d.update(over)
    out = {k: _v3(v) if np.ndim(v) == 2 else _t(v) for k, v in d.items()}
    return B.SurfaceParams(bsdf_type=_t(np.full(n, bsdf_type), np.int32),
                           thin_walled=torch.zeros(n, dtype=torch.bool), **out)


def _k1(n, rng):
    k = rng.normal(size=(n, 3)).astype(np.float32)
    k[:, 2] = np.abs(k[:, 2]) + 0.1
    return _v3(k / np.linalg.norm(k, axis=1, keepdims=True))


def _xi(n, rng):
    return tuple(_t(rng.uniform(size=n)) for _ in range(4))


def test_diffuse_sample_eval_consistency():
    n = 4096
    rng = np.random.default_rng(0)
    frame, params, k1 = _frame(n), _params(n, BsdfType.DIFFUSE), _k1(n, rng)
    smp = B.bsdf_sample(params, frame, k1, _xi(n, rng), torch.ones(n), torch.full((n,), 1.5))
    ev = B.bsdf_evaluate(params, frame, k1, smp.k2)
    ok = smp.event_type.numpy() != B.BSDF_EVENT_ABSORB
    np.testing.assert_allclose(ev.pdf.numpy()[ok], smp.pdf.numpy()[ok], rtol=1e-4)
    ratio = _rows(ev.bsdf_diffuse)[ok] / smp.pdf.numpy()[ok][:, None]
    np.testing.assert_allclose(ratio, _rows(smp.bsdf_over_pdf)[ok], rtol=1e-3)


def test_pbr_sample_eval_consistency():
    n = 8192
    rng = np.random.default_rng(1)
    frame, params, k1 = _frame(n), _params(n, BsdfType.OMNI_PBR, roughness=np.full(n, 0.5)), _k1(n, rng)
    smp = B.bsdf_sample(params, frame, k1, _xi(n, rng), torch.ones(n), torch.full((n,), 1.5))
    ev = B.bsdf_evaluate(params, frame, k1, smp.k2)
    ok = (smp.event_type.numpy() != B.BSDF_EVENT_ABSORB) & (smp.pdf.numpy() > 1e-5)
    np.testing.assert_allclose(ev.pdf.numpy()[ok], smp.pdf.numpy()[ok], rtol=1e-3)
    ratio = _rows(ev.bsdf_diffuse + ev.bsdf_glossy)[ok] / smp.pdf.numpy()[ok][:, None]
    np.testing.assert_allclose(ratio, _rows(smp.bsdf_over_pdf)[ok], rtol=2e-3, atol=1e-4)


def test_pbr_white_furnace_bounded():
    """Energy conservation: integral of f*cos over the hemisphere <= 1 (white)."""
    n = 1 << 16
    rng = np.random.default_rng(2)
    params = _params(n, BsdfType.OMNI_PBR, diffuse_color=np.ones((n, 3)), metallic=np.zeros(n),
                     roughness=np.full(n, 0.6))
    k1 = _v3(np.tile([0.0, 0.0, 1.0], (n, 1)))
    smp = B.bsdf_sample(params, _frame(n), k1, _xi(n, rng), torch.ones(n), torch.full((n,), 1.5))
    ok = smp.event_type.numpy() != B.BSDF_EVENT_ABSORB
    reflectance = _rows(smp.bsdf_over_pdf)[ok].mean(axis=0) * ok.mean()
    assert np.all(reflectance < 1.05), reflectance
    assert np.all(reflectance > 0.5), reflectance


def test_glass_energy_and_direction():
    n = 4096
    rng = np.random.default_rng(3)
    k1 = _k1(n, rng)
    smp = B.bsdf_sample(_params(n, BsdfType.OMNI_GLASS), _frame(n), k1, _xi(n, rng), torch.ones(n),
                        torch.full((n,), 1.5))
    ev = smp.event_type.numpy()
    k2 = _rows(smp.k2)
    refl = ev == B.BSDF_EVENT_SPECULAR_REFLECTION
    trans = ev == B.BSDF_EVENT_SPECULAR_TRANSMISSION
    assert refl.any() and trans.any()
    assert (k2[refl][:, 2] > 0).all() and (k2[trans][:, 2] < 0).all()
    assert (smp.pdf.numpy()[refl | trans] == 0).all()  # specular: pdf 0 (MDL convention)
    # Snell's law on transmission: sin_t = sin_i / 1.5
    sin_i = np.sqrt(np.clip(1 - _rows(k1)[trans][:, 2] ** 2, 0, 1))
    sin_t = np.sqrt(np.clip(1 - k2[trans][:, 2] ** 2, 0, 1))
    np.testing.assert_allclose(sin_t, sin_i / 1.5, atol=1e-3)


def test_cosine_hemisphere_stats():
    n = 1 << 16
    u = np.random.default_rng(4).uniform(size=(2, n)).astype(np.float32)
    d = _rows(B.cosine_sample_hemisphere(_t(u[0]), _t(u[1])))
    assert (d[:, 2] >= 0).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-5)
    np.testing.assert_allclose(d[:, 2].mean(), 2.0 / 3.0, atol=5e-3)  # E[cos] of a cosine lobe


# ---------------------------------------------------------------------------
# lights
# ---------------------------------------------------------------------------


def _light(points, normal, light_type, half_angle, radius):
    n = points.shape[0]
    return LS.LightParams(
        p0=_v3(points[:, 0]), p1=_v3(points[:, 1]), p2=_v3(points[:, 2]), p3=_v3(points[:, 3]),
        color=_v3(np.ones((n, 3))), normal=_v3(np.tile(normal, (n, 1))),
        type=torch.full((n,), light_type, dtype=torch.int32), half_angle=torch.full((n,), half_angle),
        radius=torch.full((n,), radius),
    )


def test_rect_light_solid_angle_mc():
    """SphQuad.S equals the MC estimate of the rect's solid angle from the uniform-area pdf."""
    n = 1 << 16
    rng = np.random.default_rng(5)
    pts = np.array([[[0.5, 2.0, 0.5], [0.5, 2.0, -0.5], [-0.5, 2.0, -0.5], [-0.5, 2.0, 0.5]]], np.float32)
    lp = _light(np.tile(pts, (n, 1, 1)), [0.0, 0.0, 0.0], 0, 0.0, 0.0)
    hit = _v3(np.zeros((n, 3)))
    u, v = _t(rng.uniform(size=n)), _t(rng.uniform(size=n))
    uni = LS.sample_rect_light_uniform(lp, u, v, hit)
    omega_mc = float((1.0 / uni.pdf.numpy()).mean())  # E[1/pdf] = Omega
    omega_exact = float(LS.sph_quad_init(lp, hit).S.numpy()[0])
    assert omega_exact == pytest.approx(omega_mc, rel=2e-2)
    sph = LS.sample_rect_light_sphquad(lp, u, v, hit)
    np.testing.assert_allclose(sph.pdf.numpy(), 1.0 / omega_exact, rtol=1e-4)
    pol = _rows(sph.point_on_light)
    np.testing.assert_allclose(pol[:, 1], 2.0, atol=1e-4)
    assert (np.abs(pol[:, [0, 2]]) <= 0.5 + 1e-4).all()


def test_sphere_distant_light_pdfs():
    n = 1024
    rng = np.random.default_rng(6)
    u, v = _t(rng.uniform(size=n)), _t(rng.uniform(size=n))
    pts = np.zeros((n, 4, 3), np.float32)
    pts[:, 0, 0] = 0.5
    pts[:, 1] = [0, 3, 0]  # sphere light of radius 0.5 at (0, 3, 0)
    lp = _light(pts, [0.0, -1.0, 0.0], 2, 0.2, 0.5)
    hit = _v3(np.zeros((n, 3)))
    sph = LS.sample_sphere_light(lp, u, v, hit)
    # visible-cap cone sampling: pdf = 1 / (2 pi (1 - cos_a)), cos_a from r / d
    cos_a = np.sqrt(1.0 - (0.5 / 3.0) ** 2)
    np.testing.assert_allclose(sph.pdf.numpy(), 1.0 / (2 * np.pi * (1 - cos_a)), rtol=1e-4)
    np.testing.assert_allclose(np.linalg.norm(_rows(sph.point_on_light) - [0, 3, 0], axis=1), 0.5, atol=1e-4)
    assert (_rows(sph.L) @ np.array([0, 1.0, 0]) >= cos_a - 1e-4).all()
    mis_pdf = LS.get_light_pdf(lp, sph.point_on_light, hit).numpy()
    np.testing.assert_allclose(mis_pdf, sph.pdf.numpy(), rtol=1e-4)
    # distant light: directions within the half-angle cone around -normal
    d = LS.sample_distant_light(lp, u, v)
    assert (_rows(d.L) @ np.array([0, 1.0, 0]) >= np.cos(0.2) - 1e-5).all()
    np.testing.assert_allclose(d.pdf.numpy(), 1.0 / (2 * np.pi * (1 - np.cos(0.2))), rtol=1e-4)


def test_sphere_light_pdf_distant_stability():
    """1 - cos_a computed stably (sin^2 / (1 + cos)): at d / r = 1e4 the naive f32 difference underflows."""
    n = 8
    r, d = 0.25, 2500.0
    pts = np.zeros((n, 4, 3), np.float32)
    pts[:, 0, 0] = r
    pts[:, 1] = [0, d, 0]
    lp = _light(pts, [0.0, -1.0, 0.0], 2, 0.1, r)
    hit = _v3(np.zeros((n, 3)))
    u = torch.linspace(0.05, 0.95, n)
    s = LS.sample_sphere_light(lp, u, u, hit)
    sin_a = np.float64(r / d)
    expect = 1.0 / (2.0 * np.pi * (sin_a**2 / (1.0 + np.sqrt(1.0 - sin_a**2))))
    np.testing.assert_allclose(s.pdf.numpy(), expect, rtol=1e-3)
    np.testing.assert_allclose(LS.get_light_pdf(lp, s.point_on_light, hit).numpy(), s.pdf.numpy(), rtol=1e-3)
    assert (_rows(s.L) @ np.array([0, 1.0, 0]) >= 1.0 - 3e-8).all()


# ---------------------------------------------------------------------------
# accumulation and tonemapping
# ---------------------------------------------------------------------------


def test_accumulate_matches_reference_recurrence():
    """history_n = invTm(lerp(tm(h_{n-1}), tm(x_n), 1 / (n + 1))) (OptixRender.cu:60-78), planar layout."""
    rng = np.random.default_rng(7)
    exposure = torch.full((3, 1, 1), 0.5)
    samples = rng.uniform(0.0, 4.0, (10, 3, 4, 4)).astype(np.float32)
    hist = torch.zeros((3, 4, 4))
    for i, s in enumerate(samples):
        hist = TI._accumulate_planar(hist, torch.tensor(s), exposure, i)

    def tm(c):
        c = c * 0.5
        return c / (c + 1)

    def itm(c):
        return c / (0.5 - c * 0.5)

    h = samples[0].astype(np.float64)
    for i in range(1, 10):
        h = itm(tm(h) + (tm(samples[i]) - tm(h)) * (1.0 / (i + 1)))
    np.testing.assert_allclose(hist.numpy(), h, rtol=1e-4)


def test_tonemappers_match_reference_formulas():
    xx = np.linspace(0, 4, 64, dtype=np.float32).reshape(-1, 1) * np.array([[1, 0.5, 0.25]], np.float32)
    x = torch.tensor(np.ascontiguousarray(xx.T)).reshape(3, 8, 8)  # planar [3, H, W]
    ones = np.ones(3, np.float32)
    back = lambda img: img.reshape(3, 64).numpy().T  # noqa: E731
    r = back(TM.apply_tonemap_planar(x, TM.ToneMapperType.eReinhard, ones, 0.0))
    lum = xx @ np.array([0.299, 0.587, 0.114])
    np.testing.assert_allclose(r, xx / (lum[:, None] + 1), rtol=1e-5)
    f = back(TM.apply_tonemap_planar(x, TM.ToneMapperType.eFilmic, ones, 0.0))
    np.testing.assert_allclose(f, np.clip((xx * (2.51 * xx + 0.03)) / (xx * (2.43 * xx + 0.59) + 0.14), 0, 1),
                               rtol=1e-5)
    a = back(TM.apply_tonemap_planar(x, TM.ToneMapperType.eACES, ones, 0.0))
    assert a.min() >= 0.0 and a.max() <= 1.0
    np.testing.assert_array_equal(back(TM.apply_tonemap_planar(x, TM.ToneMapperType.eNone, ones, 0.0)), xx)
    np.testing.assert_allclose(back(TM.gamma_correction(x, 2.4)), np.power(xx, 1 / 2.4), rtol=1e-5)
