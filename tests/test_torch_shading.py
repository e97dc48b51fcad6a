"""Port shading (light sampling, BSDFs, tonemap, accumulation, camera rays)
against the JAX functions on identical numpy inputs.

Tolerance: rtol 1e-5, atol 1e-6 on every lane of every float output;
integer and boolean outputs (event types) are equal. Both sides compute in
f32 with the same operation order; what differs is the last ULP of
transcendentals (sin, cos, arccos, pow, sqrt) between XLA's CPU library and
torch's. Three outputs have lanes where the math magnifies that ULP, and
only those lanes are held to rtol 1e-2, atol 1e-4 (`_close(..., wide=)`):
- bsdf_sample of OmniPBR (type 1), pdf and bsdf_over_pdf of its glossy
  reflection lanes: the GGX D = a^2 / (pi (cos^2 h (a^2 - 1) + 1)^2)
  magnifies one ULP of cos h by about 4 / a^2 near its peak (seen: 4.8e-3
  relative on 15 of 4096 lanes);
- sample_light and get_light_pdf on distant lights (light type 3): the
  cone pdf 1 / (2 pi (1 - cos theta)) cancels at the small half-angles of
  the test (seen: 7.9e-4);
- sample_light with the spherical-rectangle method on rect lights (method
  1, type 0): its solid angle is four arccos summed less 2 pi (seen: 3e-4).

Each port call runs once, under one torch thread (`_one_thread`). With
several threads, torch 2.13's CPU sqrt can return wrong values from a
fresh worker thread on the first call in a process; ROADMAP.md section C
has the readings and `scripts/torch_cpu_first_call_probe.py` reproduces them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strelka_tpu.ops import bsdf as JB
from strelka_tpu.ops import integrator as JI
from strelka_tpu.ops import light_sampling as JL
from strelka_tpu.ops import tonemap as JT
from strelka_tpu.ops.vec import Vec3 as JVec3
from strelka_tpu.settings import make_default_settings as jax_settings
from strelka_tpu_torch.ops import bsdf as TB
from strelka_tpu_torch.ops import integrator as TI
from strelka_tpu_torch.ops import light_sampling as TL
from strelka_tpu_torch.ops import tonemap as TT
from strelka_tpu_torch.ops.vec import Vec3 as TVec3
from strelka_tpu_torch.settings import make_default_settings as torch_settings

RTOL, ATOL = 1e-5, 1e-6
WIDE_RTOL, WIDE_ATOL = 1e-2, 1e-4
N = 4096


@pytest.fixture(autouse=True)
def _one_thread():
    """One torch thread for the port's calls (see the module docstring)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(port, ref, wide=None):
    """Compare any (nested) NamedTuple / Vec3 / tensor against its JAX twin.

    wide: optional [N] bool mask of the lanes held to the wide bound."""
    if isinstance(port, tuple):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _close(p, r, wide)
        return
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    if p.dtype == np.bool_ or np.issubdtype(p.dtype, np.integer):
        np.testing.assert_array_equal(p, r)
        return
    strict = np.ones(p.shape, bool) if wide is None else ~np.broadcast_to(wide, p.shape)
    np.testing.assert_allclose(p[strict], r[strict], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(p[~strict], r[~strict], rtol=WIDE_RTOL, atol=WIDE_ATOL)


def _vecs(a):
    """[3, N] numpy -> (JAX Vec3, torch Vec3)."""
    a = np.ascontiguousarray(a, np.float32)
    return JVec3(*(jnp.asarray(c) for c in a)), TVec3(*(torch.tensor(c) for c in a))


def _unit(rng, n=N):
    v = rng.normal(size=(3, n))
    return (v / np.linalg.norm(v, axis=0)).astype(np.float32)


def _frames(rng):
    nrm = _unit(rng)
    t = np.cross(nrm.T, _unit(rng).T).T
    t = (t / np.linalg.norm(t, axis=0)).astype(np.float32)
    b = np.cross(nrm.T, t.T).T.astype(np.float32)
    g = nrm + 0.05 * _unit(rng)
    g = (g / np.linalg.norm(g, axis=0)).astype(np.float32)
    parts = [_vecs(x) for x in (nrm, t, b, g)]
    return JB.ShadingFrame(*(p[0] for p in parts)), TB.ShadingFrame(*(p[1] for p in parts)), nrm


def _materials(rng, bsdf_type):
    """SurfaceParams for one BSDF type (roughness spans mirror-like to rough)."""
    f = lambda lo, hi: rng.uniform(lo, hi, N).astype(np.float32)  # noqa: E731
    cols = {
        "diffuse_color": np.stack([f(0.05, 0.9) for _ in range(3)]),
        "metallic": f(0, 1),
        "roughness": np.where(rng.random(N) < 0.1, 0.0, f(0.05, 1.0)).astype(np.float32),
        "specular_level": f(0.2, 0.8),
        "ior": f(1.3, 1.8),
        "glass_color": np.stack([f(0.5, 1.0) for _ in range(3)]),
        "opacity": np.ones(N, np.float32),
        "emission_color": np.zeros((3, N), np.float32),
    }
    thin = rng.random(N) < 0.2
    btype = np.full(N, bsdf_type, np.int32)

    def build(mod, vec, cv):
        return mod.SurfaceParams(
            bsdf_type=cv(btype),
            diffuse_color=vec(cols["diffuse_color"]),
            metallic=cv(cols["metallic"]),
            roughness=cv(cols["roughness"]),
            specular_level=cv(cols["specular_level"]),
            ior=cv(cols["ior"]),
            glass_color=vec(cols["glass_color"]),
            opacity=cv(cols["opacity"]),
            emission_color=vec(cols["emission_color"]),
            thin_walled=cv(thin),
        )

    jm = build(JB, lambda a: _vecs(a)[0], lambda a: jnp.asarray(a))
    tm = build(TB, lambda a: _vecs(a)[1], lambda a: torch.tensor(np.ascontiguousarray(a)))
    return jm, tm, cols["ior"]


@pytest.mark.parametrize("bsdf_type", [0, 1, 2])
def test_bsdf_sample_matches(bsdf_type):
    rng = np.random.default_rng(10 + bsdf_type)
    jf, tf, nrm = _frames(rng)
    jm, tm, ior = _materials(rng, bsdf_type)
    k1 = _unit(rng)
    k1 = np.where((k1 * nrm).sum(0) < 0, -k1, k1)  # mostly on the normal's side
    k1[:, :64] = _unit(rng, 64)  # and some below it
    jk1, tk1 = _vecs(k1)
    xi = rng.random((4, N)).astype(np.float32)
    inside = rng.random(N) < 0.3
    ior1, ior2 = np.where(inside, ior, 1.0).astype(np.float32), np.where(inside, 1.0, ior).astype(np.float32)
    ref = JB.bsdf_sample(jm, jf, jk1, tuple(jnp.asarray(x) for x in xi), jnp.asarray(ior1), jnp.asarray(ior2),
                         enable_hair=False)
    out = TB.bsdf_sample(tm, tf, tk1, tuple(torch.tensor(x) for x in xi), torch.tensor(ior1), torch.tensor(ior2))
    _close(out.event_type, ref.event_type)
    _close(out.k2, ref.k2)
    ggx = (bsdf_type == 1) & (np.asarray(ref.event_type) == TB.BSDF_EVENT_GLOSSY_REFLECTION)
    _close(out.pdf, ref.pdf, wide=ggx)
    _close(out.bsdf_over_pdf, ref.bsdf_over_pdf, wide=ggx)


@pytest.mark.parametrize("bsdf_type", [0, 1, 2])
def test_bsdf_evaluate_matches(bsdf_type):
    rng = np.random.default_rng(20 + bsdf_type)
    jf, tf, _ = _frames(rng)
    jm, tm, _ = _materials(rng, bsdf_type)
    (jk1, tk1), (jk2, tk2) = _vecs(_unit(rng)), _vecs(_unit(rng))
    ref = JB.bsdf_evaluate(jm, jf, jk1, jk2, enable_hair=False)
    out = TB.bsdf_evaluate(tm, tf, tk1, tk2)
    _close(out, ref)


def _light_rows(rng):
    """[20, N] light rows of all four types (rect, disc, sphere, distant)."""
    rows = np.zeros((20, N), np.float32)
    ltype = rng.integers(0, 4, N)
    cx, cz = rng.uniform(-0.5, 0.5, N), rng.uniform(-0.5, 0.5, N)
    hw = rng.uniform(0.1, 0.5, N)
    corners = [(-1, -1), (1, -1), (1, 1), (-1, 1)]
    for i, (sx, sz) in enumerate(corners):
        rows[3 * i + 0] = cx + sx * hw
        rows[3 * i + 1] = 1.99
        rows[3 * i + 2] = cz + sz * hw
    sphere = ltype == 2
    rows[0] = np.where(sphere | (ltype == 1), rng.uniform(0.05, 0.3, N), rows[0])  # radius
    rows[3] = np.where(sphere, cx, rows[3])
    rows[4] = np.where(sphere, 1.6, rows[4])
    rows[5] = np.where(sphere, cz, rows[5])
    rows[12:15] = rng.uniform(10, 5000, (3, N))
    rows[15:18] = _unit(rng)
    rows[18] = ltype
    rows[19] = rng.uniform(0.01, 0.3, N)
    return rows


def _light_params(rows):
    return JI._light_from_rows(jnp.asarray(rows)), TI._light_from_rows(torch.tensor(rows))


@pytest.mark.parametrize("method", [0, 1])
def test_sample_light_matches(method):
    rng = np.random.default_rng(30 + method)
    rows = _light_rows(rng)
    jl, tl = _light_params(rows)
    pos = rng.uniform([-0.9, 0.05, -0.9], [0.9, 1.5, 0.9], (N, 3)).T.astype(np.float32)
    jp, tp = _vecs(pos)
    u, v = rng.random((2, N)).astype(np.float32)
    ref = JL.sample_light(jl, jnp.asarray(u), jnp.asarray(v), jp, method)
    out = TL.sample_light(tl, torch.tensor(u), torch.tensor(v), tp, method)
    _close(out, ref, wide=(rows[18] == 3) | ((rows[18] == 0) & (method == 1)))


def test_light_pdf_normal_and_mis_match():
    rng = np.random.default_rng(40)
    rows = _light_rows(rng)
    jl, tl = _light_params(rows)
    surf = rng.uniform([-0.9, 0.05, -0.9], [0.9, 1.5, 0.9], (N, 3)).T.astype(np.float32)
    on_light = np.stack([rng.uniform(-0.5, 0.5, N), np.full(N, 1.99), rng.uniform(-0.5, 0.5, N)]).astype(np.float32)
    (js, ts), (jo, to) = _vecs(surf), _vecs(on_light)
    _close(TL.get_light_pdf(tl, to, ts), JL.get_light_pdf(jl, jo, js), wide=rows[18] == 3)
    _close(TL.calc_light_normal(tl, to), JL.calc_light_normal(jl, jo))
    _close(TL.calc_light_area(tl), JL.calc_light_area(jl))
    a, b = rng.uniform(0.01, 10, (2, N)).astype(np.float32)
    _close(TL.mis_weight_balance(torch.tensor(a), torch.tensor(b)), JL.mis_weight_balance(jnp.asarray(a), jnp.asarray(b)))


@pytest.mark.parametrize("tonemapper", [0, 1, 2, 3])
def test_tonemap_matches(tonemapper):
    rng = np.random.default_rng(50 + tonemapper)
    img = rng.uniform(0, 3000, (3, 16, 12)).astype(np.float32)
    img[:, 0, 0] = 0.0
    exposure = JT.compute_exposure_value(jax_settings())
    np.testing.assert_array_equal(TT.compute_exposure_value(torch_settings()), exposure)
    ref = JT.apply_tonemap_planar(jnp.asarray(img), tonemapper, exposure, 2.4)
    out = TT.apply_tonemap_planar(torch.tensor(img), tonemapper, exposure, 2.4)
    _close(out, ref)
    _close(TT.planar_to_hwc(out), JT.planar_to_hwc(ref))
    _close(TT.gamma_correction(torch.tensor(img), 2.2), JT.gamma_correction(jnp.asarray(img), 2.2))


def test_accumulate_planar_matches():
    rng = np.random.default_rng(60)
    hist, val = rng.uniform(0, 500, (2, 3, 8, 9)).astype(np.float32)
    counts = rng.integers(0, 6, (8, 9)).astype(np.int32)
    exposure = np.full((3, 1, 1), 6.25e-4, np.float32)
    ref = JI._accumulate_planar(jnp.asarray(hist), jnp.asarray(val), jnp.asarray(exposure), jnp.asarray(counts))
    out = TI._accumulate_planar(torch.tensor(hist), torch.tensor(val), torch.tensor(exposure), torch.tensor(counts))
    _close(out, ref)
    for sub in (0, 3):
        ref = JI._accumulate_planar(jnp.asarray(hist), jnp.asarray(val), jnp.asarray(exposure), jnp.int32(sub))
        out = TI._accumulate_planar(torch.tensor(hist), torch.tensor(val), torch.tensor(exposure), sub)
        _close(out, ref)


def test_camera_rays_and_oct_decode_match():
    from strelka_tpu.scene import testscenes as JTS

    rng = np.random.default_rng(70)
    cam = JTS.cornell_box().get_camera(0)
    cam.update_aspect_ratio(1.0)
    c2v = np.asarray(cam.clip_to_view(), np.float32)
    v2w = np.asarray(cam.view_to_world(), np.float32)
    px, py = rng.integers(0, 64, (2, N))
    jx, jy = rng.random((2, N)).astype(np.float32)
    jp = JI.LaunchParams(jnp.int32(0), jnp.asarray(c2v), jnp.asarray(v2w), jnp.zeros(3), jnp.zeros(3))
    tp = TI.LaunchParams(0, c2v, v2w, np.zeros(3, np.float32), np.zeros(3, np.float32))
    ref = JI.generate_camera_rays(jp, jnp.asarray(px.astype(np.uint32)), jnp.asarray(py.astype(np.uint32)),
                                  jnp.asarray(jx), jnp.asarray(jy), 64, 64)
    out = TI.generate_camera_rays(tp, torch.tensor(px), torch.tensor(py), torch.tensor(jx), torch.tensor(jy), 64, 64)
    _close(out, ref)
    codes = (rng.integers(0, 4095, N) * 4096 + rng.integers(0, 4095, N)).astype(np.float32)
    _close(TI._oct_decode24(torch.tensor(codes)), JI._oct_decode24(jnp.asarray(codes)))
