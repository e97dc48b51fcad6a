"""The port's hair BSDF (ops/hair.py and the hair branches of ops/bsdf.py)
against the JAX functions on identical numpy inputs.

Tolerance: rtol 1e-5, atol 1e-6 on every lane of every float output; event
types and validity are equal. Both sides compute in f32 in the same
operation order; what differs is the last ULP of exp, log, sinh, atan2,
asin, sin and cos between XLA's CPU library and torch's. Two outputs have
lanes where the model magnifies that ULP:
- f and pdf of `hair_eval`, and the pdf of `hair_sample` / `bsdf_sample`, on
  lanes with roughness below 0.25 (there the R lobe's variance 0.25 v0 is
  under 0.02; at the clamp beta_m = 0.03 it is 1.3e-4): the longitudinal
  lobe's exponent (cos(ti + to) - 1) / v magnifies an ULP of an angle by
  1 / v, and a sampled direction sits on the lobe's peak (seen on 4096
  sampled lanes: up to 9.8e-4 relative at roughness 0, 3.1e-5 at 0.12,
  1.5e-5 at 0.2, about 45 lanes in all; 4.4e-5 on one evaluated lane of
  roughness 0). Only those lanes are held to rtol 1e-2, atol 1e-4;
- the sampled direction k2 of hair lanes is held to atol 4e-6: it is the
  cosine and sine of the azimuth phi_o + dphi, a sum of up to 3 pi in
  magnitude, where one ULP of the angle is 4.8e-7 (seen: 1.2e-6 on one lane
  of 4096).
The closed-form oracles of the model (sample/eval consistency, energy
bound, white furnace, double highlight) are in tests/test_torch_oracles.py.

Each port call runs under one torch thread (ROADMAP.md section C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strelka_tpu.ops import bsdf as JB
from strelka_tpu.ops import hair as JH
from strelka_tpu.ops.vec import Vec3 as JVec3
from strelka_tpu_torch.materials import BsdfType
from strelka_tpu_torch.ops import bsdf as TB
from strelka_tpu_torch.ops import hair as TH
from strelka_tpu_torch.ops.vec import Vec3 as TVec3

RTOL, ATOL = 1e-5, 1e-6
WIDE_RTOL, WIDE_ATOL = 1e-2, 1e-4
K2_ATOL = 4e-6
N = 4096


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(port, ref, wide=None, atol=ATOL):
    """A (nested) tuple / Vec3 / tensor against its JAX twin; `wide` is an
    [N] bool mask of the lanes held to the wide bound."""
    if isinstance(port, tuple):
        assert len(port) == len(ref)
        for p, r in zip(port, ref):
            _close(p, r, wide, atol)
        return
    p = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    r = np.asarray(ref)
    assert p.shape == r.shape, (p.shape, r.shape)
    if p.dtype == np.bool_ or np.issubdtype(p.dtype, np.integer):
        np.testing.assert_array_equal(p, r)
        return
    strict = np.ones(p.shape, bool) if wide is None else ~np.broadcast_to(wide, p.shape)
    np.testing.assert_allclose(p[strict], r[strict], rtol=RTOL, atol=atol)
    np.testing.assert_allclose(p[~strict], r[~strict], rtol=WIDE_RTOL, atol=WIDE_ATOL)


def _vecs(a):
    a = np.ascontiguousarray(a, np.float32)
    return JVec3(*(jnp.asarray(c) for c in a)), TVec3(*(torch.tensor(c) for c in a))


def _unit(rng, n=N):
    v = rng.normal(size=(3, n))
    return (v / np.linalg.norm(v, axis=0)).astype(np.float32)


def _frames(rng):
    """Orthonormal fibre frames: normal, tangent (the fibre axis), binormal."""
    nrm = _unit(rng)
    t = np.cross(nrm.T, _unit(rng).T).T
    t = (t / np.linalg.norm(t, axis=0)).astype(np.float32)
    b = np.cross(nrm.T, t.T).T.astype(np.float32)
    parts = [_vecs(x) for x in (nrm, t, b, nrm)]
    return JB.ShadingFrame(*(p[0] for p in parts)), TB.ShadingFrame(*(p[1] for p in parts))


def _materials(rng, bsdf_type):
    """SurfaceParams and the mask of the sharp-lobed lanes (roughness under
    0.25); bsdf_type an int or an [N] array. A tenth of the lanes has
    roughness 0 (below the hair model's clamp)."""
    f = lambda lo, hi: rng.uniform(lo, hi, N).astype(np.float32)  # noqa: E731
    rough = np.where(rng.random(N) < 0.1, 0.0, f(0.05, 1.0)).astype(np.float32)
    cols = dict(diffuse_color=np.stack([f(0.05, 0.9) for _ in range(3)]), metallic=f(0, 1), roughness=rough,
                specular_level=f(0.2, 0.8), ior=f(1.3, 1.8), glass_color=np.stack([f(0.5, 1.0) for _ in range(3)]),
                opacity=np.ones(N, np.float32), emission_color=np.zeros((3, N), np.float32))
    btype = np.broadcast_to(np.asarray(bsdf_type, np.int32), (N,)).copy()
    thin = rng.random(N) < 0.2

    def build(mod, vec, cv):
        return mod.SurfaceParams(bsdf_type=cv(btype), thin_walled=cv(thin),
                                 **{k: vec(v) if v.ndim == 2 else cv(v) for k, v in cols.items()})

    jm = build(JB, lambda a: _vecs(a)[0], jnp.asarray)
    tm = build(TB, lambda a: _vecs(a)[1], lambda a: torch.tensor(np.ascontiguousarray(a)))
    return jm, tm, cols["ior"], rough < 0.25


@pytest.mark.parametrize("seed", [80, 81])
def test_hair_eval_matches(seed):
    rng = np.random.default_rng(seed)
    jf, tf = _frames(rng)
    jm, tm, _, sharp = _materials(rng, BsdfType.HAIR)
    (jk1, tk1), (jk2, tk2) = _vecs(_unit(rng)), _vecs(_unit(rng))
    _close(TH.hair_eval(tm, tf, tk1, tk2), JH.hair_eval(jm, jf, jk1, jk2), wide=sharp)


@pytest.mark.parametrize("seed", [82, 83])
def test_hair_sample_matches(seed):
    rng = np.random.default_rng(seed)
    jf, tf = _frames(rng)
    jm, tm, _, sharp = _materials(rng, BsdfType.HAIR)
    jk1, tk1 = _vecs(_unit(rng))
    xi = rng.random((4, N)).astype(np.float32)
    k2, pdf, over, valid = TH.hair_sample(tm, tf, tk1, tuple(torch.tensor(x) for x in xi))
    jk2, jpdf, jover, jvalid = JH.hair_sample(jm, jf, jk1, tuple(jnp.asarray(x) for x in xi))
    _close(valid, jvalid)
    _close(k2, jk2, atol=K2_ATOL)
    _close(pdf, jpdf, wide=sharp)
    _close(over, jover)
    assert valid.numpy().mean() > 0.9


def test_hair_numerics_match():
    rng = np.random.default_rng(84)
    x = rng.uniform(0.0, 40.0, N).astype(np.float32)
    _close(TH._i0(torch.tensor(np.minimum(x, 12.0))), JH._i0(jnp.asarray(np.minimum(x, 12.0))))
    _close(TH._log_i0(torch.tensor(x)), JH._log_i0(jnp.asarray(x)))
    s = rng.uniform(0.03, 0.7, N).astype(np.float32)
    ang = rng.uniform(-3.14, 3.14, N).astype(np.float32)
    _close(TH._trimmed_logistic(torch.tensor(ang), torch.tensor(s), -TH.M_PI, TH.M_PI),
           JH._trimmed_logistic(jnp.asarray(ang), jnp.asarray(s), -JH.M_PI, JH.M_PI))
    u = rng.random(N).astype(np.float32)
    _close(TH._sample_trimmed_logistic(torch.tensor(u), torch.tensor(s), -TH.M_PI, TH.M_PI),
           JH._sample_trimmed_logistic(jnp.asarray(u), jnp.asarray(s), -JH.M_PI, JH.M_PI))
    wide = rng.uniform(-20, 20, N).astype(np.float32)
    _close(TH._wrap_pi(torch.tensor(wide)), JH._wrap_pi(jnp.asarray(wide)))
    ti, to = rng.uniform(-1.5, 1.5, (2, N)).astype(np.float32)
    v = np.exp(rng.uniform(np.log(2e-4), np.log(4.0), N)).astype(np.float32)  # both branches of M_p
    args = (np.cos(ti), np.cos(to), np.sin(ti), np.sin(to), v)
    _close(TH._mp(*(torch.tensor(a) for a in args)), JH._mp(*(jnp.asarray(a) for a in args)))


def _mixed_types(rng):
    return rng.integers(0, 4, N).astype(np.int32)  # DIFFUSE, OMNI_PBR, OMNI_GLASS, HAIR lanes side by side


def test_bsdf_evaluate_with_hair_matches():
    rng = np.random.default_rng(85)
    jf, tf = _frames(rng)
    btype = _mixed_types(rng)
    jm, tm, _, sharp = _materials(rng, btype)
    (jk1, tk1), (jk2, tk2) = _vecs(_unit(rng)), _vecs(_unit(rng))
    ref = JB.bsdf_evaluate(jm, jf, jk1, jk2, enable_hair=True)
    out = TB.bsdf_evaluate(tm, tf, tk1, tk2, enable_hair=True)
    hair = btype == BsdfType.HAIR
    _close(out, ref, wide=hair & sharp)
    assert (out.pdf.numpy()[hair] > 0.0).mean() > 0.9  # the fibre lobes cover the sphere
    # without the gate a hair lane evaluates as the JAX package's does: nothing
    off = TB.bsdf_evaluate(tm, tf, tk1, tk2, enable_hair=False)
    _close(off, JB.bsdf_evaluate(jm, jf, jk1, jk2, enable_hair=False))
    assert (off.pdf.numpy()[hair] == 0.0).all()
    _close(tuple(c[~torch.tensor(hair)] for c in (*off.bsdf_diffuse, *off.bsdf_glossy, off.pdf)),
           tuple(c[~torch.tensor(hair)] for c in (*out.bsdf_diffuse, *out.bsdf_glossy, out.pdf)))


def test_bsdf_sample_with_hair_matches():
    rng = np.random.default_rng(86)
    jf, tf = _frames(rng)
    btype = _mixed_types(rng)
    jm, tm, ior, sharp = _materials(rng, btype)
    jk1, tk1 = _vecs(_unit(rng))
    xi = rng.random((4, N)).astype(np.float32)
    inside = rng.random(N) < 0.3
    ior1, ior2 = np.where(inside, ior, 1.0).astype(np.float32), np.where(inside, 1.0, ior).astype(np.float32)
    ref = JB.bsdf_sample(jm, jf, jk1, tuple(jnp.asarray(x) for x in xi), jnp.asarray(ior1), jnp.asarray(ior2),
                         enable_hair=True)
    out = TB.bsdf_sample(tm, tf, tk1, tuple(torch.tensor(x) for x in xi), torch.tensor(ior1), torch.tensor(ior2),
                         enable_hair=True)
    _close(out.event_type, ref.event_type)
    _close(out.k2, ref.k2, atol=K2_ATOL)
    hair = btype == BsdfType.HAIR
    ggx = (btype == BsdfType.OMNI_PBR) & (np.asarray(ref.event_type) == TB.BSDF_EVENT_GLOSSY_REFLECTION)
    _close(out.pdf, ref.pdf, wide=ggx | (hair & sharp))  # GGX lanes: see tests/test_torch_shading.py
    _close(out.bsdf_over_pdf, ref.bsdf_over_pdf, wide=ggx)
    assert (out.event_type.numpy()[hair & (out.pdf.numpy() > 1e-12)] == TB.BSDF_EVENT_GLOSSY_REFLECTION).all()
