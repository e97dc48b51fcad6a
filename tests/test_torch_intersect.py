"""Port intersection (plain versions of kernels K2/K3) against the JAX package.

References on the CPU: intersect_closest_bruteforce / intersect_any_bruteforce
(what the JAX CPU path runs) and the Pallas kernels this port replaces,
pallas_intersect_{closest,any}_mxu_small, in interpret mode at
Precision.HIGHEST.

Tolerances: prim ids equal, except at ties, where two prims give t within
1e-5 t (f32 Möller–Trumbore of a shared edge); t within rtol 1e-6 (XLA may
contract products into FMAs, the port rounds each one); occlusion equal.
offset_ray is integer bit stepping: bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strelka_tpu.ops import intersect as JX
from strelka_tpu.ops.vec import Vec3 as JVec3
from strelka_tpu.render.device_scene import RAY_MASK_PRIMARY, RAY_MASK_SHADOW
from strelka_tpu.render.device_scene import build_device_scene as jax_build
from strelka_tpu.scene import testscenes as JTS
from strelka_tpu_torch import kernels as K
from strelka_tpu_torch.ops import intersect as TX
from strelka_tpu_torch.ops.vec import Vec3 as TVec3


class _Soup:
    """A triangle set both frameworks can read (JAX shim + torch tensors)."""

    def __init__(self, v0, e1, e2, mask):
        self.np = (v0, e1, e2, mask)
        self.v0, self.e1, self.e2 = (jnp.asarray(a) for a in (v0, e1, e2))
        self.geom_mask = jnp.asarray(mask)
        self.bvh = None
        self.torch = _TorchTris(v0, e1, e2, mask)


class _TorchTris:
    def __init__(self, v0, e1, e2, mask):
        self.v0, self.e1, self.e2 = (torch.tensor(a) for a in (v0, e1, e2))
        self.geom_mask = torch.tensor(mask)


def _random_soup(n, rng):
    v0 = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    mask = np.ones(n, np.int32)
    mask[: n // 3] = 4  # light proxies (hit by PRIMARY only)
    mask[-3:] = 0  # padding-like triangles
    return _Soup(v0, e1, e2, mask)


def _cornell_soup():
    ds = jax_build(JTS.cornell_box(light_intensity=5000.0, metal_box=True, glass_sphere=True))
    return _Soup(*(np.asarray(a) for a in (ds.v0, ds.e1, ds.e2, ds.geom_mask)))


def _rays(n, rng, soup, kind="random"):
    if kind == "camera":  # from the cornell camera through the box opening
        o = np.tile(np.array([[0.0, 1.0, 3.9]], np.float32), (n, 1))
        d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n), -np.ones(n)], 1)
    elif kind == "inside":  # bounce-like rays from inside the cornell box
        o = rng.uniform([-0.95, 0.05, -0.95], [0.95, 1.95, 0.95], (n, 3))
        d = rng.normal(size=(n, 3))
    else:
        o = rng.uniform(-12, 12, (n, 3))
        d = rng.normal(size=(n, 3))
    o = o.astype(np.float32)
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    tmin = rng.uniform(0.0, 0.5, n).astype(np.float32)
    tmax = rng.choice([1e16, 5.0, 15.0], n).astype(np.float32)
    active = rng.random(n) > 0.1
    ntri = soup.np[0].shape[0]
    exclude = np.where(rng.random(n) < 0.3, rng.integers(0, ntri, n), -1).astype(np.int32)
    return o, d, tmin, tmax, active, exclude


def _jax_vec(a):
    return JVec3(*(jnp.asarray(a[:, k]) for k in range(3)))


def _torch_vec(a):
    return TVec3(*(torch.tensor(np.ascontiguousarray(a[:, k])) for k in range(3)))


def _assert_closest_match(t_p, prim_p, t_ref, prim_ref):
    differ = prim_p != prim_ref
    hits = (prim_p >= 0) & (prim_ref >= 0)
    tie = hits & (np.abs(t_p - t_ref) <= 1e-5 * np.abs(t_ref))
    assert not (differ & ~tie).any(), f"{int((differ & ~tie).sum())} prims differ beyond ties"
    same = hits & ~differ
    np.testing.assert_allclose(t_p[same], t_ref[same], rtol=1e-6)
    np.testing.assert_array_equal(t_p[prim_p < 0], np.float32(1e16))


def test_offset_ray_bit_equal():
    rng = np.random.default_rng(0)
    n = 4096
    p = rng.normal(scale=3.0, size=(n, 3)).astype(np.float32)
    p[:512] *= 0.01  # |p| < 1/32: the additive branch
    p[512:520] = 0.0
    nrm = rng.normal(size=(n, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    ref = JX.offset_ray_vec(_jax_vec(p), _jax_vec(nrm))
    out = TX.offset_ray_vec(_torch_vec(p), _torch_vec(nrm))
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(r).view(np.uint32), o.numpy().view(np.uint32))


_CASES = [("cornell", "camera", 2048, 1), ("cornell", "inside", 2048, 2), ("soup", "random", 1500, 3)]


@pytest.mark.parametrize("scene_kind,ray_kind,n,seed", _CASES)
def test_closest_plain_matches_bruteforce(scene_kind, ray_kind, n, seed):
    rng = np.random.default_rng(seed)
    soup = _cornell_soup() if scene_kind == "cornell" else _random_soup(1100, rng)
    o, d, tmin, tmax, active, exclude = _rays(n, rng, soup, ray_kind)
    ref = JX.intersect_closest_bruteforce(
        soup, _jax_vec(o), _jax_vec(d), jnp.asarray(tmin), jnp.asarray(tmax), RAY_MASK_PRIMARY,
        active=jnp.asarray(active), exclude=jnp.asarray(exclude),
    )
    hit = TX.intersect_closest(
        soup.torch, _torch_vec(o), _torch_vec(d), torch.tensor(tmin), torch.tensor(tmax), RAY_MASK_PRIMARY,
        active=torch.tensor(active), exclude=torch.tensor(exclude),
    )
    prim_ref = np.asarray(ref.prim)
    assert (prim_ref >= 0).sum() > n // 10  # the case exercises hits
    _assert_closest_match(hit.t.numpy(), hit.prim.numpy(), np.asarray(ref.t), prim_ref)
    # u, v are dots with cancellation (|o - v0| up to ~20 against unit-size
    # edges): one FMA contraction on the XLA side moves them by ~1e-5 absolute
    same = (hit.prim.numpy() == prim_ref) & (prim_ref >= 0)
    np.testing.assert_allclose(hit.u.numpy()[same], np.asarray(ref.u)[same], rtol=0, atol=2e-5)
    np.testing.assert_allclose(hit.v.numpy()[same], np.asarray(ref.v)[same], rtol=0, atol=2e-5)
    assert (hit.prim.numpy()[~active] == -1).all()


@pytest.mark.parametrize("scene_kind,ray_kind,n,seed", _CASES)
def test_any_plain_matches_bruteforce(scene_kind, ray_kind, n, seed):
    rng = np.random.default_rng(100 + seed)
    soup = _cornell_soup() if scene_kind == "cornell" else _random_soup(1100, rng)
    o, d, tmin, tmax, active, exclude = _rays(n, rng, soup, ray_kind)
    ref = JX.intersect_any_bruteforce(
        soup, _jax_vec(o), _jax_vec(d), jnp.asarray(tmin), jnp.asarray(tmax), RAY_MASK_SHADOW,
        active=jnp.asarray(active), exclude=jnp.asarray(exclude),
    )
    occ = TX.intersect_any(
        soup.torch, _torch_vec(o), _torch_vec(d), torch.tensor(tmin), torch.tensor(tmax), RAY_MASK_SHADOW,
        active=torch.tensor(active), exclude=torch.tensor(exclude),
    )
    ref = np.asarray(ref)
    assert 0 < ref.sum() < n
    np.testing.assert_array_equal(occ.numpy(), ref)


def test_plain_matches_pallas_small_kernels():
    """The Pallas kernels the port replaces, in interpret mode at HIGHEST."""
    from strelka_tpu.ops.pallas_intersect import (
        pack_tris_mxu,
        pallas_intersect_any_mxu_small,
        pallas_intersect_closest_mxu_small,
    )

    rng = np.random.default_rng(17)
    soup = _random_soup(512, rng)
    n = 512
    o, d, _, _, _, exclude = _rays(n, rng, soup)
    tmin = np.zeros(n, np.float32)
    tmax = np.full(n, 1e16, np.float32)
    tmax[100:140] = 0.0  # dead lanes
    v0, e1, e2, mask = soup.np
    feats, maskp = pack_tris_mxu(v0, e1, e2, mask, tblk=128, super_=1)
    args = (feats, maskp, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmin), jnp.asarray(tmax))
    t_ref, prim_ref = pallas_intersect_closest_mxu_small(
        *args, RAY_MASK_PRIMARY, exclude=jnp.asarray(exclude), tile=256, tblk=128, interpret=True,
        precision=jax.lax.Precision.HIGHEST,
    )
    occ_ref = pallas_intersect_any_mxu_small(
        *args, RAY_MASK_SHADOW, exclude=jnp.asarray(exclude), tile=256, tblk=128, interpret=True,
        precision=jax.lax.Precision.HIGHEST,
    )
    tv = lambda a: torch.tensor(a)  # noqa: E731
    hit = TX.intersect_closest(soup.torch, _torch_vec(o), _torch_vec(d), tv(tmin), tv(tmax), RAY_MASK_PRIMARY,
                               exclude=tv(exclude))
    occ = TX.intersect_any(soup.torch, _torch_vec(o), _torch_vec(d), tv(tmin), tv(tmax), RAY_MASK_SHADOW,
                           exclude=tv(exclude))
    prim_ref = np.asarray(prim_ref)
    # the Pallas fold rounds t up by 8 bits (_fold_closest_packed): its t is
    # held to 2^-15 relative, ids to the tie rule
    differ = hit.prim.numpy() != prim_ref
    both = (hit.prim.numpy() >= 0) & (prim_ref >= 0)
    t_p, t_r = hit.t.numpy(), np.asarray(t_ref)
    assert not (differ & ~(both & (np.abs(t_p - t_r) <= 1e-5 * np.abs(t_r)))).any()
    np.testing.assert_allclose(t_p[both], t_r[both], rtol=2.0**-15)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_ref))


def test_cpu_tensors_run_the_plain_versions():
    rng = np.random.default_rng(4)
    soup = _random_soup(200, rng)
    o, d, tmin, tmax, active, exclude = _rays(300, rng, soup)
    K.reset_counts()
    tv = lambda a: torch.tensor(a)  # noqa: E731
    TX.intersect_closest(soup.torch, _torch_vec(o), _torch_vec(d), tv(tmin), tv(tmax), RAY_MASK_PRIMARY,
                         active=tv(active))
    TX.intersect_any(soup.torch, _torch_vec(o), _torch_vec(d), tv(tmin), tv(tmax), RAY_MASK_SHADOW)
    assert K.launch_counts["intersect_closest"] == K.launch_counts["intersect_any"] == 0
    assert not any(K.plain_cuda_calls.values())
