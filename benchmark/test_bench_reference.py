"""The reference's own sweeps: the culled cone sweep gives the dense sweep's
answer, ray for ray, on a small hair scene."""

import os

import pytest
import torch

import inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 9])
def test_culled_cone_sweep_is_the_dense_sweep(seed):
    from refport.kernels import cones as KC
    from refport.materials import MaterialManager
    from refport.ops import curves as C
    from refport.render.device_scene import build_device_scene

    host = inputs.load_scene("reference", ROOT, {"scene": {"kind": "hair_patch", "n_curves": 300,
                                                           "ctrl_per_curve": 8, "strand_seed": 3}}, seed)
    scene = build_device_scene(host, MaterialManager(), device=torch.device("cpu"), use_bvh=False)
    cones = scene.packed_cones
    gen = torch.Generator().manual_seed(seed % 1000)
    n = 3000
    # rays from a sphere of eyes toward points on the patch, some grazing the ground, some dead
    eye = torch.randn((n, 3), generator=gen) * 1.5 + torch.tensor([0.0, 1.5, 0.0])
    aim = torch.rand((n, 3), generator=gen) * torch.tensor([2.0, 1.2, 2.0]) - torch.tensor([1.0, 0.0, 1.0])
    d = aim - eye
    d = d / d.norm(dim=1, keepdim=True)
    o, dv = tuple(eye[:, k].contiguous() for k in range(3)), tuple(d[:, k].contiguous() for k in range(3))
    tmin = torch.zeros(n)
    tmax = torch.where(torch.rand(n, generator=gen) < 0.1, torch.zeros(n), torch.full((n,), 1e16))
    want = C.intersect_curves_closest_plain(cones.geom, o, dv, tmin, tmax)
    got = KC.culled_plain(o, dv, tmin, tmax, cones)
    assert int((want[1] >= 0).sum()) > n // 10
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    want_any = C.intersect_curves_any_plain(cones.geom, o, dv, tmin, tmax)
    assert torch.equal(want_any, KC.cone_any(o, dv, tmin, tmax, cones))


def _tri_rays(scene, gen, n):
    """Camera-like rays into the scene, rays leaving the surfaces they hit
    (bounce rays, their own prim excluded; a quarter grazing the surface)
    and shadow rays of finite length, with some dead lanes."""
    from refport.kernels import intersect as KI

    lo = scene.v0.min(dim=0).values
    hi = scene.v0.max(dim=0).values
    centre, size = (lo + hi) / 2, (hi - lo).max()
    eye = centre + (torch.rand((n, 3), generator=gen) - 0.5) * size + torch.tensor([0.0, 0.25, 0.0]) * size
    aim = lo + torch.rand((n, 3), generator=gen) * (hi - lo)
    d = aim - eye
    d = d / d.norm(dim=1, keepdim=True)
    o, dv = tuple(eye.T.contiguous()), tuple(d.T.contiguous())
    tmin = torch.zeros(n)
    tmax = torch.where(torch.rand(n, generator=gen) < 0.05, torch.zeros(n), torch.full((n,), 1e16))
    t, prim, _, _ = KI.closest_plain(o, dv, tmin, tmax, None, scene.v0, scene.e1, scene.e2, scene.geom_mask, 0xFF)
    hit = prim >= 0
    p = eye + d * torch.where(hit, t, 0.0)[:, None]
    nrm = torch.linalg.cross(scene.e1[prim.clamp(min=0).long()], scene.e2[prim.clamp(min=0).long()])
    nrm = nrm / nrm.norm(dim=1, keepdim=True).clamp(min=1e-30)
    out = torch.randn((n, 3), generator=gen)
    graze = torch.rand(n, generator=gen) < 0.25  # nearly in the surface's plane
    out = torch.where(graze[:, None], out - (out * nrm).sum(1, keepdim=True) * nrm * 0.999, out)
    out = out / out.norm(dim=1, keepdim=True)
    o2 = tuple(p.T.contiguous())
    ex = torch.where(hit, prim, -1).to(torch.int32)
    shadow_t = torch.rand(n, generator=gen) * size
    return [(o, dv, tmin, tmax, None), (o2, tuple(out.T.contiguous()), torch.full((n,), 1e-4), tmax, ex),
            (o2, tuple(out.T.contiguous()), torch.zeros(n), torch.where(hit, shadow_t, 0.0), ex),
            _grazing_rays(scene, torch.Generator().manual_seed(100), 2000, size)]


def _grazing_rays(scene, gen, n, size):
    """Rays below the margin's domain: each aimed at a point on an edge or a
    vertex of a random live triangle, nearly in its plane (the normalised
    determinant about 1e-2 to 1e-6, under NU_MIN), from a distance of up to
    the scene's size, over an interval that ends just before or just past the aim or runs on."""
    live = torch.nonzero(scene.geom_mask != 0).flatten()
    tri = live[torch.randint(live.numel(), (n,), generator=gen)]
    v0, e1, e2 = scene.v0[tri], scene.e1[tri], scene.e2[tri]
    a = torch.rand(n, generator=gen)
    edge = torch.randint(4, (n,), generator=gen)  # e1, e2, the far edge, a vertex
    wa = torch.where(edge == 0, a, torch.where(edge == 2, 1.0 - a, torch.zeros(n)))
    wb = torch.where(edge == 1, a, torch.where(edge == 2, a, torch.zeros(n)))
    aim = v0 + wa[:, None] * e1 + wb[:, None] * e2
    nrm = torch.linalg.cross(e1, e2)
    nrm = nrm / nrm.norm(dim=1, keepdim=True).clamp(min=1e-30)
    along = torch.randn((n, 3), generator=gen)
    along = along - (along * nrm).sum(1, keepdim=True) * nrm
    along = along / along.norm(dim=1, keepdim=True).clamp(min=1e-30)
    tilt = 10.0 ** -(2.0 + 4.0 * torch.rand(n, generator=gen))
    sign = torch.where(torch.rand(n, generator=gen) < 0.5, -1.0, 1.0)
    d = along + (sign * tilt)[:, None] * nrm
    d = d / d.norm(dim=1, keepdim=True)
    dist = (0.01 + torch.rand(n, generator=gen)) * size
    o = aim - d * dist[:, None]
    tmax = torch.where(torch.rand(n, generator=gen) < 0.5, torch.full((n,), 1e16),
                       dist * (1.0 + 10.0 ** -(3.0 + 3.0 * torch.rand(n, generator=gen)) * sign))
    return tuple(o.T.contiguous()), tuple(d.T.contiguous()), torch.zeros(n), tmax, None


@pytest.mark.parametrize("name,spec", [("kitchen", {"kind": "usd", "stage": "benchmark/data/kitchen/kitchen.usdc"}),
                                       ("box_field", {"kind": "box_field", "grid": 48, "field_seed": 7})])
def test_culled_triangle_sweep_is_the_dense_sweep(name, spec):
    """The reference's culled sweep over the 32-triangle groups gives the dense
    sweep's closest hit (t, prim, u, v bit for bit) and occlusion, ray for ray,
    on the BVH cells' scenes."""
    from refport.kernels import intersect as KI
    from refport.materials import MaterialManager
    from refport.ops.slab import NU_MIN, normalised_det
    from refport.render.device_scene import build_device_scene

    torch.set_num_threads(4)
    host = inputs.load_scene("reference", ROOT, {"scene": spec}, 0)
    scene = build_device_scene(host, MaterialManager(), device=torch.device("cpu"), use_bvh=False)
    tris = (scene.v0, scene.e1, scene.e2, scene.geom_mask)
    gen = torch.Generator().manual_seed(11)
    hits, below = 0, 0
    for o, d, tmin, tmax, ex in _tri_rays(scene, gen, 600):
        want = KI.closest_plain(o, d, tmin, tmax, ex, *tris, 0xFF)
        got = KI.culled_plain(o, d, tmin, tmax, ex, *tris, 0xFF, scene.tri_bounds)
        for w, g in zip(want, got):
            assert torch.equal(w, g)
        hits += int((want[1] >= 0).sum())
        hit = want[1] >= 0
        prim = want[1][hit].long()
        nu = normalised_det(tuple(c[hit] for c in d), scene.e1[prim], scene.e2[prim], paired=True)
        below += int((nu < NU_MIN).sum())
        want_any = KI.any_plain(o, d, tmin, tmax, ex, *tris, 0xFF)
        assert torch.equal(want_any, KI.culled_plain(o, d, tmin, tmax, ex, *tris, 0xFF, scene.tri_bounds,
                                                     any_hit=True))
    assert hits > 600
    assert below > 200  # the grazing rays' hits lie below the port's margin's domain
