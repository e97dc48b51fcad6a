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
