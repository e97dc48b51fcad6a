"""Kernels K7/K8 (kernels/cones.py, csrc/cones.cu) against their plain versions on the card.

On the camera, bounce-1 and bounce-0 shadow rays of the first launch of
hair_patch(256) (10,240 cones, a tree of two levels) and hair_long
(hair_patch(20000): 800,000 cones, three levels), 384x384 at 2 spp (294,912
lanes each), as chip_smoke.py:main_path_rays makes them:

(a) K7's walk of the cone tree equals its `cull=False` sweep of every cone
    on every lane: t bit for bit, cone index and y; K8 equals its own
    `cull=False` on occlusion;
(b) the kernels' per-ray counters (inner boxes slab-tested, leaves swept,
    cones whose own box was entered) and final t / occlusion equal the
    plain count of the walk (ops/curves.py:cone_tree_walk, run on the card)
    on 2^14 lanes spread over the set, and the launch-wide lane slots are
    the per-ray counts summed (a warp's 32 lanes a leaf that ran the closed
    form);
(c) on hair_patch, K7 and K8 equal the plain dense sweeps on those lanes.

These tests need a CUDA card and skip without one. The tests' conftest.py
imports jax, which the card's machine lacks; run them there with

    python -m pytest --noconftest -m card tests/test_torch_cones_card.py
"""

import pytest
import torch

from strelka_tpu_torch.kernels import cones as KC
from strelka_tpu_torch.ops import curves as C

SCENES = ("hair_patch", "hair_long")
RAYS = ("camera", "bounce1", "shadow")
LANES = 1 << 14


@pytest.fixture(scope="module")
def ray_sets():
    """Per scene: its packed cones and the three ray sets of its first launch, as K7/K8's arguments."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import chip_smoke as CS

    from strelka_tpu_torch.render.device_scene import build_device_scene
    from strelka_tpu_torch.scene import testscenes as TS

    dev = torch.device("cuda")
    out = {}
    for name, cfg in (("hair_patch", CS.HAIR), ("hair_long", CS.HAIR_LONG)):
        host = TS.hair_patch(n_curves=CS.HAIR_CURVES[name])
        scene = build_device_scene(host, device=dev)
        _, camera, bounce1, shadow, *_ = CS.main_path_rays(scene, CS.launch_params(host, cfg.width, cfg.height, 0),
                                                           dev, cfg)
        out[name] = {k: CS.cone_args(scene, r) for k, r in zip(RAYS, (camera, bounce1, shadow))}
    return out


def _subset(args):
    o, d, tmin, tmax, pc = args
    lanes = torch.arange(0, tmin.shape[0], tmin.shape[0] // LANES, device=tmin.device)[:LANES]
    sub = lambda a: a[lanes].contiguous()  # noqa: E731
    return lanes, (tuple(sub(c) for c in o), tuple(sub(c) for c in d), sub(tmin), sub(tmax), pc)


@pytest.mark.card
@pytest.mark.parametrize("rays", RAYS)
@pytest.mark.parametrize("scene", SCENES)
def test_tree_walk_equals_the_sweep_of_every_cone(ray_sets, scene, rays):
    args = ray_sets[scene][rays]
    t, c, y = KC.cone_closest(*args)
    t_b, c_b, y_b = KC.cone_closest(*args, cull=False)
    assert torch.equal(t.view(torch.int32), t_b.view(torch.int32)) and torch.equal(c, c_b) and torch.equal(y, y_b)
    assert torch.equal(KC.cone_any(*args), KC.cone_any(*args, cull=False))
    live = args[3] > args[2]
    assert int((c >= 0).sum()) > int(live.sum()) // 20 or rays == "shadow"


@pytest.mark.card
@pytest.mark.parametrize("rays", RAYS)
@pytest.mark.parametrize("scene", SCENES)
def test_counters_equal_the_plain_count_of_the_walk(ray_sets, scene, rays):
    args = ray_sets[scene][rays]
    lanes, sub = _subset(args)
    o, d, tmin, tmax, pc = sub
    t, _, _, st7 = KC.cone_closest(*sub, stats=True)
    occ, st8 = KC.cone_any(*sub, stats=True)
    plain = lambda any_hit: C.cone_tree_walk(pc.geom, pc.tree, o, d, tmin, tmax, any_hit, reach=pc.reach)  # noqa: E731
    for st, walk, done in ((st7, plain(False), t), (st8, plain(True), occ)):
        assert torch.equal(st.per_ray[0], walk.boxes) and torch.equal(st.per_ray[1], walk.leaves)
        assert torch.equal(st.per_ray[2], walk.cones)
        if done.dtype == torch.bool:
            assert torch.equal(done, walk.t < C.MISS_T)
        else:
            assert torch.equal(done.view(torch.int32), walk.t.view(torch.int32))
        assert int(st.slots[0]) == 32 * int(walk.forms.sum()) and int(st.slots[1]) == int(walk.cones.sum())
    live = tmax > tmin
    assert int(st7.per_ray[1][live].min()) >= 0 and not st7.per_ray[:, ~live].any()


@pytest.mark.card
@pytest.mark.parametrize("rays", RAYS)
def test_hair_patch_equals_the_plain_dense_sweeps(ray_sets, rays):
    _, sub = _subset(ray_sets["hair_patch"][rays])
    t, c, y = KC.cone_closest(*sub)
    t_p, c_p, y_p = KC.closest_plain(*sub)
    assert torch.equal(t.view(torch.int32), t_p.view(torch.int32)) and torch.equal(c, c_p) and torch.equal(y, y_p)
    assert torch.equal(KC.cone_any(*sub), KC.any_plain(*sub))
