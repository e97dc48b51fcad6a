"""The Einar-class character stage (scene/character_gen.py) on the card.

(a) The full stage (249,860 triangles, 1,000,000 segments) builds a cone
    tree of four levels over 8,000,000 cones, and the one-shot counters say
    so.
(b) On the small stage of tests/test_torch_character.py, kernels K7/K8 on
    the first launch's camera, bounce-1 and shadow rays (512x384, 1 spp,
    as chip_smoke.py:main_path_rays makes them) against the plain dense
    sweeps on the same rays: t bit for bit, cone and y; occlusion. At this
    hair's width the round cone's f32 closed form reports ghost hits
    outside the strand (ROADMAP C.6), which the plain sweeps keep: the
    scene takes the reach (ops/curves.py:cone_reach), with which K7/K8
    test every cone whose closed form hits. The kernels' counters and final
    t / occlusion equal the plain count of the walk with the reach
    (ops/curves.py:cone_tree_walk) on 2^12 lanes of each set.

These tests need a CUDA card and skip without one. The tests' conftest.py
imports jax, which the card's machine lacks; run them there with

    python -m pytest --noconftest -m card tests/test_torch_character_card.py
"""

import pytest
import torch

from strelka_tpu_torch.loaders.usd import UsdLoader
from strelka_tpu_torch.render.device_scene import build_device_scene
from strelka_tpu_torch.scene.character import ensure_character
from strelka_tpu_torch.scene.scene import Scene

SMALL = dict(around=40, down=25, scalp=320, beard=80, texture=64)  # tests/test_torch_character.py's


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.card
def test_full_stage_builds_a_four_level_cone_tree(card):
    from strelka_tpu_torch.utils import profiling as P

    host = Scene()
    assert UsdLoader().load(ensure_character(), host)
    scene = build_device_scene(host, device=card)
    assert scene.num_cones >= 8_000_000 and len(scene.packed_cones.levels) == 4
    assert P.counters()["cones.tree_levels"] == {"": 4} and P.counters()["scene.curve_segments"] == {"": 1_000_000}
    assert scene.num_triangles == 249_860 and scene.bvh is not None


@pytest.mark.card
def test_small_stage_cone_kernels_equal_the_plain_dense_sweeps(card, tmp_path):
    import chip_smoke as CS

    from strelka_tpu_torch.kernels import cones as KC
    from strelka_tpu_torch.ops import curves as C

    host = Scene()
    assert UsdLoader().load(ensure_character(str(tmp_path), **SMALL), host)
    scene = build_device_scene(host, device=card)
    assert scene.cone_reach == C.CONE_REACH
    cfg = CS.Config("character_small", 512, 384, 1, 3, 0, ())
    _, camera, bounce1, shadow, *_ = CS.main_path_rays(scene, CS.launch_params(host, cfg.width, cfg.height, 0),
                                                       card, cfg)
    off, hits = {}, 0
    for name, rays in (("camera", camera), ("bounce1", bounce1), ("shadow", shadow)):
        args = CS.cone_args(scene, rays)
        t, c, y = KC.cone_closest(*args)
        t_p, c_p, y_p = KC.closest_plain(*args)
        hits += int((c_p >= 0).sum())
        off[name] = int(((t.view(torch.int32) != t_p.view(torch.int32)) | (c != c_p) | (y != y_p)).sum())
        off[name + " any"] = int((KC.cone_any(*args) != KC.any_plain(*args)).sum())
        o, d, tmin, tmax, pc = args
        lanes = torch.arange(0, tmin.shape[0], max(1, tmin.shape[0] // 4096), device=card)[:4096]
        sub = [tuple(c[lanes].contiguous() for c in o), tuple(c[lanes].contiguous() for c in d),
               tmin[lanes].contiguous(), tmax[lanes].contiguous()]
        for any_hit in (False, True):
            st = (KC.cone_any if any_hit else KC.cone_closest)(*sub, pc, stats=True)[-1]
            done = (KC.cone_any if any_hit else KC.cone_closest)(*sub, pc)
            walk = C.cone_tree_walk(pc.geom, pc.tree, *sub, any_hit=any_hit, reach=pc.reach)
            counts = torch.stack([walk.boxes, walk.leaves, walk.cones])
            final = (done != (walk.t < C.MISS_T)) if any_hit else (done[0] != walk.t)
            off[f"{name} counters{' any' if any_hit else ''}"] = int(((st.per_ray != counts).any(dim=0) | final).sum())
    assert hits > 1000  # the groom is in view: a tie of both sweeps on misses alone proves nothing
    assert not any(off.values()), off
