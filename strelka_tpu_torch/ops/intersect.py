"""Ray-scene intersection + the exact ray-origin offset.

The PyTorch counterpart of strelka_tpu/ops/intersect.py. The dispatch is
the reference's: a scene with a BVH goes to the traversal (kernels K5 and
K6 on CUDA tensors, the plain lockstep walk on CPU tensors), a flat scene
to the sweep over all triangles (kernels K2 and K3, or their plain
versions, the brute-force sweeps of the JAX CPU path); on the card K2/K3
test only the 32-triangle groups whose box a ray enters
(`DeviceScene.tri_bounds`). Rays are
component-major Vec3 (ops/vec.py); prim ids are in the scene's triangle
order, which is the BVH's leaf order where there is one. A scene's curves
are swept apart from its triangles: `intersect_curves_closest` and
`intersect_curves_any` run the round-cone kernels K7 and K8 (their plain
dense sweep on CPU tensors) over the scene's packed cones; both walk the
tree of boxes over the cones, each ray nearest first.

Also hosts offset_ray, the exact port of the Ray Tracing Gems self-
intersection offset (OptixRender_radiance_closest_hit.cu:218-233).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from strelka_tpu_torch.kernels import bvh as KB
from strelka_tpu_torch.kernels import cones as KC
from strelka_tpu_torch.kernels import intersect as KI
from strelka_tpu_torch.ops.curves import CurveHit, cone_hit
from strelka_tpu_torch.ops.vec import Vec3


class Hit(NamedTuple):
    t: torch.Tensor  # [N] f32, 1e16 = miss
    prim: torch.Tensor  # [N] int32, -1 = miss
    u: torch.Tensor  # [N] f32 barycentric (reference: attr weight of v1)
    v: torch.Tensor  # [N] f32


def _offset_component(p: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    of_i = (256.0 * n).to(torch.int32)  # truncation toward zero, as XLA's cast
    p_i = (p.view(torch.int32) + torch.where(p < 0, -of_i, of_i)).view(torch.float32)
    return torch.where(torch.abs(p) < 1.0 / 32.0, p + (1.0 / 65536.0) * n, p_i)


def offset_ray_vec(p: Vec3, n: Vec3) -> Vec3:
    """Bit-exact offset_ray (RT Gems ch.6), cu:218-233, per component."""
    return Vec3(_offset_component(p.x, n.x), _offset_component(p.y, n.y), _offset_component(p.z, n.z))


def _rays(origins: Vec3, directions: Vec3, tmax, active):
    """Contiguous ray components; inactive lanes get tmax = 0 (never hit)."""
    if active is not None:
        tmax = torch.where(active, tmax, 0.0)
    o = tuple(c.contiguous() for c in origins)
    d = tuple(c.contiguous() for c in directions)
    return o, d, tmax.contiguous()


def _tri_bounds(scene):
    """A flat scene's group boxes (DeviceScene.tri_bounds), which K2/K3 cull by."""
    return getattr(scene, "tri_bounds", None)


def intersect_closest(scene, origins: Vec3, directions: Vec3, tmin, tmax, ray_mask: int,
                      active=None, exclude=None) -> Hit:
    """Closest hit against the scene's triangles (kernel K5 or K2 on the card).

    exclude: [N] int32 primitive each ray originated from (-1 = none); it is
    rejected by id (self-intersection guard on top of offset_ray)."""
    o, d, tmax = _rays(origins, directions, tmax, active)
    ex = exclude.contiguous() if exclude is not None else None
    tris = (scene.v0, scene.e1, scene.e2, scene.geom_mask)
    bvh = getattr(scene, "bvh", None)
    if bvh is not None:
        return Hit(*KB.bvh_closest(o, d, tmin.contiguous(), tmax, ex, bvh, *tris, ray_mask))
    return Hit(*KI.intersect_closest(o, d, tmin.contiguous(), tmax, ex, *tris, ray_mask, bounds=_tri_bounds(scene)))


def intersect_any(scene, origins: Vec3, directions: Vec3, tmin, tmax, ray_mask: int,
                  active=None, exclude=None) -> torch.Tensor:
    """Occlusion -> [N] bool (kernel K6 or K3 on the card)."""
    o, d, tmax = _rays(origins, directions, tmax, active)
    ex = exclude.contiguous() if exclude is not None else None
    tris = (scene.v0, scene.e1, scene.e2, scene.geom_mask)
    bvh = getattr(scene, "bvh", None)
    if bvh is not None:
        return KB.bvh_any(o, d, tmin.contiguous(), tmax, ex, bvh, *tris, ray_mask)
    return KI.intersect_any(o, d, tmin.contiguous(), tmax, ex, *tris, ray_mask, bounds=_tri_bounds(scene))


def intersect_curves_closest(scene, origins: Vec3, directions: Vec3, tmin, tmax, active=None) -> CurveHit:
    """Closest hit against the scene's round cones (kernel K7 on the card)
    -> (t, segment, spline u); u = u0 + (u1 - u0) * y from the winning
    cone's axial position, as the reference's CPU sweep."""
    o, d, tmax = _rays(origins, directions, tmax, active)
    tmin, cones = tmin.contiguous(), scene.packed_cones
    t, cone, y = KC.cone_closest(o, d, tmin, tmax, cones)
    return cone_hit(scene.cone_attr, t, cone, y)


def intersect_curves_any(scene, origins: Vec3, directions: Vec3, tmin, tmax, active=None) -> torch.Tensor:
    """Occlusion by the scene's round cones -> [N] bool (kernel K8 on the card)."""
    o, d, tmax = _rays(origins, directions, tmax, active)
    tmin, cones = tmin.contiguous(), scene.packed_cones
    return KC.cone_any(o, d, tmin, tmax, cones)
