"""Ray-scene intersection + the exact ray-origin offset, for the reference.

Frozen from the port's ops/intersect.py with its dispatch replaced: every
sweep gives the plain dense one's answer over all of the scene's triangles
or cones, on any device: the triangles of the 32-triangle groups whose box
(padded) a ray's interval enters (kernels/intersect.py:culled_plain, held
equal to closest_plain and any_plain ray for ray), the cones of the
sub-blocks it enters (kernels/cones.py). The reference's scenes are flat
(render/device_scene.py builds no BVH), so its prim ids are in the scene's
own triangle order. Also hosts offset_ray, the exact
port of the Ray Tracing Gems self-intersection offset
(OptixRender_radiance_closest_hit.cu:218-233).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refport.kernels import cones as KC
from refport.kernels import intersect as KI
from refport.ops.curves import CurveHit, cone_hit
from refport.ops.vec import Vec3


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


def intersect_closest(scene, origins: Vec3, directions: Vec3, tmin, tmax, ray_mask: int,
                      active=None, exclude=None) -> Hit:
    """Closest hit against every triangle of the scene (the dense sweep's answer).

    exclude: [N] int32 primitive each ray originated from (-1 = none); it is
    rejected by id (self-intersection guard on top of offset_ray)."""
    o, d, tmax = _rays(origins, directions, tmax, active)
    ex = exclude.contiguous() if exclude is not None else None
    return Hit(*KI.intersect_closest(o, d, tmin.contiguous(), tmax, ex, scene.v0, scene.e1, scene.e2,
                                     scene.geom_mask, ray_mask, bounds=scene.tri_bounds))


def intersect_any(scene, origins: Vec3, directions: Vec3, tmin, tmax, ray_mask: int,
                  active=None, exclude=None) -> torch.Tensor:
    """Occlusion by any triangle of the scene -> [N] bool (the dense sweep's answer)."""
    o, d, tmax = _rays(origins, directions, tmax, active)
    ex = exclude.contiguous() if exclude is not None else None
    return KI.intersect_any(o, d, tmin.contiguous(), tmax, ex, scene.v0, scene.e1, scene.e2, scene.geom_mask,
                            ray_mask, bounds=scene.tri_bounds)


def intersect_curves_closest(scene, origins: Vec3, directions: Vec3, tmin, tmax, active=None) -> CurveHit:
    """Closest hit against the scene's round cones -> (t, segment, spline u);
    u = u0 + (u1 - u0) * y from the winning cone's axial position."""
    o, d, tmax = _rays(origins, directions, tmax, active)
    t, cone, y = KC.cone_closest(o, d, tmin.contiguous(), tmax, scene.packed_cones)
    return cone_hit(scene.cone_attr, t, cone, y)


def intersect_curves_any(scene, origins: Vec3, directions: Vec3, tmin, tmax, active=None) -> torch.Tensor:
    """Occlusion by the scene's round cones -> [N] bool."""
    o, d, tmax = _rays(origins, directions, tmax, active)
    return KC.cone_any(o, d, tmin.contiguous(), tmax, scene.packed_cones)
