"""Ray-scene intersection for flat scenes + the exact ray-origin offset.

The PyTorch counterpart of strelka_tpu/ops/intersect.py, flat path only:
`intersect_closest` runs kernel K2 and `intersect_any` kernel K3 on CUDA
tensors, their plain versions (the brute-force sweeps of the JAX CPU path)
on CPU tensors. Rays are component-major Vec3 (ops/vec.py).

Also hosts offset_ray, the exact port of the Ray Tracing Gems self-
intersection offset (OptixRender_radiance_closest_hit.cu:218-233).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from strelka_tpu_torch.kernels import intersect as KI
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


def intersect_closest(scene, origins: Vec3, directions: Vec3, tmin, tmax, ray_mask: int,
                      active=None, exclude=None) -> Hit:
    """Closest hit against the scene's triangles (kernel K2 on the card).

    exclude: [N] int32 primitive each ray originated from (-1 = none); it is
    rejected by id (self-intersection guard on top of offset_ray)."""
    o, d, tmax = _rays(origins, directions, tmax, active)
    ex = exclude.contiguous() if exclude is not None else None
    t, prim, u, v = KI.intersect_closest(
        o, d, tmin.contiguous(), tmax, ex, scene.v0, scene.e1, scene.e2, scene.geom_mask, ray_mask
    )
    return Hit(t=t, prim=prim, u=u, v=v)


def intersect_any(scene, origins: Vec3, directions: Vec3, tmin, tmax, ray_mask: int,
                  active=None, exclude=None) -> torch.Tensor:
    """Occlusion -> [N] bool (kernel K3 on the card)."""
    o, d, tmax = _rays(origins, directions, tmax, active)
    ex = exclude.contiguous() if exclude is not None else None
    return KI.intersect_any(
        o, d, tmin.contiguous(), tmax, ex, scene.v0, scene.e1, scene.e2, scene.geom_mask, ray_mask
    )
