"""Component-major 3-vectors (structure-of-arrays) as torch tensors.

The PyTorch counterpart of strelka_tpu/ops/vec.py. Vec3 is a
NamedTuple(x, y, z) of same-shaped [N] tensors with the usual algebra; the
integrator, BSDFs and light sampling all speak it. The component-major
layout is kept from the JAX package so that the two can be compared term by
term, and so that each component is one coalesced [N] row on the card.

`gather_rows_t(table, idx)` is the fat row gather of the shade epilogue; it
runs the row-gather kernel (kernels/gather.py) on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from refport.kernels import gather as _gather


class Vec3(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- algebra --
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return Vec3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)


def full(n: int, v: float, device) -> Vec3:
    return Vec3(*(torch.full((n,), v, dtype=torch.float32, device=device) for _ in range(3)))


def splat(c, n: int, device) -> Vec3:
    """Vec3 from a length-3 python constant, broadcast to [n]."""
    return Vec3(*(torch.full((n,), float(c[i]), dtype=torch.float32, device=device) for i in range(3)))


def gather_rows_t(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows of a [T, F] f32 table, transposed -> [F, N] (kernel K4).

    Indices are clipped to [0, T-1], as the Pallas one-hot gather does;
    the integrator clamps them before the call in any case."""
    return _gather.gather_rows_t(table, idx)


def fma(a, b, c) -> torch.Tensor:
    """f32 a * b + c rounded once, as a fused multiply-add. The f32 product
    is exact in f64; the f64 sum is rounded to odd (TwoSum's error nudges an
    even sum one ulp towards the exact value), and the f32 rounding of a
    round-to-odd value with 29 more bits is that of the exact sum. No
    branch on the data: it runs inside a captured launch. a, b, c: f32
    tensors (or Python floats) of broadcastable shapes."""
    dev = next(x.device for x in (a, b, c) if isinstance(x, torch.Tensor))
    a, b, c = (torch.as_tensor(x, dtype=torch.float32, device=dev).double() for x in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.copysign(torch.full_like(s, float("inf")), err)
    return torch.where((err != 0.0) & even, torch.nextafter(s, toward), s).to(torch.float32)


def dot_fma(x, y) -> torch.Tensor:
    """x0*y0 + x1*y1 + x2*y2 (sequences of three tensors) as XLA's CPU
    backend contracts the sum: fma(x2, y2, fma(x0, y0, x1*y1))."""
    return fma(x[2], y[2], fma(x[0], y[0], x[1] * y[1]))


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length(a: Vec3):
    return torch.sqrt(dot(a, a))


def normalize(a: Vec3, eps: float = 1e-20) -> Vec3:
    inv = 1.0 / torch.clamp(length(a), min=eps)
    return a * inv


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    """Select with a mask of the components' shape."""
    return Vec3(torch.where(mask, a.x, b.x), torch.where(mask, a.y, b.y), torch.where(mask, a.z, b.z))


def vmax(a: Vec3):
    return torch.maximum(a.x, torch.maximum(a.y, a.z))


def any_nan(a: Vec3):
    return torch.isnan(a.x) | torch.isnan(a.y) | torch.isnan(a.z)


def all_nonzero(a: Vec3):
    return (a.x != 0.0) & (a.y != 0.0) & (a.z != 0.0)


def any_nonzero(a: Vec3):
    return (a.x != 0.0) | (a.y != 0.0) | (a.z != 0.0)


def octant(d: Vec3) -> torch.Tensor:
    """Direction octant id [0, 8) as int32: bit c set iff component c is
    positive (ops/vec.py:octant of the JAX package; the low 3 bits of the
    wavefront sort key)."""
    return ((d.x > 0).to(torch.int32) | ((d.y > 0).to(torch.int32) << 1)
            | ((d.z > 0).to(torch.int32) << 2))


def luminance(a: Vec3):
    """Rec601 luma (Tonemappers.cu:6-9 weights)."""
    return 0.299 * a.x + 0.587 * a.y + 0.114 * a.z


def matvec(m, v: Vec3) -> Vec3:
    """Row-major 4x4 matrix applied to the direction (v, 0): m[:3, :3] @ v.

    m: the matrix rows as Python floats (f32 values, read on the host)."""
    return Vec3(*(m[i][0] * v.x + m[i][1] * v.y + m[i][2] * v.z + 0.0 for i in range(3)))
