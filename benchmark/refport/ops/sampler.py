"""Owen-scrambled Sobol sampler — the PyTorch port of strelka_tpu/ops/sampler.py.

Reference: src/render/optix/RandomSampler.h. Every path decision is drawn
from a 5-dimensional scrambled Sobol sequence indexed by a Morton-coded
per-pixel sample index:

  sampleIdx = EncodeMorton2(px, py) * maxSampleCount + pixelSampleIndex   (:130-137)
  dimension = (Dim + depth * NUM_DIMENSIONS) % 5                          (:221-226)
  value     = sobol_scramble(sampleIdx, dimension, seed=52 + depth)       (:213-219)

u32 values ride in int64 tensors masked to 32 bits (torch has no full
uint32 arithmetic on every device). Products are formed from 16-bit halves
so that no intermediate leaves int64. Everything here is bit-equal to the
JAX functions of the same name.

`random_dims` is kernel K1 on the card (kernels/sobol.py); the plain
version lives there too.
"""

from __future__ import annotations

from enum import IntEnum

import torch

from refport.kernels import sobol as _sobol
from refport.kernels.sobol import (  # noqa: F401 — public names
    FLOAT_ONE_MINUS_EPS,
    M32,
    SAMPLER_BASE_SEED,
    hash_combine,
    hash_u32,
    mul32,
    nested_uniform_scramble,
    reverse_bits,
    u32,
)


class SampleDimension(IntEnum):
    """RandomSampler.h:13-26."""

    ePixelX = 0
    ePixelY = 1
    eLightId = 2
    eLightPointX = 3
    eLightPointY = 4
    eBSDF0 = 5
    eBSDF1 = 6
    eBSDF2 = 7
    eBSDF3 = 8
    eRussianRoulette = 9
    eNUM_DIMENSIONS = 10


def part1by1(x: torch.Tensor) -> torch.Tensor:
    """Insert a 0 bit after each of the 16 low bits (RandomSampler.h:115-123)."""
    x = u32(x) & 0x0000FFFF
    x = (x ^ (x << 8)) & 0x00FF00FF
    x = (x ^ (x << 4)) & 0x0F0F0F0F
    x = (x ^ (x << 2)) & 0x33333333
    x = (x ^ (x << 1)) & 0x55555555
    return x


def encode_morton2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """RandomSampler.h:125-128."""
    return ((part1by1(y) << 1) + part1by1(x)) & M32


def make_sample_index(pixel_x, pixel_y, sample_index, max_sample_count: int) -> torch.Tensor:
    """sampleIdx of initSampler (RandomSampler.h:130-137) -> int64 [N] in [0, 2^32)."""
    return (mul32(encode_morton2(pixel_x, pixel_y), int(max_sample_count) & M32) + sample_index) & M32


def random_dims(sample_idx: torch.Tensor, depth: int, dims) -> torch.Tensor:
    """Batched random<Dim> for several dims at one depth -> [D, N] float32.

    dimension = Dim % 5 (RandomSampler.h:224): eBSDF2 and eLightId share a
    dimension, as in the reference. Kernel K1 on a CUDA tensor, the plain
    version on a CPU tensor."""
    dims = tuple(int(d) % 5 for d in dims)
    return _sobol.random_dims(sample_idx, int(depth), dims)


def pcg_hash(seed: torch.Tensor) -> torch.Tensor:
    """RandomSampler.h:38-43."""
    state = (mul32(u32(seed), 747796405) + 2891336453) & M32
    word = mul32((state >> ((state >> 28) + 4)) ^ state, 277803737)
    return (word >> 22) ^ word


def uniform_hash(sample_idx: torch.Tensor, depth: int) -> torch.Tensor:
    """Independent auxiliary uniform in [0,1) from the sample index.

    Decorrelated from the 5 folded Sobol dimensions (used for effects the
    reference handles out-of-band, e.g. stochastic alpha cutout)."""
    salt = (0x9E3779B9 + 0x85EBCA6B * (depth + 1)) & 0xFFFFFFFF
    bits = pcg_hash(u32(sample_idx) ^ salt)
    return bits.to(torch.float32) * (1.0 / 4294967296.0)
