"""Kernel K1: the folded Owen-scrambled Sobol draw of one bounce.

Replaces the Pallas kernel `strelka_tpu/ops/sampler.py:random_dims_pallas`.
`random_dims(sample_idx, depth, dims)` -> [D, N] f32, bit-equal to the JAX
`random_dims`. The CUDA source is csrc/sobol.cu (one kernel instance per
set of dimensions drawn, the direction numbers compiled in); the plain
version below is the same bit math on int64 tensors that carry u32 values.
"""

from __future__ import annotations


import numpy as np
import torch

from refport import kernels as K

M32 = 0xFFFFFFFF
FLOAT_ONE_MINUS_EPS = float(np.float32(1.0 - 2.0 ** -24))  # 0x1.fffffep-1
SAMPLER_BASE_SEED = 52  # OptixRender.cu:101

# Sobol direction-number matrices for 5 dimensions (RandomSampler.h:139-164).
SB_MATRIX = np.array(
    [
        [
            0x80000000, 0x40000000, 0x20000000, 0x10000000, 0x08000000, 0x04000000, 0x02000000, 0x01000000,
            0x00800000, 0x00400000, 0x00200000, 0x00100000, 0x00080000, 0x00040000, 0x00020000, 0x00010000,
            0x00008000, 0x00004000, 0x00002000, 0x00001000, 0x00000800, 0x00000400, 0x00000200, 0x00000100,
            0x00000080, 0x00000040, 0x00000020, 0x00000010, 0x00000008, 0x00000004, 0x00000002, 0x00000001,
        ],
        [
            0x80000000, 0xC0000000, 0xA0000000, 0xF0000000, 0x88000000, 0xCC000000, 0xAA000000, 0xFF000000,
            0x80800000, 0xC0C00000, 0xA0A00000, 0xF0F00000, 0x88880000, 0xCCCC0000, 0xAAAA0000, 0xFFFF0000,
            0x80008000, 0xC000C000, 0xA000A000, 0xF000F000, 0x88008800, 0xCC00CC00, 0xAA00AA00, 0xFF00FF00,
            0x80808080, 0xC0C0C0C0, 0xA0A0A0A0, 0xF0F0F0F0, 0x88888888, 0xCCCCCCCC, 0xAAAAAAAA, 0xFFFFFFFF,
        ],
        [
            0x80000000, 0xC0000000, 0x60000000, 0x90000000, 0xE8000000, 0x5C000000, 0x8E000000, 0xC5000000,
            0x68800000, 0x9CC00000, 0xEE600000, 0x55900000, 0x80680000, 0xC09C0000, 0x60EE0000, 0x90550000,
            0xE8808000, 0x5CC0C000, 0x8E606000, 0xC5909000, 0x6868E800, 0x9C9C5C00, 0xEEEE8E00, 0x5555C500,
            0x8000E880, 0xC0005CC0, 0x60008E60, 0x9000C590, 0xE8006868, 0x5C009C9C, 0x8E00EEEE, 0xC5005555,
        ],
        [
            0x80000000, 0xC0000000, 0x20000000, 0x50000000, 0xF8000000, 0x74000000, 0xA2000000, 0x93000000,
            0xD8800000, 0x25400000, 0x59E00000, 0xE6D00000, 0x78080000, 0xB40C0000, 0x82020000, 0xC3050000,
            0x208F8000, 0x51474000, 0xFBEA2000, 0x75D93000, 0xA0858800, 0x914E5400, 0xDBE79E00, 0x25DB6D00,
            0x58800080, 0xE54000C0, 0x79E00020, 0xB6D00050, 0x800800F8, 0xC00C0074, 0x200200A2, 0x50050093,
        ],
        [
            0x80000000, 0x40000000, 0x20000000, 0xB0000000, 0xF8000000, 0xDC000000, 0x7A000000, 0x9D000000,
            0x5A800000, 0x2FC00000, 0xA1600000, 0xF0B00000, 0xDA880000, 0x6FC40000, 0x81620000, 0x40BB0000,
            0x22878000, 0xB3C9C000, 0xFB65A000, 0xDDB2D000, 0x78022800, 0x9C0B3C00, 0x5A0FB600, 0x2D0DDB00,
            0xA2878080, 0xF3C9C040, 0xDB65A020, 0x6DB2D0B0, 0x800228F8, 0x400B3CDC, 0x200FB67A, 0xB00DDB9D,
        ],
    ],
    dtype=np.int64,
)


# --- u32 arithmetic on int64 tensors or Python ints (values in [0, 2^32)) ---
# The same helpers serve the per-lane tensors and the per-launch scalar seeds.


def u32(x):
    """int tensor -> int64 tensor of its low 32 bits; Python int -> int."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & M32
    return int(x) & M32


def mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32) and a constant c, without leaving
    int64: the product is formed from c's 16-bit halves."""
    c = int(c) & M32
    lo = x * (c & 0xFFFF)  # < 2^48
    hi = ((x * (c >> 16)) & 0xFFFF) << 16  # < 2^32
    return (lo + hi) & M32


def hash_u32(x):
    """murmurhash3 finalizer (RandomSampler.h:86-95)."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def hash_combine(seed, v):
    """RandomSampler.h:50-53."""
    seed = u32(seed)
    return seed ^ ((u32(v) + (seed << 6) + (seed >> 2)) & M32)


def reverse_bits(v):
    """RandomSampler.h:192-203 (portable branch)."""
    v = u32(v)
    v = ((v & 0xAAAAAAAA) >> 1) | ((v & 0x55555555) << 1)
    v = ((v & 0xCCCCCCCC) >> 2) | ((v & 0x33333333) << 2)
    v = ((v & 0xF0F0F0F0) >> 4) | ((v & 0x0F0F0F0F) << 4)
    v = ((v & 0xFF00FF00) >> 8) | ((v & 0x00FF00FF) << 8)
    return ((v >> 16) | (v << 16)) & M32


def laine_karras_permutation(value, seed):
    """RandomSampler.h:182-190."""
    value = (u32(value) + u32(seed)) & M32
    for c in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        value = value ^ mul32(value, c)
    return value


def nested_uniform_scramble(value, seed):
    """RandomSampler.h:205-211."""
    return reverse_bits(laine_karras_permutation(reverse_bits(value), seed))


def scramble_seed(depth: int) -> int:
    """hash_u32(52 + depth): the per-bounce scramble seed."""
    return hash_u32(SAMPLER_BASE_SEED + int(depth))


# --- K1 --------------------------------------------------------------------


def random_dims_plain(sample_idx: torch.Tensor, depth: int, dims: tuple) -> torch.Tensor:
    """Plain PyTorch K1: [N] int64 sample indices -> [D, N] f32."""
    K.note_plain("sobol", sample_idx.device)
    dev = sample_idx.device
    seed = scramble_seed(depth)
    index = nested_uniform_scramble(sample_idx, seed)
    cols = torch.tensor(SB_MATRIX[list(dims)], dtype=torch.int64, device=dev)  # [D, 32]
    x = torch.zeros((len(dims),) + tuple(index.shape), dtype=torch.int64, device=dev)
    for bit in range(32):
        mask = -((index >> bit) & 1)  # 0 or all ones
        x = x ^ (mask[None, :] & cols[:, bit : bit + 1])
    seeds2 = torch.tensor([hash_combine(seed, d) for d in dims], dtype=torch.int64, device=dev)
    result = nested_uniform_scramble(x, seeds2[:, None])
    return torch.clamp(result.to(torch.float32) * (2.0 ** -32), max=FLOAT_ONE_MINUS_EPS)


def random_dims(sample_idx: torch.Tensor, depth: int, dims: tuple) -> torch.Tensor:
    """K1's function: the plain version on any device."""
    return random_dims_plain(sample_idx, depth, dims)
