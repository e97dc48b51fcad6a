"""Kernel K4: row gather with transpose, table[clip(idx)].T -> [F, N].

Replaces `strelka_tpu/ops/pallas_gather.py:pallas_gather_rows_t` (a one-hot
bf16x3 matmul on the TPU); the CUDA source is csrc/gather.cu. Bit-exact:
it copies. Indices are clipped to [0, T-1] as the Pallas kernel clips them.
The kernel takes 16-byte loads where the table's rows are 16-byte aligned
and 16-byte stores where N % 4 == 0, and one word at a time at every other
shape (odd widths, odd N, a view at an unaligned offset).
"""

from __future__ import annotations

import torch

from refport import kernels as K

MAX_COLS = 454  # a block's tile, 128 lanes x F words, within the H100's 227 KB of shared memory a block
# the shapes where the kernel takes its one-word path for the table's rows (odd
# widths, a table at an unaligned offset) or for the output (N % 4 != 0, the
# last block's ragged edge): (width, N, the table's offset in words into its
# buffer: a row-offset view, or a view 4 bytes off 16-byte alignment), each
# held against the plain version over a table of 300 rows
GATHER_EDGES = [(1, 2 ** 20 + 3, 0), (3, 1023, 0), (67, 1, 0), (67, 4099, 0), (24, 2 ** 20 + 3, 0), (3, 4096, 3),
                (68, 4100, 1)]


def gather_rows_t_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    K.note_plain("gather_rows_t", table.device)
    idx = torch.clamp(idx.to(torch.int64), 0, table.shape[0] - 1)
    return table[idx].T.contiguous()


def gather_rows_t(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [T, F] f32, idx [N] int32 -> [F, N] f32: the plain version on any device."""
    return gather_rows_t_plain(table, idx)
