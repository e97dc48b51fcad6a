"""The plain PyTorch versions of the port's kernels, one module per family
(sobol, intersect, gather, cones). `plain_cuda_calls` counts the calls of a
plain version on CUDA tensors.
"""

from __future__ import annotations

KERNEL_NAMES = ("sobol", "intersect_closest", "intersect_any", "gather_rows_t", "cone_closest", "cone_any")

plain_cuda_calls = {name: 0 for name in KERNEL_NAMES}


def note_plain(name: str, device) -> None:
    if device.type == "cuda":
        plain_cuda_calls[name] += 1
