"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

One module per kernel (sobol, intersect, gather). Each wrapper sends a CPU
tensor to the plain version and a CUDA tensor to its kernel; there is no
fallback from one to the other. Sources are in ../csrc, built by build.py.

`launch_counts` counts kernel launches by name: a wrapper adds one where it
launches its kernel, and nowhere else. `plain_cuda_calls` counts calls of a
plain version on CUDA tensors, which only a comparison against the kernel
makes (the main path never does). Both are reset with `reset_counts()`.
"""

from __future__ import annotations

KERNEL_NAMES = ("sobol", "intersect_closest", "intersect_any", "gather_rows_t")

launch_counts = {name: 0 for name in KERNEL_NAMES}
plain_cuda_calls = {name: 0 for name in KERNEL_NAMES}


def reset_counts() -> None:
    for d in (launch_counts, plain_cuda_calls):
        for k in d:
            d[k] = 0


def note_plain(name: str, device) -> None:
    if device.type == "cuda":
        plain_cuda_calls[name] += 1


def require_cuda(t, name: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: tensor on {t.device}; the kernel takes CUDA tensors and "
                           "the plain version CPU tensors")
