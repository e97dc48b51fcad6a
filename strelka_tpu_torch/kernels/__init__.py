"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

One module per kernel family (sobol, intersect, bvh, gather, cones, open_w). Each wrapper sends a CPU
tensor to the plain version and a CUDA tensor to its kernel; there is no
fallback from one to the other. Sources are in ../csrc, built by build.py.

`launch_counts` counts kernel launches by name: a wrapper adds one where it
launches its kernel (`count_launch`), and nowhere else. `launch_shapes`
counts the same launches by (name, shape), the shape being the sizes that
define the launch (lanes, triangles, table rows, ...), so a caller can see
at which shapes a path ran a kernel. `plain_cuda_calls` counts calls of a
plain version on CUDA tensors, which only a comparison against the kernel
makes (the main path never does). All are reset with `reset_counts()`.
"""

from __future__ import annotations

KERNEL_NAMES = ("sobol", "intersect_closest", "intersect_any", "gather_rows_t", "bvh_closest", "bvh_any",
                "cone_closest", "cone_any", "open_w")

launch_counts = {name: 0 for name in KERNEL_NAMES}
launch_shapes: dict = {}  # (name, shape tuple) -> launches
plain_cuda_calls = {name: 0 for name in KERNEL_NAMES}


def count_launch(name: str, shape: tuple) -> None:
    """One kernel launch: called by a wrapper right after it launched."""
    launch_counts[name] += 1
    key = (name, tuple(int(s) for s in shape))
    launch_shapes[key] = launch_shapes.get(key, 0) + 1


def reset_counts() -> None:
    for d in (launch_counts, plain_cuda_calls):
        for k in d:
            d[k] = 0
    launch_shapes.clear()


def note_plain(name: str, device) -> None:
    if device.type == "cuda":
        plain_cuda_calls[name] += 1


def require_cuda(t, name: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(f"{name}: tensor on {t.device}; the kernel takes CUDA tensors and "
                           "the plain version CPU tensors")
