"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

One module per kernel family (sobol, intersect, bvh, gather, cones, open_w,
surface, shade, nee). Each wrapper sends a CPU tensor to the plain version
and a CUDA tensor to its kernel; there is no fallback from one to the other.
The lane kernels' wrappers (surface, shade, nee) check their inputs and
launch through lanes.py. Sources are in ../csrc, built by build.py.

`launch_counts` counts kernel launches by name: a wrapper adds one where it
launches its kernel (`count_launch`), and nowhere else. `launch_shapes`
counts the same launches by (name, shape), the shape being the sizes that
define the launch (lanes, triangles, table rows, ...), so a caller can see
at which shapes a path ran a kernel. `plain_cuda_calls` counts calls of a
plain version on CUDA tensors, which only a comparison against the kernel
makes (the main path never does). All are reset with `reset_counts()`.

A CUDA graph replays its kernels without the wrappers' host code, so a
capture takes what it counted (`take_counts`) and, where `count_replays` is
set, each replay adds it back (`add_counts`): the counts then stay those of
the kernels that ran. A caller that reads the counts after replays sets it
(the CLI for its log line, chip_smoke.py); unset, a replay runs no Python
loop over the counts.
"""

from __future__ import annotations

KERNEL_NAMES = ("sobol", "intersect_closest", "intersect_any", "gather_rows_t", "bvh_closest", "bvh_any",
                "cone_closest", "cone_any", "open_w", "shade_bsdf", "nee_light", "nee_shade", "shade_surface")

launch_counts = {name: 0 for name in KERNEL_NAMES}
count_replays = False  # whether a graph's replay adds its kernels to the counts
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


def take_counts(fn):
    """Run fn() -> (its result, the counts it added), and take those counts
    back out: for a capture, which launches nothing."""
    before = (dict(launch_counts), dict(launch_shapes), dict(plain_cuda_calls))
    out = fn()
    added = tuple({k: v - b.get(k, 0) for k, v in now.items() if v != b.get(k, 0)}
                  for now, b in zip((launch_counts, launch_shapes, plain_cuda_calls), before))
    add_counts(added, -1)
    return out, added


def add_counts(added, times: int = 1) -> None:
    """Add `times` x the counts take_counts returned (a replay adds them once)."""
    for counts, delta in zip((launch_counts, launch_shapes, plain_cuda_calls), added):
        for k, v in delta.items():
            counts[k] = counts.get(k, 0) + times * v
            if counts[k] == 0 and counts is launch_shapes:
                del counts[k]
