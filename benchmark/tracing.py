"""Reduction of a torch.profiler trace to the numbers the per-layer metrics read.

The kernel-name map and the busy-time arithmetic are copied from the
program's profiling script (scripts/torch_profile_cornell.py, chip_smoke.py:
device_busy) so that a later change there does not move them.
"""

from __future__ import annotations

import re

# the hand-written kernels by the names their CUDA symbols contain
KERNELS = {
    "random_dims_kernel": "sobol",
    "tri_warp_kernel<false": "intersect_closest",
    "tri_warp_kernelILb0E": "intersect_closest",
    "tri_warp_kernel<true": "intersect_any",
    "tri_warp_kernelILb1E": "intersect_any",
    "tri_thread_kernel<false": "intersect_closest",
    "tri_thread_kernelILb0E": "intersect_closest",
    "tri_thread_kernel<true": "intersect_any",
    "tri_thread_kernelILb1E": "intersect_any",
    "gather_rows_t_kernel": "gather_rows_t",
    "bvh_closest_kernel": "bvh_closest",
    "bvh_any_kernel": "bvh_any",
    "cone_kernel<false": "cone_closest",
    "cone_kernelILb0E": "cone_closest",
    "cone_kernel<true": "cone_any",
    "cone_kernelILb1E": "cone_any",
    "open_w_kernel": "open_w",
}
TOP = 10  # entries of each breakdown list
HOST_RANGE = "bench."  # the prefix of the benchmark's own host ranges, which name the idle gaps


GENERIC = {"vectorized_elementwise_kernel", "elementwise_kernel", "unrolled_elementwise_kernel", "gpu_kernel_impl",
           "gpu_kernel_impl_nocast", "reduce_kernel", "index_elementwise_kernel"}
NAME_PART = re.compile(r"[A-Za-z_]\w*(?:Functor|_impl|_kernel|_scalar|_op)\b")


def short_name(name: str) -> str:
    """A device event's name for the breakdown: a hand-written kernel's family,
    else the distinct operation words of the PyTorch kernel's symbol."""
    fam = kernel_family(name)
    if fam:
        return fam
    parts = []
    for part in NAME_PART.findall(name):
        if part not in GENERIC and part not in parts:
            parts.append(part)
    if not parts:
        parts = [name.split("<")[0].split("(")[0].replace("void ", "").strip()]
    return "/".join(parts)[:96]


def kernel_family(name: str):
    """The hand-written kernel a device event belongs to, or None."""
    return next((v for k, v in KERNELS.items() if k in name), None)


def is_kernel(name: str) -> bool:
    """A device event that is a kernel, not a copy or a fill."""
    return not (name.startswith("Memcpy") or name.startswith("Memset") or name.startswith("[memory]"))


def device_busy(spans):
    """(busy us, window us) of device events' (start, end) spans in us:
    the length of their union, and first start to last end."""
    if not spans:
        return 0.0, 0.0
    spans = sorted(spans)
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return busy, max(e for _, e in spans) - spans[0][0]


def idle_gaps(spans, host_ranges):
    """The gaps between device events, longest first, each named by the
    benchmark's host range that holds its midpoint ("host" where none):
    [(name, seconds)]."""
    spans = sorted(spans)
    gaps, end = [], None
    for s, e in spans:
        if end is not None and s > end:
            mid = (s + end) / 2
            name = next((n for n, a, b in host_ranges if a <= mid <= b), "host")
            gaps.append((name, (s - end) / 1e6))
        end = e if end is None else max(end, e)
    gaps.sort(key=lambda g: -g[1])
    return gaps


def _device_time_us(ev) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        value = getattr(ev, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def reduce_events(events, launches: int, range_names=()) -> dict:
    """A profiler's events over `launches` launches -> per launch: device
    ms of the kernels (the union of their spans) and of each hand-written
    family (the sum of its kernels' spans), kernels, the
    device's busy and window seconds, and the device ms of the kernels that
    the CPU ranges `range_names` launched; with the breakdown lists."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    spans, kernel_spans, families, by_name, host_ranges = [], [], {}, {}, []
    ranges = {name: 0.0 for name in range_names}
    for ev in events:
        annotation = ev.name in ranges or ev.name.startswith(HOST_RANGE)
        if ev.device_type != cuda:
            if ev.name in ranges:
                ranges[ev.name] += _device_time_us(ev)
            if ev.name.startswith(HOST_RANGE):
                host_ranges.append((ev.name[len(HOST_RANGE):], ev.time_range.start, ev.time_range.end))
            continue
        if annotation:  # a host range's shadow on the device's timeline, not device work
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        dur = end - start
        short = short_name(ev.name)
        by_name[short] = by_name.get(short, 0.0) + dur
        if is_kernel(ev.name):
            kernel_spans.append((start, end))
            fam = kernel_family(ev.name)
            if fam:
                families[fam] = families.get(fam, 0.0) + dur
    busy_us, window_us = device_busy(spans)
    kernel_busy_us, _ = device_busy(kernel_spans)
    n = max(launches, 1)
    return {
        "kernels_per_launch": len(kernel_spans) / n,
        # the union of the kernels' spans: back-to-back graph kernels' reported spans overlap
        "kernel_ms_per_launch": kernel_busy_us / n / 1e3,
        "family_ms_per_launch": {k: v / n / 1e3 for k, v in families.items()},
        "range_ms_per_launch": {k: v / n / 1e3 for k, v in ranges.items()},
        "busy_s": busy_us / 1e6,
        "window_s": window_us / 1e6,
        "device_ops": sorted(((k, v / 1e6) for k, v in by_name.items()), key=lambda kv: -kv[1])[:TOP],
        "idle_gaps": idle_gaps(spans, host_ranges)[:TOP],
    }
