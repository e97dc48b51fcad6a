"""Multi-device execution: the frame's pixel rows in bands, one a device.

The PyTorch counterpart of strelka_tpu/parallel/sharding.py. The reference
has no multi-GPU path (SURVEY.md §2.4); this is the scaling axis of the JAX
package: each device runs the whole wavefront loop on its own horizontal
band, with the band's global row offset feeding the camera NDC and the Sobol
seed, so the bands of a frame equal the one-device render bit for bit.

Each device keeps its own copy of the device scene and its band's
accumulators between launches; a launch moves no band tensor between
devices, and only the finished image is gathered, onto the first device.
A device list may name one device more than once: its bands then run one
after another on it (how the tests and chip_smoke.py run several bands on
one card or on the CPU). On a card each band's launch may be a CUDA graph
of its own (`graph_launch`, render/render.py:GraphLaunch), as the reference
jits its shard_map once per config key.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, List, NamedTuple, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from strelka_tpu_torch.ops.integrator import FrameState, make_frame_state
from strelka_tpu_torch.utils.device import resolve_device


def make_render_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """The devices to band a frame over: every CUDA card when None (raises
    without one), else the given list, repeats kept."""
    if devices is None:
        resolve_device(None)
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    out = [torch.device(d) for d in devices]
    # "cuda" names the current card, as a tensor placed there reports it
    return [torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d
            for d in out]


class BandState(NamedTuple):
    """A frame's accumulators as one band-local FrameState a device, top band first."""

    bands: tuple


def make_band_state(height: int, width: int, devices: Sequence[torch.device]) -> BandState:
    h = band_height(height, len(devices))
    return BandState(tuple(make_frame_state(h, width, d) for d in devices))


def split_state(state: FrameState, devices: Sequence[torch.device]) -> BandState:
    """A whole frame's FrameState cut into bands, each moved to its device."""
    h = band_height(state.accum.shape[1], len(devices))
    bands = []
    for i, d in enumerate(devices):
        rows = slice(i * h, (i + 1) * h)
        bands.append(FrameState(*(t[..., rows, :].to(d, copy=True) for t in state)))
    return BandState(tuple(bands))


def gather_state(state: BandState, device) -> FrameState:
    """The bands joined into one FrameState on `device` (checkpoints, and
    the image of a frame whose sample budget is spent)."""
    return FrameState(*(torch.cat([t.to(device) for t in field], dim=-2) for field in zip(*state.bands)))


def band_height(height: int, bands: int) -> int:
    if height % bands != 0:
        raise ValueError(f"height {height} not divisible by {bands} shards")
    return height // bands


def scene_to(obj, device: torch.device):
    """A copy of a device scene (or any of its parts) with every tensor on `device`."""
    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: scene_to(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj) if f.init})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(scene_to(v, device) for v in obj))
    return obj


class DeviceCrossings(TorchDispatchMode):
    """Records each PyTorch op that reads a tensor of at least `min_numel`
    values on one device and writes its result on another: a band tensor
    changing device. Kernels launched through ctypes are not PyTorch ops and
    read only the pointers they are given, which their wrappers check."""

    def __init__(self, min_numel: int):
        super().__init__()
        self.min_numel = min_numel
        self.found: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        out_devs = {t.device for t in tree_leaves(out) if isinstance(t, torch.Tensor)}
        for t in tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and t.numel() >= self.min_numel and out_devs - {t.device}:
                self.found.append((str(func), str(t.device), sorted(str(d) for d in out_devs), tuple(t.shape)))
        return out


def shard_launch(make_launch: Callable, devices: Sequence, check_devices: bool = False,
                 copies: Optional[dict] = None, graph_launch: Optional[Callable] = None):
    """Band a render launch over pixel rows.

    make_launch(local_height, full_height) must return a function
    launch(scene, params, state, py_offset) -> (state, image) that renders the
    [local_height, W] band whose top row is global row py_offset; state is
    band-local ([3, local_h, W] planar images, [local_h, W] counters) and the
    image is [local_h, W, 4].

    Returns wrapper(scene, params, state: BandState) -> (BandState, image
    [H, W, 4] on the first device). With check_devices, each band's eager
    launch runs under DeviceCrossings (at one value a pixel of the band) and
    raises if a band tensor changed device; wrapper.crossings holds what it
    saw. `copies` (device -> (scene, its copy there)) may be shared by
    several wrappers of one scene. graph_launch(band_launch, device), where
    given, wraps each band on a CUDA device (band_launch(scene, params,
    state), its py_offset bound) in a replayable launch that updates the
    band's state in place (GraphLaunch); bands elsewhere stay eager.
    wrapper.reset(pool) resets those (a rebuilt scene, a new state)."""
    devices = make_render_mesh(devices)
    copies = {} if copies is None else copies
    bands: dict = {}  # local height -> one launch a band

    def scene_on(scene, device):
        if scene.device == device:
            return scene
        held = copies.get(device)
        if held is None or held[0] is not scene:  # first launch, or the scene was rebuilt
            held = copies[device] = (scene, scene_to(scene, device))
        return held[1]

    def band_launches(local_h):
        if local_h not in bands:
            launch = make_launch(local_h, local_h * len(devices))
            fns = []
            for i, d in enumerate(devices):
                fn = functools.partial(launch, py_offset=i * local_h)
                fns.append(graph_launch(fn, d) if graph_launch is not None and d.type == "cuda" else fn)
            bands[local_h] = fns
        return bands[local_h]

    def wrapper(scene, params, state: BandState):
        if len(state.bands) != len(devices):
            raise ValueError(f"{len(state.bands)} bands for {len(devices)} devices")
        local_h, width = state.bands[0].accum.shape[1:]
        new_bands, images = [], []
        wrapper.crossings = []
        for d, band, fn in zip(devices, state.bands, band_launches(local_h)):
            band_scene = scene_on(scene, d)
            eager = getattr(fn, "bound", None) is None  # a plain launch, or a graph's first (eager) call
            with torch.cuda.device(d) if d.type == "cuda" else contextlib.nullcontext():
                if check_devices and eager:
                    with DeviceCrossings(local_h * width) as mode:
                        new_band, image = fn(band_scene, params, band)
                    wrapper.crossings += mode.found
                else:
                    new_band, image = fn(band_scene, params, band)
            new_bands.append(new_band)
            images.append(image)
        if wrapper.crossings:
            raise RuntimeError(f"band tensors changed device inside a launch: {wrapper.crossings[:4]}")
        return BandState(tuple(new_bands)), torch.cat([im.to(devices[0]) for im in images], dim=0)

    def reset(pool) -> None:
        for fns in bands.values():
            for fn in fns:
                if hasattr(fn, "reset"):
                    fn.reset(pool)

    wrapper.devices = devices
    wrapper.crossings = []
    wrapper.bands = bands
    wrapper.band_launches = band_launches
    wrapper.reset = reset
    return wrapper
