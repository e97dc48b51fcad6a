"""Render checkpoint/resume: persistence for the progressive accumulator.

The PyTorch counterpart of strelka_tpu/render/checkpoint.py. The resume
state is the accumulation buffers + the subframe index
(SharedContext::mSubframeIndex, include/render/common.h:24-25). The file is
the reference's npz with the same key names (state_0..state_4 in FrameState
field order, subframe_index, meta_*), so a checkpoint written by either
package loads in the other through numpy.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from strelka_tpu_torch import log
from strelka_tpu_torch.ops.integrator import FrameState
from strelka_tpu_torch.render.device_scene import frame_state_from_arrays


def save_checkpoint(path: str, state: FrameState, subframe_index: int, meta: Optional[dict] = None) -> None:
    """Persist the accumulation state + spp counter."""
    arrays = {f"state_{i}": x.detach().cpu().numpy() for i, x in enumerate(state[:5])}
    arrays["subframe_index"] = np.asarray(subframe_index, np.int64)
    if meta:
        for k, v in meta.items():
            arrays[f"meta_{k}"] = np.asarray(v)
    tmp = path + ".tmp.npz"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp, path)
    log.info("Checkpoint saved: {} ({} spp)", path, subframe_index)


def load_checkpoint(path: str, device) -> Tuple[FrameState, int]:
    """Restore (FrameState on `device`, subframe_index)."""
    with np.load(path) as data:
        fields = {name: data[f"state_{i}"] for i, name in enumerate(FrameState._fields)}
        subframe = int(data["subframe_index"])
    log.info("Checkpoint loaded: {} ({} spp)", path, subframe)
    return frame_state_from_arrays(fields, torch.device(device)), subframe


def load_meta(path: str) -> dict:
    """The meta_<key> entries of a checkpoint by key: a 0-d entry as its
    Python value (a number, a string), any other as a list."""
    with np.load(path) as data:
        return {k[len("meta_"):]: (data[k].item() if data[k].ndim == 0 else data[k].tolist())
                for k in data.files if k.startswith("meta_")}
