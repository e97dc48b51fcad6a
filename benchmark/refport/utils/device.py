"""Device selection for the port's entry points.

Entry points run on the CUDA card unless the caller asks for the CPU: a
default device with no card raises instead of falling back quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> cuda (raises when no card is present); else torch.device(device)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
