"""Buffer abstraction — port of include/render/buffer.h:16-97.

A Buffer wraps a device tensor with a host mirror; map() performs the
device->host copy (the analog of OptixBuffer::map's cudaMemcpy D2H,
src/render/optix/OptixBuffer.cpp:36-42).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from strelka_tpu_torch.utils import profiling as P


class BufferFormat(enum.IntEnum):
    UNSIGNED_BYTE4 = 0
    FLOAT4 = 1
    FLOAT3 = 2


_CHANNELS = {BufferFormat.UNSIGNED_BYTE4: 4, BufferFormat.FLOAT4: 4, BufferFormat.FLOAT3: 3}
_DTYPE = {
    BufferFormat.UNSIGNED_BYTE4: torch.uint8,
    BufferFormat.FLOAT4: torch.float32,
    BufferFormat.FLOAT3: torch.float32,
}


@dataclass
class BufferDesc:
    width: int = 0
    height: int = 0
    format: BufferFormat = BufferFormat.FLOAT4


@dataclass
class ImageBuffer:
    """Host image view handed to displays/writers (buffer.h:66-97)."""

    data: Optional[np.ndarray] = None
    width: int = 0
    height: int = 0
    pixel_format: BufferFormat = BufferFormat.FLOAT4


class Buffer:
    """Device image buffer with a host mirror."""

    def __init__(self, desc: BufferDesc, device="cpu"):
        self._desc = desc
        self._device_type = torch.device(device)
        self._device = self._zeros()
        self._host: Optional[np.ndarray] = None

    def _zeros(self) -> torch.Tensor:
        ch = _CHANNELS[self._desc.format]
        return torch.zeros((self._desc.height, self._desc.width, ch), dtype=_DTYPE[self._desc.format],
                           device=self._device_type)

    def width(self) -> int:
        return self._desc.width

    def height(self) -> int:
        return self._desc.height

    def format(self) -> BufferFormat:
        return self._desc.format

    def resize(self, width: int, height: int) -> None:
        if (width, height) == (self._desc.width, self._desc.height):
            return
        self._desc.width, self._desc.height = width, height
        self._device = self._zeros()
        self._host = None

    def set_device(self, arr: torch.Tensor) -> None:
        if self._desc.format == BufferFormat.UNSIGNED_BYTE4 and arr.dtype != torch.uint8:
            arr = (torch.clamp(arr, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
        self._device = arr

    def device(self) -> torch.Tensor:
        return self._device

    def map(self) -> np.ndarray:
        """Device -> host copy (waits for the work that produced it); the
        recorder's host span buffer.map."""
        with P.span("buffer.map"):
            self._host = self._device.detach().cpu().numpy()
        return self._host

    def unmap(self) -> None:
        pass  # host mirror stays valid; parity with reference API

    def get_host_pointer(self) -> Optional[np.ndarray]:
        return self._host

    def as_image(self) -> ImageBuffer:
        if self._host is None:
            self.map()
        return ImageBuffer(
            data=self._host,
            width=self._desc.width,
            height=self._desc.height,
            pixel_format=self._desc.format,
        )
