"""PNG reading for the textures: 8-bit non-interlaced PNGs decoded with zlib
alone, so that nothing beyond numpy is needed."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (spec section 9) -> [H, W*bpp] uint8."""
    stride = w * bpp
    out = np.zeros((h, stride), np.int32)
    buf = np.frombuffer(data, np.uint8).reshape(h, stride + 1)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(buf[y, 0])
        row = buf[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = row
        elif ftype == 2:
            cur = (row + prev) & 0xFF
        elif ftype in (1, 3, 4):
            # Sub / Average / Paeth depend on the pixel to the left: scalar loop
            cur = np.zeros(stride, np.int32)
            for i in range(stride):
                a = int(cur[i - bpp]) if i >= bpp else 0
                b = int(prev[i])
                c = int(prev[i - bpp]) if i >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) // 2
                else:
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (int(row[i]) + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out.astype(np.uint8)


def _read_png_u8(path: str) -> np.ndarray:
    """8-bit, non-interlaced PNG -> [H, W, C] uint8 (C = 1, 2, 3 or 4)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(blob):
        (length,) = struct.unpack(">I", blob[pos : pos + 4])
        kind = blob[pos + 4 : pos + 8]
        data = blob[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or interlace != 0 or ctype not in _CHANNELS:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey/RGB(A) PNGs are read")
    ch = _CHANNELS[ctype]
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, ch).reshape(h, w, ch)


def read_png(path: str) -> np.ndarray:
    """8-bit, non-interlaced PNG -> [H, W, C] float32 in [0, 1]."""
    px = _read_png_u8(path)
    if px.shape[-1] == 1:
        px = px[..., 0]
    return px.astype(np.float32) / 255.0


def read_png_rgba(path: str) -> np.ndarray:
    """8-bit, non-interlaced PNG -> [H, W, 4] uint8, as PIL's convert("RGBA")
    gives it: grey fills R, G and B, and a missing alpha is 255."""
    px = _read_png_u8(path)
    h, w, ch = px.shape
    out = np.full((h, w, 4), 255, np.uint8)
    out[..., :3] = px[..., :3] if ch >= 3 else px[..., :1]
    if ch in (2, 4):
        out[..., 3] = px[..., -1]
    return out
