"""Image IO + metrics: PNG write (screenshot path parity) and SSIM.

Reference: screenshots via stb/HioImage (hdRunner/main.cpp:407-441). Row 0 of
the framebuffer is pixel y=0 which is the BOTTOM of the view (NDC y=-1), so
PNGs are written flipped to read upright.

The JAX package reads and writes PNGs through PIL. The port codes 8-bit
non-interlaced PNGs with zlib alone, so that nothing beyond numpy and scipy
is needed on a machine that renders with the port.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(img: np.ndarray, flip: bool = True) -> bytes:
    """img: [H,W,3|4] float (0..1) or uint8 -> the bytes of an 8-bit RGB PNG."""
    if img.dtype != np.uint8:
        img = to_uint8(img)
    if flip:
        img = img[::-1]
    rgb = np.ascontiguousarray(img[..., :3])
    h, w = rgb.shape[:2]
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))  # filter 0 rows
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return _PNG_SIG + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _adaptive_rows(rgb: np.ndarray) -> bytes:
    """PNG rows each with the filter PIL's encoder picks (ZipEncode.c without
    `optimize`): of None, Up, Sub and Paeth, tried in that order, the first
    with the least sum of |byte| read as signed, stopping at a zero sum."""
    h, w, bpp = rgb.shape
    prev = np.zeros(w * bpp, np.int32)
    zeros = np.zeros(bpp, np.int32)

    def cost(v):
        return int(np.minimum(v, 256 - v).sum())

    rows = []
    for y in range(h):
        cur = rgb[y].reshape(-1).astype(np.int32)
        left = np.concatenate([zeros, cur[:-bpp]])
        upleft = np.concatenate([zeros, prev[:-bpp]])
        best, data = 0, cur
        best_sum = cost(cur)
        for ftype, pred in ((2, lambda: prev), (1, lambda: left), (4, lambda: _paeth(left, prev, upleft))):
            if best_sum == 0:
                break
            cand = (cur - pred()) & 0xFF
            s = cost(cand)
            if s < best_sum:
                best, data, best_sum = ftype, cand, s
        rows.append(bytes([best]) + data.astype(np.uint8).tobytes())
        prev = cur
    return b"".join(rows)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png_as_pil(img: np.ndarray, flip: bool = True) -> bytes:
    """The bytes PIL's Image.fromarray(img[..., :3]).save(path) writes for a
    u8 image (the JAX package's write_png): adaptive row filters, zlib at
    the default level with the filtered strategy and memLevel 9, the stream
    cut into IDAT chunks of 65,536 bytes. Equal bytes need the same zlib."""
    if img.dtype != np.uint8:
        img = to_uint8(img)
    if flip:
        img = img[::-1]
    rgb = np.ascontiguousarray(img[..., :3])
    h, w = rgb.shape[:2]
    co = zlib.compressobj(zlib.Z_DEFAULT_COMPRESSION, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    z = co.compress(_adaptive_rows(rgb)) + co.flush()
    idat = b"".join(_chunk(b"IDAT", z[i:i + 65536]) for i in range(0, len(z), 65536))
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return _PNG_SIG + _chunk(b"IHDR", header) + idat + _chunk(b"IEND", b"")


def write_png(path: str, img: np.ndarray, flip: bool = True, as_pil: bool = False) -> None:
    """img: [H,W,3|4] float (0..1) or uint8. Written as 8-bit RGB (encode_png,
    or with as_pil the bytes the JAX package's PIL writer gives)."""
    with open(path, "wb") as f:
        f.write(encode_png_as_pil(img, flip) if as_pil else encode_png(img, flip))


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


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM over channels (Wang et al. 2004, 11x11 gaussian window)."""
    from scipy.ndimage import gaussian_filter

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 2:
        a = a[..., None]
        b = b[..., None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    sig = 1.5
    vals = []
    for ch in range(a.shape[-1]):
        x, y = a[..., ch], b[..., ch]
        mu_x = gaussian_filter(x, sig)
        mu_y = gaussian_filter(y, sig)
        sxx = gaussian_filter(x * x, sig) - mu_x**2
        syy = gaussian_filter(y * y, sig) - mu_y**2
        sxy = gaussian_filter(x * y, sig) - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / ((mu_x**2 + mu_y**2 + c1) * (sxx + syy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))
