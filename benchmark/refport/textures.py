"""Texture system: host-side manager + device atlas with filtered sampling.

The PyTorch port of strelka_tpu/textures.py (the replacement for CUDA
texture objects, OptixRender::loadTextureFromFile stb->cudaArray + filtered
tex objects, OptixRender.cpp:1191-1268, and the MDL texture runtime
tex_lookup_float4_2d, texture_support_cuda.h:287-528).

Host half (numpy, bit-equal with the JAX package): textures keep their
native resolution; a full mip chain is built per texture at pack time
(box-filtered in linear space) and every (texture, level) image is
shelf-packed into ONE [H, W, 4] sheet. A per-rect row table maps rect ids to
sheet regions; rect id == texture id for level 0, and a texture's levels
1..k occupy consecutive rect ids starting at its mip_base column, so level
selection is arithmetic on one row read. Color textures are stored
sRGB-encoded u8 and decoded to linear per texel before the blend (the
hardware decode-then-filter order); linear textures store u8 with a
per-texture scale. Images are decoded with the port's own PNG reader
(utils/image.py), which gives what PIL's convert("RGBA") gives, and one
above MAX_DIM texels an edge is shrunk by `resize_rgba_bilinear`, which
gives what PIL's resize(..., BILINEAR) of that RGBA image gives.

Device half (plain PyTorch on tensors): wrap/clamp addressing, bilinear,
trilinear and one-texel stochastic trilinear lookups, 3D volumes, cubemaps
and normal mapping. The JAX functions read the rect rows with a plain
`table[idx].T` (not a Pallas kernel), and so does the port.
"""

from __future__ import annotations

import math
import os
import struct
import zlib
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from refport import log
from refport.utils.image import read_png_rgba

MAX_DIM = 2048  # native detail preserved up to this edge length
MAX_MIP = 12  # 2048 -> 1x1 chain length

ADDRESS_WRAP = 0  # cudaAddressModeWrap
ADDRESS_CLAMP = 1  # cudaAddressModeClamp

FLAG_SRGB = 1  # rect stores sRGB-encoded u8 (decode before filtering)

# Optional Quilez smootherstep coordinate warp before the bilinear blend —
# parity with the reference's compile-time USE_SMOOTHERSTEP_FILTER
# (texture_support_cuda.h:262-280, default off there too).
SMOOTHERSTEP = False  # the reference keeps the default: no switch is read

# rects table columns
RC_X0, RC_Y0, RC_W, RC_H, RC_MODE, RC_FLAGS, RC_SCALE, RC_COUNT, RC_BASE = range(9)


class TextureAtlas(NamedTuple):
    """The texture sheet: numpy arrays from `build_atlas`, tensors on a
    device from `atlas_to_device`.

    data:  [H, W, 4] u8 (sRGB or scaled-linear, per-rect) or f32 linear
    rects: [R, 9] i32 — (x0, y0, w, h, address_mode, flags, scale_bits,
           mip_count, mip_base) per rect. Rects 0..L-1 are the level-0 rects
           of the L textures; texture i's level l>=1 is rect mip_base + l - 1
           (consecutive). scale_bits is an f32 bitcast (u8 decode scale).
    size:  the sheet's width
    meta:  [n_tex, 3] i32 (kind, depth, base): kind 0 = 2d, 1 = 3d volume
           (depth slices at consecutive rect ids base..base+D-1), 2 = cubemap
           (6 faces at base..base+5, CUDA face order +x -x +y -y +z -z)
    srgb_lut: [256] f32, the sRGB decode of each u8 value (device atlases)
    """

    data: object
    rects: object
    size: int
    meta: object = None
    srgb_lut: object = None


def _resize_bilinear(im: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Host-side bilinear resize of an [H,W,C] f32 image. At exactly half
    size this is the 2x2 box filter."""
    h, w = im.shape[:2]
    yy = (np.arange(out_h) + 0.5) * h / out_h - 0.5
    xx = (np.arange(out_w) + 0.5) * w / out_w - 0.5
    y0 = np.clip(np.floor(yy).astype(np.int64), 0, h - 1)
    x0 = np.clip(np.floor(xx).astype(np.int64), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    ty = np.clip(yy - y0, 0.0, 1.0)[:, None, None]
    tx = np.clip(xx - x0, 0.0, 1.0)[None, :, None]
    top = im[y0][:, x0] * (1 - tx) + im[y0][:, x1] * tx
    bot = im[y1][:, x0] * (1 - tx) + im[y1][:, x1] * tx
    return (top * (1 - ty) + bot * ty).astype(np.float32)


def _srgb_encode(rgb: np.ndarray) -> np.ndarray:
    return np.where(
        rgb <= 0.0031308, rgb * 12.92, 1.055 * np.maximum(rgb, 1e-12) ** (1 / 2.4) - 0.055
    )


_PRECISION_BITS = 32 - 8 - 2  # PIL's fixed-point coefficients (Resample.c)


def _bilinear_coeffs(in_size: int, out_size: int):
    """PIL's precompute_coeffs for the triangle filter over [0, in_size) and
    normalize_coeffs_8bpc: per output pixel the first input pixel, the
    count of inputs and the [out, ksize] fixed-point weights. When
    shrinking, the filter's support widens by the scale; weights are
    normalised to sum 1 in double, then rounded half away from zero."""
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = 1.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    ss = 1.0 / filterscale
    first = np.zeros(out_size, np.int64)
    count = np.zeros(out_size, np.int64)
    k = np.zeros((out_size, ksize), np.int64)
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [max(1.0 - abs((x + xmin - center + 0.5) * ss), 0.0) for x in range(xmax)]
        ww = sum(w)  # in order, as the C loop adds
        for x in range(xmax):
            v = w[x] / ww if ww != 0.0 else w[x]
            k[xx, x] = int(v * (1 << _PRECISION_BITS) + (0.5 if v >= 0 else -0.5))
        first[xx], count[xx] = xmin, xmax
    return first, count, k


def _resample_axis(img: np.ndarray, first, count, k, axis: int) -> np.ndarray:
    """One pass of PIL's 8-bit resample along `axis` (0 rows, 1 columns):
    integer sums from half an output step, clipped to u8 (clip8)."""
    n_in = img.shape[axis]
    idx = np.minimum(first[:, None] + np.arange(k.shape[1])[None, :], n_in - 1)
    out = np.empty(img.shape[:axis] + (len(first),) + img.shape[axis + 1:], np.uint8)
    src = np.moveaxis(img, axis, 0)
    dst = np.moveaxis(out, axis, 0)
    for i in range(len(first)):
        acc = np.full(src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
        for x in range(int(count[i])):
            acc += src[idx[i, x]].astype(np.int64) * k[i, x]
        dst[i] = np.where(acc >= (1 << _PRECISION_BITS << 8), 255,
                          np.where(acc <= 0, 0, acc >> _PRECISION_BITS)).astype(np.uint8)
    return out


def resize_rgba_bilinear(rgba: np.ndarray, width: int, height: int) -> np.ndarray:
    """[H, W, 4] u8 RGBA -> [height, width, 4] u8: what PIL's
    Image.resize((width, height), Image.BILINEAR) gives for an RGBA image
    (strelka_tpu/textures.py:126-135). PIL premultiplies by alpha (RGBa,
    (v * a + 128) * 257 >> 16), runs two separable passes of its fixed-point
    triangle filter (columns, then rows, a u8 image between them) and
    divides alpha back out (255 * v // a, clipped, where 0 < a < 255)."""
    rgba = np.asarray(rgba, np.uint8)
    h, w = rgba.shape[:2]
    if (w, h) == (width, height):
        return rgba.copy()
    a = rgba[..., 3:].astype(np.int64)
    tmp = rgba[..., :3].astype(np.int64) * a + 128
    img = np.concatenate([((tmp >> 8) + tmp) >> 8, a], axis=-1).astype(np.uint8)
    fy, cy, ky = _bilinear_coeffs(h, height)
    if width != w:
        rows = slice(int(fy[0]), int(fy[-1] + cy[-1]))  # the rows the vertical pass reads
        img = _resample_axis(img[rows], *_bilinear_coeffs(w, width), axis=1)
        fy = fy - rows.start
    if height != h:
        img = _resample_axis(img, fy, cy, ky, axis=0)
    a = img[..., 3:].astype(np.int64)
    rgb = img[..., :3].astype(np.int64)
    straight = np.minimum(255 * rgb // np.maximum(a, 1), 255)
    rgb = np.where((a == 0) | (a == 255), rgb, straight)
    return np.concatenate([rgb, a], axis=-1).astype(np.uint8)


class TextureManager:
    """Host registry: load images at native size, dedupe by path, shelf-pack
    the sheet. The 'registerResource' analog (materialmanager.cpp:611-618):
    textures get integer ids that material params reference.
    """

    def __init__(self, atlas_size: int = MAX_DIM, search_path: str = ""):
        self.max_dim = atlas_size
        self.search_path = search_path
        self._images: List[np.ndarray] = []  # linear f32 [H,W,4]
        self._modes: List[int] = []
        self._srgb: List[bool] = []  # store sRGB-encoded u8 for this texture
        self._nomip: List[bool] = []  # volume slices / cube faces: level 0 only
        self._meta = {}  # head tex id -> (kind, depth, base)
        self._path_to_id = {}

    def load(self, path: str, srgb: bool = True, address_mode: int = ADDRESS_WRAP) -> int:
        """Load (or look up) a PNG file; returns texture id or -1."""
        key = (path, srgb)
        if key in self._path_to_id:
            return self._path_to_id[key]
        full = path
        if not os.path.isabs(full) and self.search_path:
            cand = os.path.join(self.search_path, path)
            if os.path.exists(cand):
                full = cand
        if not os.path.exists(full):
            log.warning("Texture not found: {}", path)
            return -1
        try:
            rgba = read_png_rgba(full)
        except (OSError, ValueError, zlib.error, struct.error) as e:
            log.warning("Texture load failed for {}: {}", path, e)
            return -1
        h, w = rgba.shape[:2]
        if max(w, h) > self.max_dim:
            s = self.max_dim / max(w, h)
            rgba = resize_rgba_bilinear(rgba, max(1, int(w * s)), max(1, int(h * s)))
        arr = rgba.astype(np.float32) / 255.0
        if srgb:
            rgb = arr[..., :3]
            # exact sRGB EOTF (cuda/helpers.h toSRGB inverse)
            lin = np.where(rgb <= 0.04045, rgb / 12.92, ((rgb + 0.055) / 1.055) ** 2.4)
            arr = np.concatenate([lin, arr[..., 3:]], axis=-1)
        tex_id = len(self._images)
        self._images.append(arr.astype(np.float32))
        self._modes.append(address_mode)
        self._srgb.append(bool(srgb))
        self._nomip.append(False)
        self._path_to_id[key] = tex_id
        log.debug("Loaded texture {} ({}x{}) -> id {}", path, arr.shape[1], arr.shape[0], tex_id)
        return tex_id

    def add_array(self, arr: np.ndarray, name: str = "", address_mode: int = ADDRESS_WRAP) -> int:
        """Register an in-memory [H,W,3|4] float image (tests, procedural)."""
        a = np.asarray(arr, np.float32)
        if a.shape[-1] == 3:
            a = np.concatenate([a, np.ones(a.shape[:-1] + (1,), np.float32)], -1)
        tex_id = len(self._images)
        self._images.append(a)
        self._modes.append(address_mode)
        self._srgb.append(False)
        self._nomip.append(False)
        if name:
            self._path_to_id[(name, False)] = tex_id
        return tex_id

    def add_volume(self, vol: np.ndarray, name: str = "", address_mode: int = ADDRESS_WRAP) -> int:
        """Register an in-memory [D,H,W,3|4] float volume as a texture_3d
        (tex_lookup_float4_3d, texture_support_cuda.h:433-463): the D slices
        become D consecutive level-0 rects of the one sheet (sample_3d).
        Returns the head texture id."""
        v = np.asarray(vol, np.float32)
        if v.ndim != 4:
            raise ValueError(f"volume must be [D,H,W,C], got {v.shape}")
        head = len(self._images)
        for k in range(v.shape[0]):
            self.add_array(v[k], address_mode=address_mode)
            self._nomip[-1] = True
        self._meta[head] = (1, v.shape[0], head)
        if name:
            self._path_to_id[(name, False)] = head
        return head

    def add_cubemap(self, faces: np.ndarray, name: str = "") -> int:
        """Register an in-memory [6,H,W,3|4] cubemap, CUDA face order
        (+x -x +y -y +z -z; tex_lookup_float4_cube,
        texture_support_cuda.h:522-558). Faces sample with clamp addressing.
        Returns the head texture id."""
        f = np.asarray(faces, np.float32)
        if f.ndim != 4 or f.shape[0] != 6:
            raise ValueError(f"cubemap must be [6,H,W,C], got {f.shape}")
        head = len(self._images)
        for k in range(6):
            self.add_array(f[k], address_mode=ADDRESS_CLAMP)
            self._nomip[-1] = True
        self._meta[head] = (2, 6, head)
        if name:
            self._path_to_id[(name, False)] = head
        return head

    @property
    def count(self) -> int:
        return len(self._images)

    def build_atlas(self, dtype: str = "u8", mipmaps: bool = True) -> Optional[TextureAtlas]:
        """Shelf-pack all textures (and their mip chains) into one sheet of
        numpy arrays (`atlas_to_device` puts it on a device).

        dtype: "u8" (default; sRGB-encoded color / scaled-linear) or "f32"
        (exact linear floats). mipmaps=False packs level 0 only."""
        if not self._images:
            return None
        sheet_w = max(128, min(self.max_dim, max(im.shape[1] for im in self._images)))
        sheet_w = 1 << (sheet_w - 1).bit_length()  # pow2 lanes
        # downscale (never crop) any registered image wider than the sheet —
        # loader-capped images are safe, in-memory add_array() ones may not be
        for i, im in enumerate(self._images):
            h, w = im.shape[:2]
            if w > sheet_w:
                s = sheet_w / w
                self._images[i] = _resize_bilinear(im, max(1, int(round(h * s))), sheet_w)
                log.warning(
                    "Texture {} ({}x{}) wider than sheet ({}); downscaled", i, w, h, sheet_w
                )

        # ---- the full rect list: level-0 rects first (rect id == texture
        # id), then each texture's levels 1..k in consecutive rect slots
        n_tex = len(self._images)
        rect_imgs: List[np.ndarray] = list(self._images)
        rect_mode: List[int] = list(self._modes)
        rect_srgb: List[bool] = list(self._srgb)
        counts = np.ones(n_tex, np.int32)
        bases = np.arange(n_tex, dtype=np.int32)  # unused when count == 1
        if mipmaps:
            for i in range(n_tex):
                if self._nomip[i]:
                    continue  # volume slices / cube faces: level 0 only
                im = self._images[i]
                bases[i] = len(rect_imgs)
                level = 1
                while max(im.shape[0], im.shape[1]) > 1 and level < MAX_MIP:
                    im = _resize_bilinear(
                        im, max(1, im.shape[0] // 2), max(1, im.shape[1] // 2)
                    )
                    rect_imgs.append(im)
                    rect_mode.append(self._modes[i])
                    rect_srgb.append(self._srgb[i])
                    level += 1
                counts[i] = level

        # ---- shelf-pack (tallest first)
        order = sorted(range(len(rect_imgs)), key=lambda i: -rect_imgs[i].shape[0])
        rects = np.zeros((len(rect_imgs), 9), np.int32)
        x = y = shelf_h = 0
        for i in order:
            h, w = rect_imgs[i].shape[:2]
            if x + w > sheet_w:
                y += shelf_h
                x = shelf_h = 0
            rects[i, :5] = (x, y, w, h, rect_mode[i])
            x += w
            shelf_h = max(shelf_h, h)
        total_h = y + shelf_h
        rects[:n_tex, RC_COUNT] = counts
        rects[:n_tex, RC_BASE] = bases
        rects[:, RC_SCALE] = np.float32(1.0).view(np.int32)

        # ---- encode the sheet
        if dtype == "u8":
            sheet = np.zeros((total_h, sheet_w, 4), np.uint8)
            for i, im in enumerate(rect_imgs):
                x0, y0, w, h = rects[i, :4]
                if rect_srgb[i]:
                    enc = np.concatenate(
                        [_srgb_encode(im[..., :3]), im[..., 3:]], axis=-1
                    )
                    rects[i, RC_FLAGS] |= FLAG_SRGB
                else:
                    s = float(max(1.0, im.max())) if im.size else 1.0
                    rects[i, RC_SCALE] = np.float32(s).view(np.int32)
                    enc = im / s
                sheet[y0 : y0 + h, x0 : x0 + w] = np.clip(
                    np.round(enc[:h, :w] * 255.0), 0, 255
                ).astype(np.uint8)
        else:
            sheet = np.zeros((total_h, sheet_w, 4), np.float32)
            for i, im in enumerate(rect_imgs):
                x0, y0, w, h = rects[i, :4]
                sheet[y0 : y0 + h, x0 : x0 + w] = im[:h, :w]
        log.info(
            "Texture sheet: {} textures / {} rects packed into {}x{} {} ({:.1f} MB)",
            n_tex, len(rect_imgs), sheet_w, total_h, dtype, sheet.nbytes / 1e6,
        )
        meta = np.zeros((n_tex, 3), np.int32)
        meta[:, 1] = 1
        meta[:, 2] = np.arange(n_tex)
        for head, (kind, depth, base) in self._meta.items():
            meta[head] = (kind, depth, base)
        return TextureAtlas(data=sheet, rects=rects, size=sheet_w, meta=meta)


def srgb_decode_lut() -> torch.Tensor:
    """[256] f32: the sRGB decode of each u8 value, by the formula the JAX
    package applies per texel (computed once, on the CPU)."""
    cf = torch.arange(256, dtype=torch.float32) * (1.0 / 255.0)
    return torch.where(cf <= 0.04045, cf / 12.92, ((cf + 0.055) / 1.055) ** 2.4)


def atlas_to_device(atlas: TextureAtlas, device) -> TextureAtlas:
    """An atlas of numpy arrays (or a JAX atlas converted field by field) as
    tensors on `device`."""
    data = np.ascontiguousarray(atlas.data)
    return TextureAtlas(
        data=torch.tensor(data, device=device),
        rects=torch.tensor(np.ascontiguousarray(atlas.rects, np.int32), device=device),
        size=int(atlas.size),
        meta=None if atlas.meta is None else torch.tensor(np.ascontiguousarray(atlas.meta, np.int32), device=device),
        srgb_lut=srgb_decode_lut().to(device),
    )


def _rows_t(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[clip(idx)].T: the JAX package's plain `gather_rows_t` on the
    small int32 rect and meta tables."""
    idx = torch.clamp(idx.to(torch.int64), 0, table.shape[0] - 1)
    return table[idx].T


def _clip_t(x: torch.Tensor, lo, hi: torch.Tensor) -> torch.Tensor:
    """jnp.clip(x, lo, hi) with a tensor upper bound."""
    return torch.minimum(torch.clamp(x, min=lo), hi)


def _texel_setup(r, uv):
    """Shared bilinear addressing math for rect rows r [9, N] i32 + uv [N,2].
    Returns (xb, yb, tx, ty, addr) where (xb, yb) is the base texel, (tx, ty)
    the (optionally smootherstep-warped) filter fractions [N], and addr the
    per-rect wrap/clamp address function. V flipped (row 0 = v 1, GL).
    `u % 1.0` and `mod` are floor-mod: torch.remainder, not torch.fmod."""
    w, h = r[RC_W], r[RC_H]
    wf = w.to(torch.float32)
    hf = h.to(torch.float32)
    u = uv[..., 0]
    v = 1.0 - uv[..., 1]
    clamp = r[RC_MODE] == ADDRESS_CLAMP
    uu = torch.where(clamp, torch.clamp(u, 0.0, 1.0), torch.remainder(u, 1.0))
    vv = torch.where(clamp, torch.clamp(v, 0.0, 1.0), torch.remainder(v, 1.0))
    fu = uu * wf - 0.5
    fv = vv * hf - 0.5
    xb = torch.floor(fu)
    yb = torch.floor(fv)
    tx = fu - xb
    ty = fv - yb
    if SMOOTHERSTEP:
        # quintic warp of the texel fraction (APPLY_SMOOTHERSTEP_FILTER,
        # texture_support_cuda.h:265-280)
        tx = tx * tx * tx * (tx * (tx * 6.0 - 15.0) + 10.0)
        ty = ty * ty * ty * (ty * (ty * 6.0 - 15.0) + 10.0)

    def addr(i, extent):
        wrapped = torch.remainder(i, extent)
        clamped = _clip_t(i, 0, extent - 1)
        return torch.where(clamp, clamped, wrapped)

    return xb.to(torch.int32), yb.to(torch.int32), tx, ty, addr


def _decode_fetch(atlas: TextureAtlas, r, yi, xi):
    """One texel fetch at rect-local (yi, xi), decoded to linear f32 [N,4].
    u8 sheets decode (sRGB or scale) per texel, like hardware decode-then-
    filter (texture_support_cuda.h)."""
    c = atlas.data[(r[RC_Y0] + yi).to(torch.int64), (r[RC_X0] + xi).to(torch.int64)]
    if atlas.data.dtype != torch.uint8:
        return c
    srgb = ((r[RC_FLAGS] & FLAG_SRGB) != 0)[..., None]
    scale = r[RC_SCALE].contiguous().view(torch.float32)[..., None]
    ci = c.to(torch.int64)
    cf = ci.to(torch.float32) * (1.0 / 255.0)
    out = torch.where(srgb, atlas.srgb_lut[ci], cf * scale)
    # alpha is stored linear even for sRGB rects
    alpha = torch.where(srgb[..., 0], cf[..., 3], cf[..., 3] * scale[..., 0])
    return torch.cat([out[..., :3], alpha[..., None]], dim=-1)


def _sample_rect_rows(atlas: TextureAtlas, r, uv):
    """Bilinear lookup given pre-gathered rect rows r [9, N] i32.
    uv: [N,2]. -> [N,4] f32 linear. u8 sheets decode each texel (sRGB or
    scale) BEFORE the bilinear blend. V flipped (row 0 = v 1, GL)."""
    w, h = r[RC_W], r[RC_H]
    xb, yb, tx, ty, addr = _texel_setup(r, uv)
    tx = tx[..., None]
    ty = ty[..., None]
    x0i = addr(xb, w)
    y0i = addr(yb, h)
    x1i = addr(xb + 1, w)
    y1i = addr(yb + 1, h)
    c00 = _decode_fetch(atlas, r, y0i, x0i)
    c10 = _decode_fetch(atlas, r, y0i, x1i)
    c01 = _decode_fetch(atlas, r, y1i, x0i)
    c11 = _decode_fetch(atlas, r, y1i, x1i)
    top = c00 * (1 - tx) + c10 * tx
    bot = c01 * (1 - tx) + c11 * tx
    return top * (1 - ty) + bot * ty


def _sample_rect_rows_stochastic(atlas: TextureAtlas, r, uv, rx, ry):
    """ONE-texel stochastic bilinear: picks the x1/y1 neighbor with
    probability equal to its filter weight (rx, ry: [N] uniforms), so
    E[result] == _sample_rect_rows exactly (decode is per-texel in both)."""
    w, h = r[RC_W], r[RC_H]
    xb, yb, tx, ty, addr = _texel_setup(r, uv)
    xi = addr(xb + (rx < tx).to(xb.dtype), w)
    yi = addr(yb + (ry < ty).to(yb.dtype), h)
    return _decode_fetch(atlas, r, yi, xi)


def _ones_where_none(tex_id, out):
    return torch.where((tex_id >= 0)[..., None], out, torch.ones_like(out))


def sample_bilinear(atlas: TextureAtlas, tex_id, uv):
    """Level-0 bilinear lookup (tex_lookup_float4_2d equivalent,
    texture_support_cuda.h:287-528). tex_id: [N] i32 (< 0 -> ones).
    uv: [N,2]. -> [N,4] f32 linear."""
    r = _rows_t(atlas.rects, tex_id)
    return _ones_where_none(tex_id, _sample_rect_rows(atlas, r, uv))


def _lod_level(atlas: TextureAtlas, tex_id, lod_uv):
    """(tid, level-0 rows, lod clipped to the texture's chain, count): the
    texel LOD is lod_uv + log2(max(w, h))."""
    tid = torch.clamp(tex_id, 0, atlas.rects.shape[0] - 1)
    r0 = _rows_t(atlas.rects, tid)  # level-0 rows carry count/base
    dim = torch.maximum(r0[RC_W], r0[RC_H]).to(torch.float32)
    count = r0[RC_COUNT]
    lod = lod_uv + torch.log2(torch.clamp(dim, min=1.0))
    lod = _clip_t(lod, 0.0, count.to(torch.float32) - 1.0)
    return tid, r0, lod, count


def _level_rect(tid, r0, li):
    """Rect id of mip level li (level 0 is the texture id itself)."""
    return torch.where(li == 0, tid, r0[RC_BASE] + li - 1)


def sample_trilinear(atlas: TextureAtlas, tex_id, uv, lod_uv):
    """Trilinear (mipmapped) lookup. lod_uv: [N] f32 = log2 of the sample
    footprint in UV units; blends the two straddling mip levels (the
    hardware-mipmap path of the reference's cudaArray textures)."""
    tid, r0, lod, count = _lod_level(atlas, tex_id, lod_uv)
    l0 = torch.floor(lod)
    frac = (lod - l0)[..., None]
    l0i = l0.to(torch.int32)
    l1i = torch.minimum(l0i + 1, count - 1)
    a = _sample_rect_rows(atlas, _rows_t(atlas.rects, _level_rect(tid, r0, l0i)), uv)
    b = _sample_rect_rows(atlas, _rows_t(atlas.rects, _level_rect(tid, r0, l1i)), uv)
    return _ones_where_none(tex_id, a * (1.0 - frac) + b * frac)


def sample_trilinear_stochastic(atlas: TextureAtlas, tex_id, uv, lod_uv, rnd3):
    """ONE-texel stochastic trilinear: the mip level is drawn with
    probability equal to its blend weight and the bilinear footprint is
    sampled with one texel, so E[result] == sample_trilinear while touching
    1 sheet texel per lane instead of 8 (the default filtered lookup; the
    filter's variance converges with spp like every other dimension).

    rnd3: 3 x [N] f32 uniforms (level pick, x pick, y pick)."""
    tid, r0, lod, count = _lod_level(atlas, tex_id, lod_uv)
    l0 = torch.floor(lod)
    frac = lod - l0
    li = l0.to(torch.int32) + (rnd3[0] < frac).to(torch.int32)
    li = torch.minimum(li, count - 1)
    r = _rows_t(atlas.rects, _level_rect(tid, r0, li))
    return _ones_where_none(tex_id, _sample_rect_rows_stochastic(atlas, r, uv, rnd3[1], rnd3[2]))


def sample_3d(atlas: TextureAtlas, tex_id, uvw):
    """texture_3d lookup (tex_lookup_float4_3d, texture_support_cuda.h:433-463).

    tex_id: [N] i32 head ids from TextureManager.add_volume (< 0 -> ones).
    uvw: [N,3]. Trilinear: bilinear on the two straddling slices + a lerp
    in w; w addressing follows the texture's wrap/clamp mode."""
    if atlas.meta is None:
        return torch.ones(uvw.shape[:-1] + (4,), dtype=torch.float32, device=uvw.device)
    m = _rows_t(atlas.meta, tex_id)  # [3, N]
    depth = torch.clamp(m[1], min=1)
    base = m[2]
    df = depth.to(torch.float32)
    head = _rows_t(atlas.rects, base)
    clamp = head[RC_MODE] == ADDRESS_CLAMP
    w = uvw[..., 2]
    ww = torch.where(clamp, torch.clamp(w, 0.0, 1.0), torch.remainder(w, 1.0))
    fd = ww * df - 0.5
    k = torch.floor(fd)
    tw = (fd - k)[..., None]
    k0 = k.to(torch.int32)
    k1 = k0 + 1
    k0 = torch.where(clamp, _clip_t(k0, 0, depth - 1), torch.remainder(k0, depth))
    k1 = torch.where(clamp, _clip_t(k1, 0, depth - 1), torch.remainder(k1, depth))
    a = _sample_rect_rows(atlas, _rows_t(atlas.rects, base + k0), uvw[..., :2])
    b = _sample_rect_rows(atlas, _rows_t(atlas.rects, base + k1), uvw[..., :2])
    out = a * (1.0 - tw) + b * tw
    ok = (tex_id >= 0) & (m[0] == 1)
    return torch.where(ok[..., None], out, torch.ones_like(out))


def sample_cube(atlas: TextureAtlas, tex_id, direction):
    """texture_cube lookup (tex_lookup_float4_cube,
    texture_support_cuda.h:522-558). direction: [N,3] (need not be
    normalized). CUDA cubemap convention: face = major axis, and

      +x: (sc,tc) = (-z,-y)   -x: (+z,-y)
      +y: (+x,+z)             -y: (+x,-z)
      +z: (+x,-y)             -z: (-x,-y)

    with u = (sc/|ma| + 1)/2, v flipped by the sampler's GL convention.
    Faces use clamp addressing."""
    if atlas.meta is None:
        return torch.ones(direction.shape[:-1] + (4,), dtype=torch.float32, device=direction.device)
    m = _rows_t(atlas.meta, tex_id)
    base = m[2]
    x, y, z = direction[..., 0], direction[..., 1], direction[..., 2]
    ax, ay, az = torch.abs(x), torch.abs(y), torch.abs(z)
    is_x = (ax >= ay) & (ax >= az)
    is_y = (~is_x) & (ay >= az)
    face = torch.where(
        is_x,
        torch.where(x >= 0, 0, 1),
        torch.where(is_y, torch.where(y >= 0, 2, 3), torch.where(z >= 0, 4, 5)),
    ).to(torch.int32)
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az))
    ma = torch.clamp(ma, min=1e-20)
    sc = torch.where(
        is_x, torch.where(x >= 0, -z, z), torch.where(is_y, x, torch.where(z >= 0, x, -x))
    )
    tc = torch.where(is_x, -y, torch.where(is_y, torch.where(y >= 0, z, -z), -y))
    u = (sc / ma + 1.0) * 0.5
    # _sample_rect_rows flips v (GL convention); feed 1-v so tc lands as-is
    v = 1.0 - (tc / ma + 1.0) * 0.5
    r = _rows_t(atlas.rects, base + face)
    out = _sample_rect_rows(atlas, r, torch.stack([u, v], dim=-1))
    ok = (tex_id >= 0) & (m[0] == 2)
    return torch.where(ok[..., None], out, torch.ones_like(out))


def apply_normal_map(normal, tangent, binormal, tex_rgb):
    """Perturb the shading normal with a tangent-space normal map sample
    ([N,3] tensors)."""
    n_ts = tex_rgb * 2.0 - 1.0
    out = n_ts[..., 0:1] * tangent + n_ts[..., 1:2] * binormal + n_ts[..., 2:3] * normal
    norm = torch.linalg.norm(out, dim=-1, keepdim=True)
    return torch.where(norm > 1e-8, out / torch.clamp(norm, min=1e-8), normal)
