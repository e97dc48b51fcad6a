"""Pure-Python LZ4 block decoder + pxr TfFastCompression framing.

The package depends on no lz4 binding and no pxr; USD crate (.usdc) payloads are
LZ4-block compressed with pxr's chunked framing (TfFastCompression,
pxr/base/tf/fastCompression.cpp): a leading chunk-count byte (0 = exactly one
LZ4 block follows), else N chunks each prefixed with an int32 compressed size.
"""

from __future__ import annotations

import struct

_MIN_MATCH = 4
# pxr chunks inputs at LZ4_MAX_INPUT_SIZE (0x7E000000); our files are far
# smaller, but keep the framing general.
_LZ4_MAX_INPUT = 0x7E000000


def lz4_block_decompress(src: bytes, dst_size: int) -> bytes:
    """Decode one raw LZ4 block into exactly dst_size bytes.

    The plain Python decoder (~MB/s)."""
    src = memoryview(src)
    dst = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[i]
                i += 1
                lit_len += b
                if b != 255:
                    break
        if lit_len:
            dst += src[i : i + lit_len]
            i += lit_len
        if i >= n:
            break  # last sequence has literals only
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("lz4: zero offset")
        match_len = (token & 0xF) + _MIN_MATCH
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                match_len += b
                if b != 255:
                    break
        start = len(dst) - offset
        if start < 0:
            raise ValueError("lz4: offset before start")
        # overlapping copy (RLE-style) must be byte-serial when ranges overlap
        if offset >= match_len:
            dst += dst[start : start + match_len]
        else:
            for k in range(match_len):
                dst.append(dst[start + k])
    if len(dst) != dst_size:
        raise ValueError(f"lz4: decoded {len(dst)} bytes, expected {dst_size}")
    return bytes(dst)


def fast_decompress(data: bytes, uncompressed_size: int) -> bytes:
    """pxr TfFastCompression::DecompressFromBuffer framing."""
    if not data:
        raise ValueError("empty compressed buffer")
    # untrusted header guard: LZ4 expands at most ~255x per block, so a
    # size claim beyond that is corruption — reject instead of attempting
    # a huge allocation (byte-flip fuzz found a 442 GiB attempt)
    if uncompressed_size < 0 or uncompressed_size > len(data) * 256 + 4096:
        raise ValueError(
            f"lz4: implausible uncompressed size {uncompressed_size} for "
            f"{len(data)} compressed bytes"
        )
    n_chunks = data[0]
    if n_chunks == 0:
        return lz4_block_decompress(data[1:], uncompressed_size)
    out = bytearray()
    pos = 1
    for k in range(n_chunks):
        (csize,) = struct.unpack_from("<i", data, pos)
        pos += 4
        remaining = uncompressed_size - len(out)
        chunk_size = min(_LZ4_MAX_INPUT, remaining)
        out += lz4_block_decompress(data[pos : pos + csize], chunk_size)
        pos += csize
    if len(out) != uncompressed_size:
        raise ValueError("chunked lz4: size mismatch")
    return bytes(out)
