"""Pure-Python LZ4 block codec + pxr TfFastCompression framing.

The package depends on no lz4 binding and no pxr; USD crate (.usdc) payloads are
LZ4-block compressed with pxr's chunked framing (TfFastCompression,
pxr/base/tf/fastCompression.cpp): a leading chunk-count byte (0 = exactly one
LZ4 block follows), else N chunks each prefixed with an int32 compressed size.

The compressor is a greedy hash-table matcher producing standard LZ4 blocks —
used by the crate WRITER (tests round-trip through it, and it makes the
exporter produce genuinely compressed files).
"""

from __future__ import annotations

import struct

_MIN_MATCH = 4
_MAX_OFFSET = 65535
# pxr chunks inputs at LZ4_MAX_INPUT_SIZE (0x7E000000); our files are far
# smaller, but keep the framing general.
_LZ4_MAX_INPUT = 0x7E000000


def lz4_block_decompress(src: bytes, dst_size: int) -> bytes:
    """Decode one raw LZ4 block into exactly dst_size bytes.

    Uses the native C++ decoder when available (~GB/s; the Python loop below
    is the fallback at ~MB/s — it matters for production-size usdc stages)."""
    try:
        from strelka_tpu_torch.native import native_lz4_decompress

        out = native_lz4_decompress(bytes(src), dst_size)
        if out is not None:
            return out
    except ImportError:
        pass
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


def lz4_block_compress(src: bytes) -> bytes:
    """Greedy LZ4 block encoder (correct, moderately tight)."""
    n = len(src)
    out = bytearray()
    if n == 0:
        return b"\x00"
    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    # spec: last 5 bytes are always literals; matches must end 12 bytes
    # before the block end for the fast decoders
    match_limit = n - 12

    def emit(lit_start, lit_end, match_len, offset):
        lit_len = lit_end - lit_start
        tok_lit = 15 if lit_len >= 15 else lit_len
        if match_len == 0:
            out.append(tok_lit << 4)
        else:
            ml = match_len - _MIN_MATCH
            tok_m = 15 if ml >= 15 else ml
            out.append((tok_lit << 4) | tok_m)
        rem = lit_len - 15
        while rem >= 0:
            out.append(min(rem, 255))
            if rem < 255:
                break
            rem -= 255
        out.extend(src[lit_start:lit_end])
        if match_len:
            out.extend(struct.pack("<H", offset))
            rem = (match_len - _MIN_MATCH) - 15
            while rem >= 0:
                out.append(min(rem, 255))
                if rem < 255:
                    break
                rem -= 255

    while i < match_limit:
        key = src[i : i + 4]
        cand = table.get(key)
        table[key] = i
        if cand is not None and i - cand <= _MAX_OFFSET and src[cand : cand + 4] == key:
            # extend match
            m = i + 4
            c = cand + 4
            while m < match_limit and src[m] == src[c]:
                m += 1
                c += 1
            emit(anchor, i, m - i, i - cand)
            i = m
            anchor = m
        else:
            i += 1
    emit(anchor, n, 0, 0)  # trailing literals
    return bytes(out)


def fast_compress(data: bytes) -> bytes:
    """pxr TfFastCompression::CompressToBuffer framing."""
    chunks = [data[i : i + _LZ4_MAX_INPUT] for i in range(0, max(len(data), 1), _LZ4_MAX_INPUT)]
    if len(chunks) == 1:
        return b"\x00" + lz4_block_compress(chunks[0])
    out = bytearray([len(chunks)])
    for c in chunks:
        blob = lz4_block_compress(c)
        out += struct.pack("<i", len(blob))
        out += blob
    return bytes(out)


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
