"""USD crate (.usdc) binary file reader + writer, pure Python.

The reference's canonical workflow opens binary stages
(`./Strelka -s misc/coffeemaker.usdc`, reference README.md:66-68;
stage open at reference src/hdRunner/main.cpp:566-591 via pxr). The
package does not depend on pxr, so this implements the crate container format
directly (file layout per pxr/usd/usd/crateFile.cpp, version 0.8.x):

  bootstrap(88B: magic "PXR-USDC", version, toc offset)
  sections TOKENS / STRINGS / FIELDS / FIELDSETS / PATHS / SPECS
  LZ4-compressed payloads (pxr TfFastCompression framing, loaders/lz4.py)
  delta+bytecode integer compression (pxr Usd_IntegerCompression)

read_usdc() returns the same Prim/Attr pseudo-stage the text parser
(usda_parser.py) produces, so everything downstream (loaders/usd.py, the
Hydra-shaped delegate) consumes .usda and .usdc identically.

write_usdc() emits a flattened stage in the same format — used by the tests
to round-trip (no pxr exists here to generate fixtures) and doubles as an
exporter the reference does not have.

Scope: flattened stages (no sublayers/references/payloads), default values
(timeSamples resolve to nothing yet), the value types scene ingestion needs.
Unknown field values degrade to warnings, never errors.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from strelka_tpu_torch import log
from strelka_tpu_torch.loaders.lz4 import fast_compress, fast_decompress
from strelka_tpu_torch.loaders.usda_parser import Attr, Prim, resolve_variants

_MAGIC = b"PXR-USDC"
_VERSION = (0, 8, 0)

# crate value types (pxr crateDataTypes.h enum order)
T_BOOL = 1
T_UCHAR = 2
T_INT = 3
T_UINT = 4
T_INT64 = 5
T_UINT64 = 6
T_HALF = 7
T_FLOAT = 8
T_DOUBLE = 9
T_STRING = 10
T_TOKEN = 11
T_ASSET = 12
T_MATRIX2D = 13
T_MATRIX3D = 14
T_MATRIX4D = 15
T_QUATD = 16
T_QUATF = 17
T_QUATH = 18
T_VEC2D = 19
T_VEC2F = 20
T_VEC2H = 21
T_VEC2I = 22
T_VEC3D = 23
T_VEC3F = 24
T_VEC3H = 25
T_VEC3I = 26
T_VEC4D = 27
T_VEC4F = 28
T_VEC4H = 29
T_VEC4I = 30
T_DICTIONARY = 31
T_TOKEN_LIST_OP = 32
T_STRING_LIST_OP = 33
T_PATH_LIST_OP = 34
T_REFERENCE_LIST_OP = 35
T_INT_LIST_OP = 36
T_INT64_LIST_OP = 37
T_UINT_LIST_OP = 38
T_UINT64_LIST_OP = 39
T_PATH_VECTOR = 40
T_TOKEN_VECTOR = 41
T_SPECIFIER = 42
T_PERMISSION = 43
T_VARIABILITY = 44
T_VARIANT_SELECTION_MAP = 45
T_TIME_SAMPLES = 46
T_PAYLOAD = 47
T_DOUBLE_VECTOR = 48
T_LAYER_OFFSET_VECTOR = 49
T_STRING_VECTOR = 50
T_VALUE_BLOCK = 51
T_VALUE = 52

_ARRAY_BIT = 1 << 63
_INLINED_BIT = 1 << 62
_COMPRESSED_BIT = 1 << 61
_PAYLOAD_MASK = (1 << 48) - 1

# SdfSpecType
SPEC_ATTRIBUTE = 1
SPEC_CONNECTION = 2
SPEC_PRIM = 6
SPEC_PSEUDO_ROOT = 7
SPEC_RELATIONSHIP = 8
SPEC_VARIANT = 10
SPEC_VARIANT_SET = 11

_SPECIFIERS = ["def", "over", "class"]

# numpy dtypes for plain fixed-size value types
_SCALAR_FMT = {
    T_INT: ("<i4", 1),
    T_UINT: ("<u4", 1),
    T_INT64: ("<i8", 1),
    T_UINT64: ("<u8", 1),
    T_HALF: ("<f2", 1),
    T_FLOAT: ("<f4", 1),
    T_DOUBLE: ("<f8", 1),
    T_UCHAR: ("<u1", 1),
    T_VEC2F: ("<f4", 2),
    T_VEC2D: ("<f8", 2),
    T_VEC2I: ("<i4", 2),
    T_VEC2H: ("<f2", 2),
    T_VEC3F: ("<f4", 3),
    T_VEC3D: ("<f8", 3),
    T_VEC3I: ("<i4", 3),
    T_VEC3H: ("<f2", 3),
    T_VEC4F: ("<f4", 4),
    T_VEC4D: ("<f8", 4),
    T_VEC4I: ("<i4", 4),
    T_VEC4H: ("<f2", 4),
    T_QUATF: ("<f4", 4),
    T_QUATD: ("<f8", 4),
    T_QUATH: ("<f2", 4),
    T_MATRIX2D: ("<f8", 4),
    T_MATRIX3D: ("<f8", 9),
    T_MATRIX4D: ("<f8", 16),
}


# ---------------------------------------------------------------------------
# Usd_IntegerCompression (pxr/usd/usd/integerCoding.cpp)
# ---------------------------------------------------------------------------


def _decode_ints(buf: bytes, n: int, wide: bool = False) -> np.ndarray:
    """Decode n delta+bytecode-compressed ints from the DECOMPRESSED buffer."""
    itype = np.int64 if wide else np.int32
    common_size = 8 if wide else 4
    common = struct.unpack_from("<q" if wide else "<i", buf, 0)[0]
    codes_off = common_size
    n_code_bytes = (n * 2 + 7) // 8
    vints_off = codes_off + n_code_bytes
    out = np.empty(n, itype)
    prev = 0
    pos = vints_off
    # Per-code explicit-delta widths. pxr's 64-bit codec
    # (Usd_IntegerCompression64, integerCoding.cpp) is int16/int32/int64 for
    # codes 1/2/3; the 32-bit codec is int8/int16/int32.
    fmts = (("<h", 2), ("<i", 4), ("<q", 8)) if wide else (("<b", 1), ("<h", 2), ("<i", 4))
    for i in range(n):
        code = (buf[codes_off + (i >> 2)] >> ((i & 3) * 2)) & 3
        if code == 0:
            delta = common
        else:
            fmt, sz = fmts[code - 1]
            delta = struct.unpack_from(fmt, buf, pos)[0]
            pos += sz
        prev = _wrap(prev + delta, wide)
        out[i] = prev
    return out


def _wrap(v: int, wide: bool) -> int:
    """Wrap to signed int32/int64 (deltas use machine wraparound arithmetic)."""
    bits = 64 if wide else 32
    v &= (1 << bits) - 1
    if v >= 1 << (bits - 1):
        v -= 1 << bits
    return v


def _encode_ints(values, wide: bool = False) -> bytes:
    """Inverse of _decode_ints (pre-compression encoding)."""
    values = [int(v) for v in values]
    n = len(values)
    deltas = []
    prev = 0
    for v in values:
        deltas.append(_wrap(v - prev, wide))
        prev = v
    if n:
        from collections import Counter

        common = Counter(deltas).most_common(1)[0][0]
    else:
        common = 0
    out = bytearray()
    out += struct.pack("<q" if wide else "<i", common)
    codes = bytearray((n * 2 + 7) // 8)
    vints = bytearray()
    # widths must mirror _decode_ints (pxr: 64-bit codec shifts one size up)
    fmts = (("<h", 1 << 15), ("<i", 1 << 31)) if wide else (("<b", 1 << 7), ("<h", 1 << 15))
    widest = "<q" if wide else "<i"
    for i, d in enumerate(deltas):
        if d == common:
            code = 0
        elif -fmts[0][1] <= d < fmts[0][1]:
            code = 1
            vints += struct.pack(fmts[0][0], d)
        elif -fmts[1][1] <= d < fmts[1][1]:
            code = 2
            vints += struct.pack(fmts[1][0], d)
        else:
            code = 3
            vints += struct.pack(widest, d)
        codes[i >> 2] |= code << ((i & 3) * 2)
    out += codes
    out += vints
    return bytes(out)


def _read_compressed_ints(r: "_Reader", n: int, wide: bool = False) -> np.ndarray:
    comp_size = r.u64()
    comp = r.read(comp_size)
    # untrusted-count guard: n comes from a section header; every decoded
    # int needs a 2-bit code in the stream, so n is bounded by what the
    # (255x-capped) decompressed buffer could physically hold — reject
    # corrupt counts before any allocation sized by them
    max_plausible_buf = len(comp) * 256 + 4096
    if n < 0 or (n * 2 + 7) // 8 + (8 if wide else 4) > max_plausible_buf:
        raise ValueError(f"integer-compression: implausible count {n}")
    # decompressed size upper bound: common + codes + n * maxint
    max_size = (8 if wide else 4) + (n * 2 + 7) // 8 + n * (8 if wide else 4)
    buf = _lenient_decompress(comp, max_size)
    if (n * 2 + 7) // 8 + (8 if wide else 4) > len(buf):
        raise ValueError(f"integer-compression: count {n} exceeds stream")
    try:
        from strelka_tpu_torch.native import native_int_decode

        out = native_int_decode(buf, n, wide)
        if out is not None:
            return out
    except ImportError:
        pass
    return _decode_ints(buf, n, wide)


def _lenient_decompress(comp: bytes, max_size: int) -> bytes:
    """Decompress when the exact decoded size is unknown (bounded above)."""
    # untrusted-count guard (mirrors lz4.fast_decompress): the bound derives
    # from a header count; cap it by the physical 255x LZ4 expansion limit
    # so corrupt counts cannot drive huge allocations
    max_size = min(max_size, len(comp) * 256 + 4096)
    n_chunks = comp[0]
    if n_chunks == 0:
        try:
            from strelka_tpu_torch.native import native_lz4_decompress_lenient

            out = native_lz4_decompress_lenient(comp[1:], max_size)
            if out is not None:
                return out
        except ImportError:
            pass
    if n_chunks != 0:
        raise ValueError("multi-chunk int-compression unsupported (file > 2GB)")
    # decode without the exact-size assertion
    src = comp[1:]
    dst = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        dst += src[i : i + lit]
        i += lit
        if i >= n:
            break
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        ml = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                b = src[i]
                i += 1
                ml += b
                if b != 255:
                    break
        start = len(dst) - offset
        if offset >= ml:
            dst += dst[start : start + ml]
        else:
            for k in range(ml):
                dst.append(dst[start + k])
    return bytes(dst)


def _write_compressed_ints(w: "_Writer", values, wide: bool = False) -> None:
    blob = fast_compress(_encode_ints(values, wide))
    w.u64(len(blob))
    w.write(blob)


# ---------------------------------------------------------------------------
# Low-level IO
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("crate: truncated read")
        self.pos += n
        return b

    def u64(self) -> int:
        return struct.unpack("<Q", self.read(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self.read(8))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.read(4))[0]


class _Writer:
    def __init__(self):
        self.buf = bytearray()

    def write(self, b: bytes) -> None:
        self.buf += b

    def u64(self, v: int) -> None:
        self.buf += struct.pack("<Q", v)

    def i64(self, v: int) -> None:
        self.buf += struct.pack("<q", v)

    def u32(self, v: int) -> None:
        self.buf += struct.pack("<I", v)

    @property
    def pos(self) -> int:
        return len(self.buf)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


@dataclass
class _Spec:
    path_index: int
    fieldset_index: int
    spec_type: int


class CrateFile:
    """Parsed crate container: tokens, paths, specs, field values."""

    def __init__(self, data: bytes, name: str = "<usdc>"):
        self.data = data
        self.name = name
        self.tokens: List[str] = []
        self.strings: List[int] = []
        self.fields: List[Tuple[int, int]] = []  # (tokenIndex, rep)
        self.fieldsets: np.ndarray = np.zeros(0, np.int64)
        self.paths: Dict[int, str] = {}
        self.specs: List[_Spec] = []
        self._parse()

    # -- container ---------------------------------------------------------
    def _parse(self) -> None:
        d = self.data
        if d[:8] != _MAGIC:
            raise ValueError(f"{self.name}: not a usdc file (bad magic)")
        ver = tuple(d[8:11])
        if ver[0] != 0 or ver[1] < 4:
            raise ValueError(f"{self.name}: unsupported crate version {ver} (need 0.4+)")
        self.version = ver
        (toc_offset,) = struct.unpack_from("<q", d, 16)
        r = _Reader(d, toc_offset)
        n_sections = r.i64()
        sections = {}
        for _ in range(n_sections):
            raw = r.read(16)
            sname = raw.split(b"\x00")[0].decode()
            start = r.i64()
            size = r.i64()
            sections[sname] = (start, size)
        self._sections = sections
        self._read_tokens(*sections["TOKENS"])
        if "STRINGS" in sections:
            self._read_strings(*sections["STRINGS"])
        self._read_fields(*sections["FIELDS"])
        self._read_fieldsets(*sections["FIELDSETS"])
        self._read_paths(*sections["PATHS"])
        self._read_specs(*sections["SPECS"])

    def _read_tokens(self, start: int, size: int) -> None:
        r = _Reader(self.data, start)
        n = r.u64()
        uncompressed = r.u64()
        compressed = r.u64()
        blob = fast_decompress(r.read(compressed), uncompressed)
        toks = blob.split(b"\x00")
        self.tokens = [t.decode("utf-8", "replace") for t in toks[:n]]
        if len(self.tokens) != n:
            raise ValueError(f"{self.name}: token count mismatch")

    def _read_strings(self, start: int, size: int) -> None:
        r = _Reader(self.data, start)
        n = r.u64()
        self.strings = list(np.frombuffer(r.read(4 * n), "<u4"))

    def _read_fields(self, start: int, size: int) -> None:
        r = _Reader(self.data, start)
        n = r.u64()
        token_idx = _read_compressed_ints_static(r, n)
        reps_size = r.u64()
        reps_blob = fast_decompress(r.read(reps_size), n * 8)
        reps = np.frombuffer(reps_blob, "<u8")
        self.fields = [(int(token_idx[i]), int(reps[i])) for i in range(n)]

    def _read_fieldsets(self, start: int, size: int) -> None:
        r = _Reader(self.data, start)
        n = r.u64()
        self.fieldsets = _read_compressed_ints_static(r, n)

    def _read_paths(self, start: int, size: int) -> None:
        r = _Reader(self.data, start)
        n_total = r.u64()  # total number of paths
        n = r.u64()  # number of encoded path entries
        path_indexes = _read_compressed_ints_static(r, n)
        elem_tok = _read_compressed_ints_static(r, n)
        jumps = _read_compressed_ints_static(r, n)
        paths: Dict[int, str] = {}
        # iterative reconstruction of pxr's recursive scheme:
        # stack of (entry_index, parent_path)
        stack = [(0, None)]
        while stack:
            cur, parent = stack.pop()
            while True:
                this = cur
                cur += 1
                pi = int(path_indexes[this])
                if parent is None:
                    parent_path = "/"
                    paths[pi] = "/"
                else:
                    ti = int(elem_tok[this])
                    is_prop = ti < 0
                    token = self.tokens[abs(ti)]
                    base = parent if parent != "/" else ""
                    if is_prop:
                        paths[pi] = base + "." + token
                    elif token.startswith("{"):
                        # variant-selection component: appended WITHOUT a
                        # separator (SdfPath "/Thing{set=sel}")
                        paths[pi] = base + token
                    else:
                        paths[pi] = base + "/" + token
                    parent_path = paths[pi]
                jump = int(jumps[this])
                has_child = jump > 0 or jump == -1
                has_sibling = jump >= 0
                if has_child:
                    if has_sibling:
                        stack.append((this + jump, parent))
                    parent = parent_path  # descend: next record is the child
                elif has_sibling:
                    pass  # next record is the sibling, same parent
                else:
                    break  # leaf, no sibling: unwind
        self.paths = paths

    def _read_specs(self, start: int, size: int) -> None:
        r = _Reader(self.data, start)
        n = r.u64()
        pi = _read_compressed_ints_static(r, n)
        fsi = _read_compressed_ints_static(r, n)
        st = _read_compressed_ints_static(r, n)
        self.specs = [_Spec(int(pi[i]), int(fsi[i]), int(st[i])) for i in range(n)]

    # -- values ------------------------------------------------------------
    def fields_of(self, fieldset_index: int) -> Dict[str, int]:
        """fieldset -> {field name: rep} (sets are ~0-terminated runs)."""
        out = {}
        i = fieldset_index
        fs = self.fieldsets
        while i < len(fs) and fs[i] != 0xFFFFFFFF and int(fs[i]) != -1:
            tok_i, rep = self.fields[int(fs[i])]
            out[self.tokens[tok_i]] = rep
            i += 1
        return out

    def unpack(self, rep: int):
        """ValueRep -> python value (None for unsupported types)."""
        vtype = (rep >> 48) & 0xFF
        is_array = bool(rep & _ARRAY_BIT)
        inlined = bool(rep & _INLINED_BIT)
        compressed = bool(rep & _COMPRESSED_BIT)
        payload = rep & _PAYLOAD_MASK
        try:
            return self._unpack(vtype, is_array, inlined, compressed, payload)
        except Exception as e:  # noqa: BLE001 — robust ingestion
            log.warning("{}: failed to unpack value type {}: {}", self.name, vtype, e)
            return None

    def _unpack(self, vtype, is_array, inlined, compressed, payload):
        if vtype == T_VALUE_BLOCK:
            return None
        if is_array:
            return self._unpack_array(vtype, compressed, payload)
        if vtype == T_TOKEN:
            return self.tokens[payload] if inlined else self._read_scalar_at(vtype, payload)
        if vtype == T_STRING:
            return self.tokens[self.strings[payload]]
        if vtype == T_ASSET:
            return ("__asset__", self.tokens[payload])
        if vtype == T_BOOL:
            return bool(payload & 1)
        if vtype == T_SPECIFIER:
            return _SPECIFIERS[payload] if payload < 3 else "def"
        if vtype == T_PERMISSION or vtype == T_VARIABILITY:
            return int(payload)
        if vtype == T_INT:
            return struct.unpack("<i", struct.pack("<I", payload & 0xFFFFFFFF))[0]
        if vtype in (T_UINT, T_UINT64):
            return int(payload) if inlined else self._read_scalar_at(vtype, payload)
        if vtype == T_INT64:
            if inlined:
                return struct.unpack("<i", struct.pack("<I", payload & 0xFFFFFFFF))[0]
            return self._read_scalar_at(vtype, payload)
        if vtype == T_HALF:
            return float(np.frombuffer(struct.pack("<H", payload & 0xFFFF), "<f2")[0])
        if vtype == T_FLOAT:
            if inlined:
                return float(np.frombuffer(struct.pack("<I", payload & 0xFFFFFFFF), "<f4")[0])
            return self._read_scalar_at(vtype, payload)
        if vtype == T_DOUBLE:
            if inlined:
                # doubles that fit a float are inlined as float bits
                return float(np.frombuffer(struct.pack("<I", payload & 0xFFFFFFFF), "<f4")[0])
            return self._read_scalar_at(vtype, payload)
        if vtype in _SCALAR_FMT:
            if inlined:
                return self._unpack_inlined_vec(vtype, payload)
            return self._read_scalar_at(vtype, payload)
        if vtype == T_TOKEN_VECTOR:
            r = _Reader(self.data, payload)
            n = r.u64()
            idx = np.frombuffer(r.read(4 * n), "<u4")
            return [self.tokens[i] for i in idx]
        if vtype == T_PATH_VECTOR:
            r = _Reader(self.data, payload)
            n = r.u64()
            idx = np.frombuffer(r.read(4 * n), "<u4")
            return [("__path__", self.paths.get(int(i), "")) for i in idx]
        if vtype == T_PATH_LIST_OP:
            return self._unpack_path_list_op(payload)
        if vtype == T_TOKEN_LIST_OP:
            return self._unpack_token_list_op(payload)
        if vtype == T_DICTIONARY:
            return self._unpack_dictionary(payload)
        if vtype == T_VARIANT_SELECTION_MAP:
            return self._unpack_variant_selection_map(payload)
        if vtype == T_TIME_SAMPLES:
            return self._unpack_time_samples(payload)
        log.debug("{}: unsupported crate value type {}", self.name, vtype)
        return None

    def _unpack_dictionary(self, payload):
        """Dictionary-typed metadata (customData etc.).

        Layout: [u64 count] then per entry [u32 string-index key]
        [i64 skip = bytes of the value block] [u64 ValueRep ...]. The skip
        field makes unknown value encodings recoverable (pxr's recursive
        offset serves the same purpose); with no pxr at hand the
        byte layout is pinned by the independent-encoder fixture
        (tests/test_crate_fixture.py), not cross-validated against pxr."""
        r = _Reader(self.data, payload)
        n = r.u64()
        if n > (len(self.data) - r.pos) // 20:  # each entry >= 20 bytes
            raise ValueError(f"{self.name}: dictionary count {n} exceeds file size")
        out = {}
        for _ in range(n):
            key = self.tokens[self.strings[r.u32()]]
            skip = r.i64()
            if skip < 8 or r.pos + skip > len(self.data):
                raise ValueError(f"{self.name}: bad dictionary entry skip {skip}")
            end = r.pos + skip
            out[key] = self.unpack(r.u64())
            r.pos = end
        return out

    def _unpack_variant_selection_map(self, payload):
        """VariantSelectionMap: [u64 count] + per entry two u32 string
        indices (variantSet name, selected variant name)."""
        r = _Reader(self.data, payload)
        n = r.u64()
        if n > (len(self.data) - r.pos) // 8:
            raise ValueError(f"{self.name}: variant map count {n} exceeds file size")
        out = {}
        for _ in range(n):
            k = self.tokens[self.strings[r.u32()]]
            out[k] = self.tokens[self.strings[r.u32()]]
        return out

    def _unpack_time_samples(self, payload):
        """TimeSamples layout (crateFile.cpp _ReadTimeSamples, v0.8):
        payload -> [ValueRep timesRep][ValueRep values[N]] where N is the
        length of the times array (no count prefix; pxr records
        valuesFileOffset = tell() after reading timesRep and later reads N
        contiguous reps). Returns ("__timeSamples__", [times], [values])."""
        r = _Reader(self.data, payload)
        times_rep = r.u64()
        times = self.unpack(times_rep)
        if not isinstance(times, (list, tuple, np.ndarray)):
            return None
        times = [float(t) for t in np.asarray(times).reshape(-1)]
        values = []
        for _ in times:
            values.append(self.unpack(r.u64()))
        return ("__timeSamples__", times, values)

    def _read_scalar_at(self, vtype, offset):
        fmt, k = _SCALAR_FMT[vtype]
        item = np.dtype(fmt).itemsize
        arr = np.frombuffer(self.data[offset : offset + item * k], fmt).astype(np.float64 if fmt[1] == "f" else np.int64)
        if vtype == T_TOKEN:
            return self.tokens[int(arr[0])]
        if k == 1:
            v = arr[0]
            return float(v) if fmt[1] == "f" else int(v)
        if vtype == T_MATRIX4D:
            return [tuple(row) for row in arr.reshape(4, 4)]
        if vtype == T_MATRIX3D:
            return [tuple(row) for row in arr.reshape(3, 3)]
        return tuple(float(x) if fmt[1] == "f" else int(x) for x in arr)

    def _unpack_inlined_vec(self, vtype, payload):
        fmt, k = _SCALAR_FMT[vtype]
        # vectors inline when every component fits int8; matrices inline the
        # diagonal the same way (crateFile.cpp _IsInlined routines)
        b = struct.pack("<Q", payload)
        comps = struct.unpack_from(f"<{min(k,8)}b", b, 0)
        if vtype in (T_MATRIX2D, T_MATRIX3D, T_MATRIX4D):
            dim = {T_MATRIX2D: 2, T_MATRIX3D: 3, T_MATRIX4D: 4}[vtype]
            m = np.zeros((dim, dim))
            for i in range(dim):
                m[i, i] = comps[i]
            return [tuple(row) for row in m]
        vals = comps[:k]
        if fmt[1] == "f":
            return tuple(float(v) for v in vals)
        return tuple(int(v) for v in vals)

    def _unpack_array(self, vtype, compressed, payload):
        r = _Reader(self.data, payload)
        if self.version >= (0, 7, 0):
            n = r.u64()
        else:
            n = r.u32()
        if n == 0:
            return []
        if vtype == T_TOKEN:
            idx = np.frombuffer(r.read(4 * n), "<u4")
            return [self.tokens[i] for i in idx]
        if vtype == T_STRING:
            idx = np.frombuffer(r.read(4 * n), "<u4")
            return [self.tokens[self.strings[i]] for i in idx]
        if vtype == T_ASSET:
            idx = np.frombuffer(r.read(4 * n), "<u4")
            return [("__asset__", self.tokens[i]) for i in idx]
        if vtype not in _SCALAR_FMT:
            log.debug("{}: unsupported crate array type {}", self.name, vtype)
            return None
        fmt, k = _SCALAR_FMT[vtype]
        if compressed:
            if vtype in (T_INT, T_UINT):
                vals = _read_compressed_ints_static(r, n * k)
                arr = np.asarray(vals, np.int64).astype(fmt)
            elif vtype in (T_INT64, T_UINT64):
                vals = _read_compressed_ints_static(r, n * k, wide=True)
                arr = np.asarray(vals, np.int64).astype(fmt)
            elif vtype in (T_FLOAT, T_DOUBLE, T_HALF):
                arr = self._read_compressed_floats(r, n * k, fmt)
            else:
                raise ValueError(f"compressed array of type {vtype}")
        else:
            arr = np.frombuffer(r.read(np.dtype(fmt).itemsize * n * k), fmt)
        arr = arr.astype(np.float64 if fmt[1] == "f" else np.int64)
        if vtype in (T_MATRIX4D, T_MATRIX3D, T_MATRIX2D):
            dim = {T_MATRIX2D: 2, T_MATRIX3D: 3, T_MATRIX4D: 4}[vtype]
            return [[tuple(row) for row in m.reshape(dim, dim)] for m in arr.reshape(n, dim * dim)]
        if k == 1:
            return [float(v) if fmt[1] == "f" else int(v) for v in arr]
        return [tuple(v) for v in arr.reshape(n, k)]

    def _read_compressed_floats(self, r: "_Reader", n: int, fmt: str) -> np.ndarray:
        code = r.read(1)
        if code == b"i":
            vals = _read_compressed_ints_static(r, n)
            return np.asarray(vals, np.int64).astype(fmt)
        if code == b"t":
            lut_n = r.u32()
            lut = np.frombuffer(r.read(np.dtype(fmt).itemsize * lut_n), fmt)
            idx = _read_compressed_ints_static(r, n)
            return lut[np.asarray(idx, np.int64)]
        raise ValueError(f"unknown float-compression code {code!r}")

    def _unpack_path_list_op(self, offset):
        r = _Reader(self.data, offset)
        h = r.read(1)[0]
        items: List[Tuple[str, str]] = []
        # bits: 1=explicit flag, 2=explicit items, 4=added, 8=prepended,
        # 16=appended, 32=deleted, 64=ordered
        for bit in (2, 4, 8, 16, 32, 64):
            if h & bit:
                n = r.u64()
                idx = np.frombuffer(r.read(4 * n), "<u4")
                lst = [("__path__", self.paths.get(int(i), "")) for i in idx]
                if bit in (2, 4, 8, 16):
                    items.extend(lst)
        return items

    def _unpack_token_list_op(self, offset):
        r = _Reader(self.data, offset)
        h = r.read(1)[0]
        items: List[str] = []
        for bit in (2, 4, 8, 16, 32, 64):
            if h & bit:
                n = r.u64()
                idx = np.frombuffer(r.read(4 * n), "<u4")
                if bit in (2, 4, 8, 16):
                    items.extend(self.tokens[int(i)] for i in idx)
        return items


def _read_compressed_ints_static(r: _Reader, n: int, wide: bool = False) -> np.ndarray:
    return _read_compressed_ints(r, n, wide)


# ---------------------------------------------------------------------------
# Crate -> pseudo-stage (usda_parser.Prim tree)
# ---------------------------------------------------------------------------


_VARIANT_COMPONENT = re.compile(r"^(.*)\{([^{}=]+)=([^{}]*)\}$")


def crate_to_stage(cf: CrateFile) -> Prim:
    root = Prim(type="PseudoRoot", name="", path="/")
    prims: Dict[str, Prim] = {"/": root}
    # pass 1: prim + variant specs (ordered so parents precede children —
    # enforce by component-depth sort; "{set=sel}" counts as a component)
    prim_specs = [s for s in cf.specs if s.spec_type in (SPEC_PRIM, SPEC_VARIANT)]
    prim_specs.sort(
        key=lambda s: (lambda p: p.count("/") + p.count("{"))(cf.paths.get(s.path_index, ""))
    )
    for s in prim_specs:
        path = cf.paths.get(s.path_index)
        if not path or path == "/":
            continue
        fields = cf.fields_of(s.fieldset_index)
        p = Prim(name=path.rsplit("/", 1)[-1], path=path)
        if "typeName" in fields:
            tn = cf.unpack(fields["typeName"])
            p.type = tn if isinstance(tn, str) else ""
        if "specifier" in fields:
            sp = cf.unpack(fields["specifier"])
            p.specifier = sp if isinstance(sp, str) else "def"
        for fname, rep in fields.items():
            if fname in ("typeName", "specifier", "primChildren", "properties"):
                continue
            val = cf.unpack(rep)
            if val is not None:
                p.metadata[fname] = val
        var = _VARIANT_COMPONENT.match(path)
        if var is not None and s.spec_type == SPEC_VARIANT:
            owner_path, set_name, sel = var.groups()
            owner = prims.get(owner_path)
            if owner is not None:
                p.name = ""
                owner.variant_sets.setdefault(set_name, {})[sel] = p
                prims[path] = p
            continue
        parent = path.rsplit("/", 1)[0] or "/"
        parent_prim = prims.get(parent)
        if parent_prim is None:
            parent_prim = root  # orphan: attach at root
        parent_prim.children.append(p)
        prims[path] = p
    # pseudo-root metadata
    for s in cf.specs:
        if s.spec_type == SPEC_PSEUDO_ROOT:
            for fname, rep in cf.fields_of(s.fieldset_index).items():
                val = cf.unpack(rep)
                if val is not None:
                    root.metadata[fname] = val
    # pass 2: attribute + relationship specs
    for s in cf.specs:
        if s.spec_type not in (SPEC_ATTRIBUTE, SPEC_RELATIONSHIP):
            continue
        path = cf.paths.get(s.path_index, "")
        if "." not in path:
            continue
        prim_path, attr_name = path.rsplit(".", 1)
        prim = prims.get(prim_path or "/")
        if prim is None:
            continue
        fields = cf.fields_of(s.fieldset_index)
        attr = prim.attrs.get(attr_name)
        if attr is None:
            attr = Attr()
            prim.attrs[attr_name] = attr
        if s.spec_type == SPEC_RELATIONSHIP:
            tp = fields.get("targetPaths")
            if tp is not None:
                val = cf.unpack(tp)
                if isinstance(val, list):
                    attr.targets = [v[1] for v in val if isinstance(v, tuple) and v[0] == "__path__"]
            attr.type_str = "rel"
            continue
        if "typeName" in fields:
            tn = cf.unpack(fields["typeName"])
            if isinstance(tn, str):
                attr.type_str = tn
        if "variability" in fields:
            attr.uniform = cf.unpack(fields["variability"]) == 1
        if "default" in fields:
            attr.value = cf.unpack(fields["default"])
        if "timeSamples" in fields:
            ts = cf.unpack(fields["timeSamples"])
            if isinstance(ts, tuple) and len(ts) == 3 and ts[0] == "__timeSamples__":
                attr.time_samples = (ts[1], ts[2])
                if attr.value is None and ts[2]:
                    # static-render semantics: first sample (usda parity)
                    attr.value = ts[2][0]
        if "connectionPaths" in fields:
            val = cf.unpack(fields["connectionPaths"])
            if isinstance(val, list) and val:
                first = val[0]
                if isinstance(first, tuple) and first[0] == "__path__":
                    attr.connect = first[1]
        if "interpolation" in fields:
            iv = cf.unpack(fields["interpolation"])
            if isinstance(iv, str):
                prim.attrs[attr_name + ":__interp__"] = Attr(value=iv)
    resolve_variants(root)
    return root


def read_usdc(path: str) -> Prim:
    """Open a .usdc file -> pseudo-stage Prim tree (same shape as parse_usda).

    Corrupt/truncated files raise ValueError (low-level decode errors are
    converted so callers need only one failure path)."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        cf = CrateFile(data, name=path)
        return crate_to_stage(cf)
    except ValueError:
        raise
    except (struct.error, IndexError, KeyError, EOFError, OverflowError) as e:
        raise ValueError(f"{path}: corrupt usdc file ({e})") from e


# ---------------------------------------------------------------------------
# Writer (flattened stages; round-trip fixture generator + exporter)
# ---------------------------------------------------------------------------


class _CrateWriter:
    def __init__(self):
        # Reserve the empty string as token 0 (pxr does the same): property
        # path elements are encoded as NEGATED token indices, and -0 == 0
        # would make a property at token 0 indistinguishable from a prim
        # child.
        self.tokens: List[str] = [""]
        self._tok_idx: Dict[str, int] = {"": 0}
        self.strings: List[int] = []  # STRINGS section: token indexes
        self._str_idx: Dict[str, int] = {}
        self.fields: List[Tuple[int, int]] = []
        self._field_idx: Dict[Tuple[int, int], int] = {}
        self.fieldsets: List[int] = []
        self.paths: Dict[str, int] = {}
        self.specs: List[_Spec] = []
        self.body = _Writer()  # value payload area (offsets are file-absolute)
        self.body_base = 88  # bootstrap size; payloads start right after

    # -- interning ----------------------------------------------------------
    def token(self, s: str) -> int:
        i = self._tok_idx.get(s)
        if i is None:
            i = len(self.tokens)
            self.tokens.append(s)
            self._tok_idx[s] = i
        return i

    def string(self, s: str) -> int:
        i = self._str_idx.get(s)
        if i is None:
            i = len(self.strings)
            self.strings.append(self.token(s))
            self._str_idx[s] = i
        return i

    def field(self, name: str, rep: int) -> int:
        key = (self.token(name), rep)
        i = self._field_idx.get(key)
        if i is None:
            i = len(self.fields)
            self.fields.append(key)
            self._field_idx[key] = i
        return i

    def fieldset(self, field_indices: List[int]) -> int:
        start = len(self.fieldsets)
        self.fieldsets.extend(field_indices)
        self.fieldsets.append(0xFFFFFFFF)
        return start

    def path_index(self, path: str) -> int:
        i = self.paths.get(path)
        if i is None:
            i = len(self.paths)
            self.paths[path] = i
        return i

    # -- value packing -------------------------------------------------------
    def _offset(self) -> int:
        return self.body_base + self.body.pos

    def rep_token(self, s: str) -> int:
        return (T_TOKEN << 48) | _INLINED_BIT | self.token(s)

    def rep_specifier(self, s: str) -> int:
        return (T_SPECIFIER << 48) | _INLINED_BIT | _SPECIFIERS.index(s if s in _SPECIFIERS else "def")

    def rep_variability(self, uniform: bool) -> int:
        return (T_VARIABILITY << 48) | _INLINED_BIT | (1 if uniform else 0)

    def rep_bool(self, v: bool) -> int:
        return (T_BOOL << 48) | _INLINED_BIT | (1 if v else 0)

    def rep_int(self, v: int) -> int:
        return (T_INT << 48) | _INLINED_BIT | (v & 0xFFFFFFFF)

    def rep_float(self, v: float) -> int:
        bits = struct.unpack("<I", struct.pack("<f", v))[0]
        return (T_FLOAT << 48) | _INLINED_BIT | bits

    def rep_double(self, v: float) -> int:
        f = struct.unpack("<f", struct.pack("<f", v))[0]
        if f == v:
            bits = struct.unpack("<I", struct.pack("<f", v))[0]
            return (T_DOUBLE << 48) | _INLINED_BIT | bits
        off = self._offset()
        self.body.write(struct.pack("<d", v))
        return (T_DOUBLE << 48) | off

    def rep_asset(self, s: str) -> int:
        return (T_ASSET << 48) | _INLINED_BIT | self.token(s)

    def rep_vec(self, vtype: int, vals) -> int:
        fmt, k = _SCALAR_FMT[vtype]
        vals = list(vals)
        ints = all(float(v).is_integer() and -128 <= v < 128 for v in vals)
        if ints and k <= 8:
            payload = struct.unpack("<Q", struct.pack("<8b", *([int(v) for v in vals] + [0] * (8 - k))))[0]
            return (vtype << 48) | _INLINED_BIT | (payload & _PAYLOAD_MASK)
        off = self._offset()
        self.body.write(np.asarray(vals, fmt).tobytes())
        return (vtype << 48) | off

    def rep_matrix4d(self, rows) -> int:
        m = np.asarray(rows, "<f8").reshape(4, 4)
        diag = np.diag(m)
        if np.allclose(m, np.diag(diag)) and all(float(v).is_integer() and -128 <= v < 128 for v in diag):
            payload = struct.unpack("<Q", struct.pack("<8b", *([int(v) for v in diag] + [0] * 4)))[0]
            return (T_MATRIX4D << 48) | _INLINED_BIT | (payload & _PAYLOAD_MASK)
        off = self._offset()
        self.body.write(m.tobytes())
        return (T_MATRIX4D << 48) | off

    def rep_array(self, vtype: int, arr) -> int:
        fmt, k = _SCALAR_FMT[vtype]
        a = np.asarray(arr, fmt).reshape(-1, k) if k > 1 else np.asarray(arr, fmt).reshape(-1)
        n = a.shape[0]
        off = self._offset()
        self.body.u64(n)
        self.body.write(np.ascontiguousarray(a).tobytes())
        return (vtype << 48) | _ARRAY_BIT | off

    def rep_token_array(self, toks: List[str]) -> int:
        off = self._offset()
        self.body.u64(len(toks))
        self.body.write(np.asarray([self.token(t) for t in toks], "<u4").tobytes())
        return (T_TOKEN << 48) | _ARRAY_BIT | off

    def rep_token_vector(self, toks: List[str]) -> int:
        off = self._offset()
        self.body.u64(len(toks))
        self.body.write(np.asarray([self.token(t) for t in toks], "<u4").tobytes())
        return (T_TOKEN_VECTOR << 48) | off

    def rep_time_samples(self, times: List[float], value_reps: List[int]) -> int:
        """Pack animation samples (mirrors _unpack_time_samples layout)."""
        times_rep = self.rep_array(T_DOUBLE, [float(t) for t in times])
        off = self._offset()
        self.body.u64(times_rep)
        for vr in value_reps:
            self.body.u64(vr)
        return (T_TIME_SAMPLES << 48) | off

    def rep_path_list_op(self, paths: List[str]) -> int:
        off = self._offset()
        self.body.write(bytes([2]))  # HasExplicitItems
        self.body.u64(len(paths))
        self.body.write(np.asarray([self.path_index(p) for p in paths], "<u4").tobytes())
        return (T_PATH_LIST_OP << 48) | off

    def rep_string(self, s: str) -> int:
        return (T_STRING << 48) | _INLINED_BIT | self.string(s)

    def rep_meta_value(self, v) -> Optional[int]:
        """Best-effort ValueRep for a python metadata value (dictionaries)."""
        if isinstance(v, bool):
            return self.rep_bool(v)
        if isinstance(v, int):
            return self.rep_int(v)
        if isinstance(v, float):
            return self.rep_double(v)
        if isinstance(v, str):
            return self.rep_string(v)
        if isinstance(v, dict):
            return self.rep_dictionary(v)
        if isinstance(v, (list, tuple, np.ndarray)):
            try:
                return self.rep_array(T_DOUBLE, [float(x) for x in np.asarray(v).reshape(-1)])
            except (TypeError, ValueError):
                return None
        return None

    def rep_dictionary(self, d: dict) -> int:
        """Mirror of CrateFile._unpack_dictionary's layout (values packed
        out-of-line first; each entry's inline block is one 8-byte rep)."""
        entries = []
        for k, v in d.items():
            rep = self.rep_meta_value(v)
            if rep is not None:
                entries.append((self.string(str(k)), rep))
        off = self._offset()
        self.body.u64(len(entries))
        for si, rep in entries:
            self.body.u32(si)
            self.body.i64(8)
            self.body.u64(rep)
        return (T_DICTIONARY << 48) | off

    def rep_variant_selection_map(self, d: dict) -> int:
        off = self._offset()
        self.body.u64(len(d))
        for k, v in sorted(d.items()):
            self.body.u32(self.string(str(k)))
            self.body.u32(self.string(str(v)))
        return (T_VARIANT_SELECTION_MAP << 48) | off


def _value_rep(w: _CrateWriter, type_str: str, value) -> Optional[int]:
    """Map a usda-parser (type_str, value) pair to a crate ValueRep."""
    is_array = type_str.endswith("[]")
    base = type_str[:-2] if is_array else type_str
    vec_types = {
        "float2": T_VEC2F, "texCoord2f": T_VEC2F, "float3": T_VEC3F,
        "color3f": T_VEC3F, "normal3f": T_VEC3F, "point3f": T_VEC3F,
        "vector3f": T_VEC3F, "float4": T_VEC4F, "color4f": T_VEC4F,
        "double2": T_VEC2D, "double3": T_VEC3D, "double4": T_VEC4D,
        "int2": T_VEC2I, "int3": T_VEC3I, "int4": T_VEC4I,
        "quatf": T_QUATF, "quatd": T_QUATD,
    }
    if is_array:
        if value is None:
            value = []
        if base == "token" or base == "string":
            return w.rep_token_array([str(v) for v in value])
        if base == "int":
            return w.rep_array(T_INT, [int(v) for v in value])
        if base in ("float", "half"):
            return w.rep_array(T_FLOAT, [float(v) for v in value])
        if base == "double":
            return w.rep_array(T_DOUBLE, [float(v) for v in value])
        if base in vec_types:
            return w.rep_array(vec_types[base], value)
        if base in ("matrix4d", "float4x4"):
            return w.rep_array(T_MATRIX4D, [np.asarray(m).reshape(16) for m in value])
        return None
    if base == "token" or base == "string":
        return w.rep_token(str(value))
    if base == "asset":
        v = value[1] if isinstance(value, tuple) and value and value[0] == "__asset__" else str(value)
        return w.rep_asset(v)
    if base == "bool":
        return w.rep_bool(bool(value))
    if base == "int":
        return w.rep_int(int(value))
    if base in ("float", "half"):
        return w.rep_float(float(value))
    if base == "double":
        return w.rep_double(float(value))
    if base in vec_types:
        return w.rep_vec(vec_types[base], value)
    if base in ("matrix4d", "float4x4"):
        return w.rep_matrix4d(value)
    return None


def write_usdc(path: str, root: Prim) -> None:
    """Write a pseudo-stage (usda_parser.Prim tree) as a crate file."""
    w = _CrateWriter()
    w.path_index("/")
    specs: List[_Spec] = []

    # pseudo-root spec (carries stage metadata: defaultPrim etc.)
    top_names = [c.name for c in root.children]
    fs = [w.field("primChildren", w.rep_token_vector(top_names))]
    for k, v in root.metadata.items():
        if isinstance(v, str):
            fs.append(w.field(k, w.rep_token(v)))
        elif isinstance(v, dict):
            fs.append(w.field(k, w.rep_dictionary(v)))
    specs.append(_Spec(w.path_index("/"), w.fieldset(fs), SPEC_PSEUDO_ROOT))

    def visit(prim: Prim, path: str, spec_type: int = SPEC_PRIM):
        pi = w.path_index(path)
        fs = [
            w.field("specifier", w.rep_specifier(prim.specifier)),
        ]
        if prim.type:
            fs.append(w.field("typeName", w.rep_token(prim.type)))
        if prim.children:
            fs.append(w.field("primChildren", w.rep_token_vector([c.name for c in prim.children])))
        props = [n for n in prim.attrs if not n.endswith(":__interp__")]
        if props:
            fs.append(w.field("properties", w.rep_token_vector(props)))
        sel_map = prim.metadata.get("variants") or prim.metadata.get("variantSelection")
        if isinstance(sel_map, dict) and sel_map:
            fs.append(w.field("variantSelection", w.rep_variant_selection_map(sel_map)))
        if prim.variant_sets:
            fs.append(
                w.field("variantSetNames", w.rep_token_vector(sorted(prim.variant_sets)))
            )
        for k, v in prim.metadata.items():
            if k in ("variants", "variantSelection", "variantSetNames"):
                continue
            if isinstance(v, dict):
                fs.append(w.field(k, w.rep_dictionary(v)))
        specs.append(_Spec(pi, w.fieldset(fs), spec_type))
        for set_name, variants in sorted(prim.variant_sets.items()):
            # the variantSet container spec ("/Thing{set=}") then one
            # SPEC_VARIANT subtree per authored variant
            specs.append(
                _Spec(w.path_index(f"{path}{{{set_name}=}}"), w.fieldset([]), SPEC_VARIANT_SET)
            )
            for sel, content in sorted(variants.items()):
                visit(content, f"{path}{{{set_name}={sel}}}", spec_type=SPEC_VARIANT)
        for name, attr in prim.attrs.items():
            if name.endswith(":__interp__"):
                continue
            apath = path + "." + name
            api = w.path_index(apath)
            afs = []
            if attr.type_str == "rel" or attr.targets:
                if attr.targets:
                    afs.append(w.field("targetPaths", w.rep_path_list_op(attr.targets)))
                specs.append(_Spec(api, w.fieldset(afs), SPEC_RELATIONSHIP))
                continue
            if attr.type_str:
                afs.append(w.field("typeName", w.rep_token(attr.type_str)))
            if attr.uniform:
                afs.append(w.field("variability", w.rep_variability(True)))
            if attr.value is not None:
                rep = _value_rep(w, attr.type_str, attr.value)
                if rep is not None:
                    afs.append(w.field("default", rep))
            if attr.time_samples is not None:
                times, samples = attr.time_samples
                vreps = [_value_rep(w, attr.type_str, v) for v in samples]
                if len(times) == len(samples) and all(r is not None for r in vreps):
                    afs.append(w.field("timeSamples", w.rep_time_samples(times, vreps)))
            if attr.connect:
                afs.append(w.field("connectionPaths", w.rep_path_list_op([attr.connect])))
            interp = prim.attrs.get(name + ":__interp__")
            if interp is not None and interp.value:
                afs.append(w.field("interpolation", w.rep_token(str(interp.value))))
            specs.append(_Spec(api, w.fieldset(afs), SPEC_ATTRIBUTE))
        # prims inside a variant are ordinary prim specs; only the variant
        # root path ("/Thing{set=sel}") carries SPEC_VARIANT
        for c in prim.children:
            visit(c, path + "/" + c.name)

    for c in root.children:
        visit(c, "/" + c.name)

    # ---- encode the path tree (pathIndexes / elementTokenIndexes / jumps).
    # Build the path forest from all interned paths.
    children: Dict[str, List[str]] = {}
    for p in w.paths:
        if p == "/":
            continue
        last = p.rsplit("/", 1)[-1]
        if "." in last:
            parent = p.rsplit(".", 1)[0]
        elif last.endswith("}") and "{" in last:
            # variant component "{set=sel}": parent is the owner prim path
            parent = p[: p.rindex("{")]
        else:
            parent = p.rsplit("/", 1)[0] or "/"
        children.setdefault(parent, []).append(p)

    path_indexes: List[int] = []
    elem_tokens: List[int] = []
    jumps: List[int] = []

    def encode(path: str, has_sibling: bool) -> None:
        idx = len(path_indexes)
        path_indexes.append(w.paths[path])
        if path == "/":
            elem_tokens.append(0)
        else:
            last = path.rsplit("/", 1)[-1]
            if "." in last:
                token = path.rsplit(".", 1)[-1]
                elem_tokens.append(-w.token(token))
            elif last.endswith("}") and "{" in last:
                # variant component: the element token is the full "{set=sel}"
                token = path[path.rindex("{"):]
                elem_tokens.append(w.token(token))
            else:
                elem_tokens.append(w.token(last))
        kids = children.get(path, [])
        has_child = bool(kids)
        jumps.append(0)  # patched below
        if has_child:
            for i, k in enumerate(kids):
                encode(k, has_sibling=(i + 1 < len(kids)))
        # patch jump
        if has_child and has_sibling:
            jumps[idx] = len(path_indexes) - idx  # sibling follows subtree
        elif has_child:
            jumps[idx] = -1
        elif has_sibling:
            jumps[idx] = 0
        else:
            jumps[idx] = -2

    encode("/", has_sibling=False)

    # ---- assemble sections
    out = _Writer()
    out.write(_MAGIC)
    out.write(bytes(_VERSION) + b"\x00" * 5)
    toc_pos_field = out.pos
    out.i64(0)  # toc offset placeholder
    out.write(b"\x00" * (88 - out.pos))
    out.write(bytes(w.body.buf))  # value payload area

    sections = []

    def begin(name: str) -> int:
        return out.pos

    # TOKENS
    start = begin("TOKENS")
    blob = b"\x00".join(t.encode() for t in w.tokens) + b"\x00"
    comp = fast_compress(blob)
    out.u64(len(w.tokens))
    out.u64(len(blob))
    out.u64(len(comp))
    out.write(comp)
    sections.append(("TOKENS", start, out.pos - start))

    # STRINGS (token indexes; we intern strings as tokens)
    start = begin("STRINGS")
    out.u64(len(w.strings))
    if w.strings:
        out.write(np.asarray(w.strings, "<u4").tobytes())
    sections.append(("STRINGS", start, out.pos - start))

    # FIELDS
    start = begin("FIELDS")
    out.u64(len(w.fields))
    _write_compressed_ints_out(out, [f[0] for f in w.fields])
    reps = np.asarray([f[1] for f in w.fields], "<u8").tobytes()
    comp = fast_compress(reps)
    out.u64(len(comp))
    out.write(comp)
    sections.append(("FIELDS", start, out.pos - start))

    # FIELDSETS
    start = begin("FIELDSETS")
    out.u64(len(w.fieldsets))
    _write_compressed_ints_out(out, w.fieldsets)
    sections.append(("FIELDSETS", start, out.pos - start))

    # PATHS
    start = begin("PATHS")
    out.u64(len(w.paths))
    out.u64(len(path_indexes))
    _write_compressed_ints_out(out, path_indexes)
    _write_compressed_ints_out(out, elem_tokens)
    _write_compressed_ints_out(out, jumps)
    sections.append(("PATHS", start, out.pos - start))

    # SPECS
    start = begin("SPECS")
    out.u64(len(specs))
    _write_compressed_ints_out(out, [s.path_index for s in specs])
    _write_compressed_ints_out(out, [s.fieldset_index for s in specs])
    _write_compressed_ints_out(out, [s.spec_type for s in specs])
    sections.append(("SPECS", start, out.pos - start))

    # TOC
    toc_offset = out.pos
    out.i64(len(sections))
    for name, s, size in sections:
        out.write(name.encode().ljust(16, b"\x00"))
        out.i64(s)
        out.i64(size)
    struct.pack_into("<q", out.buf, toc_pos_field, toc_offset)

    with open(path, "wb") as f:
        f.write(bytes(out.buf))


def _write_compressed_ints_out(out: _Writer, values, wide: bool = False) -> None:
    blob = fast_compress(_encode_ints(values, wide))
    out.u64(len(blob))
    out.write(blob)
