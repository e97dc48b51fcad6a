"""USD crate (.usdc) binary file reader, pure Python.

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

Scope: flattened stages (no sublayers/references/payloads), default values
(timeSamples resolve to nothing yet), the value types scene ingestion needs.
Unknown field values degrade to warnings, never errors.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from refport import log
from refport.loaders.lz4 import fast_decompress
from refport.loaders.usda_parser import Attr, Prim, resolve_variants

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
    return _decode_ints(buf, n, wide)


def _lenient_decompress(comp: bytes, max_size: int) -> bytes:
    """Decompress when the exact decoded size is unknown (bounded above)."""
    # untrusted-count guard (mirrors lz4.fast_decompress): the bound derives
    # from a header count; cap it by the physical 255x LZ4 expansion limit
    # so corrupt counts cannot drive huge allocations
    max_size = min(max_size, len(comp) * 256 + 4096)
    n_chunks = comp[0]
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
