"""Frozen copies of the program's stage writers, for the benchmark's scene
builders that write a stage once and hand the file to both sides' loaders
(scenes/character.py).

* write_usdc: a flattened pseudo-stage (refport/loaders/usda_parser.py's
  Prim and Attr) as a binary USD crate, version 0.8.0, with pxr's
  TfFastCompression framing of LZ4 blocks: the program's
  strelka_tpu_torch/loaders/crate.py:write_usdc with its compressor
  (loaders/lz4.py:fast_compress), copied statement for statement.
* encode_png_as_pil: the bytes of an 8-bit RGB PNG as PIL writes them:
  the program's utils/image.py:encode_png_as_pil.

It imports numpy and the standard library only: nothing of the program and
nothing of jax. benchmark/test_bench_inputs.py holds the stage a builder
writes with it byte-equal to the one the program's generator writes.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np




# LZ4 block compression, pxr TfFastCompression framing (the program's loaders/lz4.py)

_MIN_MATCH = 4


_MAX_OFFSET = 65535


# pxr chunks inputs at LZ4_MAX_INPUT_SIZE (0x7E000000); our files are far
# smaller, but keep the framing general.
_LZ4_MAX_INPUT = 0x7E000000


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


# the crate writer (the program's loaders/crate.py)

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


T_PATH_LIST_OP = 34


T_TOKEN_VECTOR = 41


T_SPECIFIER = 42


T_VARIABILITY = 44


T_VARIANT_SELECTION_MAP = 45


T_TIME_SAMPLES = 46


_ARRAY_BIT = 1 << 63


_INLINED_BIT = 1 << 62


_PAYLOAD_MASK = (1 << 48) - 1


# SdfSpecType
SPEC_ATTRIBUTE = 1


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


@dataclass
class _Spec:
    path_index: int
    fieldset_index: int
    spec_type: int


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


# PNG as PIL writes it (the program's utils/image.py)

_PNG_SIG = b"\x89PNG\r\n\x1a\n"


def to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


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
