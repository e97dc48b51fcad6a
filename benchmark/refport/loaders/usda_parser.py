"""Minimal USDA (text USD) parser.

The package does not depend on `pxr`; this parses the subset of flattened .usda that
the reference's Hydra delegate consumes (meshes, xforms, cameras, UsdLux
lights, UsdPreviewSurface material networks, basis curves). Binary .usdc is
out of scope (gate at the loader with a clear error).

Produces a tree of Prim objects:
  Prim(type, name, path, metadata, attrs {name: Attr}, children [Prim])
  Attr(type_str, value, connect_path, is_uniform)

Supported value syntax: scalars, quoted strings, tuples `( … )`, flat lists
`[ … ]`, lists of tuples, asset paths `@…@`, prim path targets `<…>`,
dictionaries (skipped), timeSamples blocks (first sample taken).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Attr:
    type_str: str = ""
    value: object = None
    connect: Optional[str] = None  # target path for .connect attrs
    targets: List[str] = field(default_factory=list)  # rel targets
    uniform: bool = False
    # full animation samples ([times], [values]) when authored; `value`
    # holds the first sample (static-render semantics, hdRunner SetTime(0))
    time_samples: Optional[tuple] = None


@dataclass
class Prim:
    type: str = ""
    name: str = ""
    path: str = ""
    specifier: str = "def"
    metadata: Dict[str, object] = field(default_factory=dict)
    attrs: Dict[str, Attr] = field(default_factory=dict)
    children: List["Prim"] = field(default_factory=list)
    # authored variant content: {set name: {variant name: content Prim}};
    # resolve_variants() grafts the selected variant and clears this
    variant_sets: Dict[str, Dict[str, "Prim"]] = field(default_factory=dict)

    def find(self, path: str) -> Optional["Prim"]:
        """Find a descendant by absolute path ('/World/Geo/mesh')."""
        parts = [p for p in path.strip("/").split("/") if p]
        prim = self
        for part in parts:
            nxt = None
            for c in prim.children:
                if c.name == part:
                    nxt = c
                    break
            if nxt is None:
                return None
            prim = nxt
        return prim

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()


def _rewrite_subtree_paths(prim: "Prim", old: str, new: str) -> None:
    if prim.path.startswith(old):
        prim.path = new + prim.path[len(old):]
    for a in prim.attrs.values():
        if a.connect and a.connect.startswith(old):
            a.connect = new + a.connect[len(old):]
        if a.targets:
            a.targets = [new + t[len(old):] if t.startswith(old) else t for t in a.targets]
    for c in prim.children:
        _rewrite_subtree_paths(c, old, new)


def resolve_variants(prim: "Prim") -> None:
    """Composite authored variants into the prim tree (LIVRPS 'V' step,
    local-over-variant): for every variant set pick the selection from the
    prim's `variants` / `variantSelection` metadata (first variant name in
    sorted order when unselected), graft the chosen content's attrs/metadata
    (weaker than local opinions) and children, then drop the raw sets.

    The reference opens arbitrary stages through pxr which composes variants
    natively (reference src/hdRunner/main.cpp:566-591)."""
    sel_map = prim.metadata.get("variants") or prim.metadata.get("variantSelection") or {}
    if not isinstance(sel_map, dict):
        sel_map = {}
    for set_name, variants in sorted(prim.variant_sets.items()):
        if not variants:
            continue
        sel = sel_map.get(set_name)
        if sel not in variants:
            sel = sorted(variants)[0]
        content = variants[sel]
        resolve_variants(content)  # nested variant sets inside the selection
        _rewrite_subtree_paths(content, f"{prim.path}{{{set_name}={sel}}}", prim.path)
        if content.type and not prim.type:
            prim.type = content.type
        for k, a in content.attrs.items():
            prim.attrs.setdefault(k, a)
        for k, v in content.metadata.items():
            prim.metadata.setdefault(k, v)
        prim.children.extend(content.children)
    prim.variant_sets = {}
    for c in prim.children:
        resolve_variants(c)


class _Tokenizer:
    """Lexer for usda: identifiers, numbers, strings, punctuation."""

    _TOKEN_RE = re.compile(
        r"""
        (?P<comment>\#[^\n]*) |
        (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*') |
        (?P<asset>@[^@]*@) |
        (?P<path><[^>]*>) |
        (?P<number>[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?) |
        (?P<ident>[A-Za-z_][A-Za-z0-9_:.\-]*) |
        (?P<punct>[{}()\[\],=;&]) |
        (?P<ws>\s+)
        """,
        re.VERBOSE,
    )

    def __init__(self, text: str):
        self.toks: List[str] = []
        pos = 0
        n = len(text)
        while pos < n:
            m = self._TOKEN_RE.match(text, pos)
            if not m:
                pos += 1  # skip unknown char
                continue
            pos = m.end()
            kind = m.lastgroup
            if kind in ("comment", "ws"):
                continue
            self.toks.append(m.group())
        self.i = 0

    def peek(self, k: int = 0) -> Optional[str]:
        j = self.i + k
        return self.toks[j] if j < len(self.toks) else None

    def next(self) -> Optional[str]:
        t = self.peek()
        self.i += 1
        return t

    def expect(self, tok: str) -> None:
        t = self.next()
        if t != tok:
            raise SyntaxError(f"usda parse: expected {tok!r}, got {t!r} near #{self.i}")

    def at_end(self) -> bool:
        return self.i >= len(self.toks)


_NUM_RE = re.compile(r"^[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?$")


def _is_number(tok: Optional[str]) -> bool:
    return tok is not None and bool(_NUM_RE.match(tok))


def _parse_value(tz: _Tokenizer):
    """Parse a value: scalar | tuple | list | string | asset | path | dict."""
    t = tz.peek()
    if t is None:
        return None
    if t == "(":
        tz.next()
        vals = []
        while tz.peek() != ")":
            if tz.peek() is None:  # EOF never matches ')': would loop forever
                raise SyntaxError("usda parse: unterminated tuple")
            vals.append(_parse_value(tz))
            if tz.peek() == ",":
                tz.next()
        tz.expect(")")
        return tuple(vals)
    if t == "[":
        tz.next()
        vals = []
        while tz.peek() != "]":
            if tz.peek() is None:
                raise SyntaxError("usda parse: unterminated list")
            vals.append(_parse_value(tz))
            if tz.peek() == ",":
                tz.next()
        tz.expect("]")
        return vals
    if t == "{":
        # dictionary: parse '[type] key = value' entries (variants blocks,
        # customData); timeSamples-style '0: (...)' content falls back to a
        # raw token capture
        tz.next()
        out: Dict[str, object] = {}
        while tz.peek() not in ("}", None):
            if tz.peek(1) == "=" or (tz.peek(1) is not None and tz.peek(2) == "="):
                if tz.peek(1) == "=":
                    key = tz.next()
                else:
                    tz.next()  # type word (string/token/...)
                    key = tz.next()
                tz.expect("=")
                out[key.strip('"')] = _parse_value(tz)
                if tz.peek() == ";":
                    tz.next()
                continue
            # unstructured content: capture the rest raw and stop
            depth = 1
            content = []
            while depth > 0 and not tz.at_end():
                tok = tz.next()
                if tok == "{":
                    depth += 1
                elif tok == "}":
                    depth -= 1
                    if depth == 0:
                        return {"__raw__": content}
                content.append(tok)
            return {"__raw__": content}
        if tz.peek() == "}":
            tz.next()
        return out
    if t.startswith('"') or t.startswith("'"):
        tz.next()
        return t[1:-1]
    if t.startswith("@"):
        tz.next()
        return ("__asset__", t[1:-1])
    if t.startswith("<"):
        tz.next()
        return ("__path__", t[1:-1])
    if _is_number(t):
        tz.next()
        return float(t) if ("." in t or "e" in t or "E" in t) else int(t)
    # bare identifiers (true/false/None/tokens)
    tz.next()
    if t == "true":
        return True
    if t == "false":
        return False
    if t == "None":
        return None
    return t


def _all_time_samples(raw_tokens):
    """Parse every (time, value) pair out of a raw timeSamples token list.

    The block tokens look like: time, value-tokens..., ',', time, ...
    (':' separators are dropped by the tokenizer). Returns ([times], [values])
    or None on a malformed block."""
    if not raw_tokens:
        return None
    tz = _Tokenizer("")
    tz.toks = list(raw_tokens)
    tz.i = 0
    times, values = [], []
    try:
        while not tz.at_end():
            t = tz.next()
            if t == ",":
                continue
            times.append(float(t))
            values.append(_parse_value(tz))
    except (SyntaxError, ValueError, TypeError):
        if not times or len(times) != len(values):
            return None
        from refport import log

        log.debug("timeSamples block malformed past sample {}; truncating", len(values))
    return (times, values) if times and len(times) == len(values) else None


def _parse_metadata_block(tz: _Tokenizer) -> Dict[str, object]:
    """Parse '( ... )' prim/attr metadata into a dict (values best-effort)."""
    meta: Dict[str, object] = {}
    tz.expect("(")
    depth = 1
    key = None
    while not tz.at_end():
        t = tz.peek()
        if t == ")":
            tz.next()
            depth -= 1
            if depth == 0:
                break
            continue
        if t == "(":
            tz.next()
            depth += 1
            continue
        # key = value pairs
        if tz.peek(1) == "=":
            key = tz.next()
            tz.expect("=")
            meta[key] = _parse_value(tz)
        else:
            # doc strings or stray tokens
            tz.next()
    return meta


_TYPE_WORDS = {
    "float", "double", "int", "bool", "token", "string", "asset", "rel",
    "color3f", "color3d", "normal3f", "point3f", "vector3f", "texCoord2f",
    "float2", "float3", "float4", "double2", "double3", "double4", "int2",
    "int3", "int4", "matrix4d", "matrix3d", "quatf", "quatd", "uchar",
    "int64", "uint", "uint64", "half", "half2", "half3", "half4", "texCoord2d",
    "texCoord3f", "color4f", "float4x4",
}


def _parse_attr(tz: _Tokenizer, prim: Prim) -> None:
    uniform = False
    custom = False
    t = tz.peek()
    if t == "uniform":
        uniform = True
        tz.next()
        t = tz.peek()
    if t == "custom":
        custom = True
        tz.next()
        t = tz.peek()
        if t == "uniform":
            uniform = True
            tz.next()
            t = tz.peek()
    if t == "prepend" or t == "append" or t == "delete" or t == "add":
        tz.next()
        t = tz.peek()

    type_str = ""
    if t in _TYPE_WORDS or (t and t.split("[")[0] in _TYPE_WORDS):
        type_str = tz.next()
        if tz.peek() == "[":
            # array marker split into tokens '[' ']'
            if tz.peek(1) == "]":
                tz.next()
                tz.next()
                type_str += "[]"
    name = tz.next()
    if name is None:
        return
    attr = prim.attrs.get(name.split(".connect")[0].split(".timeSamples")[0])
    is_connect = name.endswith(".connect")
    is_timesamples = name.endswith(".timeSamples")
    base = name.split(".connect")[0].split(".timeSamples")[0]
    if attr is None:
        attr = Attr(type_str=type_str, uniform=uniform)
        prim.attrs[base] = attr

    if tz.peek() == "=":
        tz.next()
        val = _parse_value(tz)
        if is_connect:
            if isinstance(val, tuple) and val and val[0] == "__path__":
                attr.connect = val[1]
        elif is_timesamples:
            # static-render semantics: resolve to the FIRST time sample
            # (hdRunner renders one SetTime; our bake is static) but keep
            # the full sample set on the Attr for animation consumers
            if isinstance(val, dict):
                ts = _all_time_samples(val.get("__raw__", []))
                if ts is not None:
                    attr.time_samples = ts
                    if attr.value is None:
                        attr.value = ts[1][0]
        elif type_str == "rel" or (type_str == "" and isinstance(val, tuple) and val and val[0] == "__path__"):
            if isinstance(val, tuple) and val[0] == "__path__":
                attr.targets = [val[1]]
            elif isinstance(val, list):
                attr.targets = [v[1] for v in val if isinstance(v, tuple) and v[0] == "__path__"]
        else:
            attr.value = val
    elif type_str == "rel" and tz.peek() == "=":
        pass
    # optional attr metadata
    if tz.peek() == "(":
        meta = _parse_metadata_block(tz)
        if "interpolation" in meta:
            prim.attrs[base + ":__interp__"] = Attr(value=meta["interpolation"])


def _parse_variant_set(tz: _Tokenizer, prim: Prim) -> None:
    """variantSet "name" = { "sel" { ...prim content... } ... } — content is
    stored in prim.variant_sets for resolve_variants (LIVRPS 'V')."""
    tz.next()  # 'variantSet'
    name = tz.next().strip('"')
    tz.expect("=")
    tz.expect("{")
    while tz.peek() != "}":
        if tz.peek() is None:
            raise SyntaxError("usda parse: unterminated variantSet block")
        sel = tz.next().strip('"')
        content = Prim(name="", path=f"{prim.path}{{{name}={sel}}}")
        if tz.peek() == "(":
            content.metadata = _parse_metadata_block(tz)
        _parse_prim_body(tz, content)
        prim.variant_sets.setdefault(name, {})[sel] = content
    tz.expect("}")


def _parse_prim_body(tz: _Tokenizer, prim: Prim) -> None:
    tz.expect("{")
    while tz.peek() != "}":
        if tz.peek() is None:
            raise SyntaxError("usda parse: unterminated prim body")
        t = tz.peek()
        if t in ("def", "over", "class"):
            prim.children.append(_parse_prim(tz, prim.path))
        elif t == "variantSet":
            _parse_variant_set(tz, prim)
        elif t == ";":
            tz.next()
        else:
            _parse_attr(tz, prim)
    tz.expect("}")


def _parse_prim(tz: _Tokenizer, parent_path: str) -> Prim:
    specifier = tz.next()  # def/over/class
    type_or_name = tz.peek()
    prim = Prim(specifier=specifier)
    if type_or_name is not None and not type_or_name.startswith('"'):
        prim.type = tz.next()
    prim.name = tz.next()[1:-1]
    prim.path = parent_path.rstrip("/") + "/" + prim.name
    if tz.peek() == "(":
        prim.metadata = _parse_metadata_block(tz)
    _parse_prim_body(tz, prim)
    return prim


def parse_usda(text: str) -> Prim:
    """Parse usda text to a pseudo-root Prim (children = top-level prims).
    Variant sets are parsed and composed (default selections applied)."""
    if not text.lstrip().startswith("#usda"):
        raise ValueError("not a usda file (missing #usda header)")
    # strip the #usda line (tokenizer treats # as comment anyway)
    tz = _Tokenizer(text)
    root = Prim(type="PseudoRoot", name="", path="/")
    # layer metadata block
    if tz.peek() == "(":
        root.metadata = _parse_metadata_block(tz)
    while not tz.at_end():
        t = tz.peek()
        if t in ("def", "over", "class"):
            root.children.append(_parse_prim(tz, "/"))
        else:
            tz.next()
    resolve_variants(root)
    return root
