"""MDL constant-expression interpreter (load-time folding).

The reference compiles *arbitrary* MDL through the SDK's LLVM backend —
computed parameter defaults, nested function calls, math intrinsics all
evaluate at class-compilation time with constant folding
(`src/materialmanager/mdlMaterialCompiler.cpp:93-115`
CLASS_COMPILATION + fold options; codegen `mdlPtxCodeGen.cpp:63-131`).
The TPU build's material destination is the analytic uber-BSDF parameter
table, so the equivalent capability is a load-time CONSTANT-EXPRESSION
interpreter: evaluate computed defaults (`float r = base * 0.5 + 0.1`),
user-defined module functions (`= my_tint(warm)`), `math::*` intrinsics,
and color/float constructors down to the plain values the param table
stores. Anything non-constant (varying state, texture-dependent) stays
unevaluated and the caller keeps its declared-literal/fallback behavior.

Builds on the expression AST of loaders/mdl.py (`_BodyParser`, `_Call`,
`_Ref`); this module adds the *function registry* + the richer evaluator.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Optional

from refport.loaders.mdl import (
    _BodyParser,
    _Call,
    _Ref,
    _strip_annotations,
    _strip_comments,
    _tokenize,
)

# ---------------------------------------------------------------------------
# User-defined function extraction
# ---------------------------------------------------------------------------

# `export float foo(float a, color b = color(1)) = a * 0.5;`
# or  `... { return a * 0.5; }` (single-return bodies only — the constant
# subset; control flow / loops are beyond load-time folding and are skipped).
_FUNC_RE = re.compile(
    r"export\s+(?P<rtype>\w+(?:::\w+)*[23]?)\s+(?P<name>\w+)\s*\(",
)
_KEYWORDS = {"material", "import", "using", "module", "annotation", "enum", "struct"}


class MdlFunction:
    __slots__ = ("name", "params", "defaults", "body")

    def __init__(self, name: str, params: List[str], defaults: Dict[str, object], body):
        self.name = name
        self.params = params  # positional order
        self.defaults = defaults  # {param: AST node}
        self.body = body  # AST node


def _match_paren(text: str, i: int) -> int:
    """Index just past the ')' matching the '(' at text[i-1]."""
    depth = 1
    while i < len(text) and depth > 0:
        if text[i] == "(":
            depth += 1
        elif text[i] == ")":
            depth -= 1
        i += 1
    return i


def parse_mdl_functions(text: str) -> Dict[str, MdlFunction]:
    """Exported expression-bodied / single-return functions in an MDL module.

    The text should be comment/annotation-stripped (parse_mdl_materials does
    the same normalization).
    """
    text = _strip_annotations(_strip_comments(text))
    out: Dict[str, MdlFunction] = {}
    for m in _FUNC_RE.finditer(text):
        rtype, name = m.group("rtype"), m.group("name")
        if rtype in _KEYWORDS or name in _KEYWORDS or rtype == "material":
            continue
        sig_end = _match_paren(text, m.end())
        paramlist = text[m.end() : sig_end - 1]
        params: List[str] = []
        defaults: Dict[str, object] = {}
        from refport.loaders.mdl import _split_params

        for part in _split_params(paramlist):
            pm = re.match(
                r"(uniform\s+|varying\s+)?(?P<type>\w+(::\w+)*[23]?)\s+(?P<name>\w+)"
                r"\s*(=\s*(?P<default>.*))?$",
                part,
                re.DOTALL,
            )
            if not pm:
                params = []
                break
            params.append(pm.group("name"))
            if pm.group("default"):
                try:
                    defaults[pm.group("name")] = _BodyParser(
                        _tokenize(pm.group("default"))
                    ).parse_expr()
                except Exception:  # noqa: BLE001
                    pass
        if not params and paramlist.strip():
            continue
        rest = text[sig_end:]
        body = None
        bm = re.match(r"\s*=\s*", rest)
        if bm:
            j = bm.end()
            depth = 0
            while j < len(rest):
                c = rest[j]
                if c in "([{":
                    depth += 1
                elif c in ")]}":
                    depth -= 1
                elif c == ";" and depth == 0:
                    break
                j += 1
            src = rest[bm.end() : j]
        else:
            bm = re.match(r"\s*\{\s*return\s+", rest)
            if not bm:
                continue
            j = bm.end()
            depth = 0
            while j < len(rest):
                c = rest[j]
                if c in "([{":
                    depth += 1
                elif c in ")]}":
                    depth -= 1
                elif c == ";" and depth == 0:
                    break
                j += 1
            # single-return only: nothing but whitespace and '}' may follow
            tail = rest[j + 1 :].lstrip()
            if not tail.startswith("}"):
                continue
            src = rest[bm.end() : j]
        try:
            body = _BodyParser(_tokenize(src)).parse_expr()
        except Exception:  # noqa: BLE001
            continue
        if body is not None:
            out[name] = MdlFunction(name, params, defaults, body)
    return out


# ---------------------------------------------------------------------------
# Constant evaluator
# ---------------------------------------------------------------------------

_MAX_DEPTH = 32


def _broadcast(a, b):
    if isinstance(a, list) and isinstance(b, (int, float)):
        return a, [float(b)] * len(a)
    if isinstance(b, list) and isinstance(a, (int, float)):
        return [float(a)] * len(b), b
    return a, b


def _map1(f, a):
    return [f(x) for x in a] if isinstance(a, list) else f(a)


def _map2(f, a, b):
    a, b = _broadcast(a, b)
    if isinstance(a, list):
        return [f(x, y) for x, y in zip(a, b)]
    return f(a, b)


def _map3(f, a, b, c):
    n = max(len(v) for v in (a, b, c) if isinstance(v, list)) if any(
        isinstance(v, list) for v in (a, b, c)
    ) else 0
    if n:
        a = a if isinstance(a, list) else [float(a)] * n
        b = b if isinstance(b, list) else [float(b)] * n
        c = c if isinstance(c, list) else [float(c)] * n
        return [f(x, y, z) for x, y, z in zip(a, b, c)]
    return f(a, b, c)


def _luminance(c):
    c = c if isinstance(c, list) else [float(c)] * 3
    return 0.212671 * c[0] + 0.715160 * c[1] + 0.072169 * c[2]


_MATH_1 = {
    "abs": abs,
    "sqrt": lambda x: math.sqrt(max(x, 0.0)),
    "sin": math.sin,
    "cos": math.cos,
    "tan": math.tan,
    "exp": math.exp,
    "exp2": lambda x: 2.0 ** x,
    "log": lambda x: math.log(max(x, 1e-30)),
    "log2": lambda x: math.log2(max(x, 1e-30)),
    "log10": lambda x: math.log10(max(x, 1e-30)),
    "floor": math.floor,
    "ceil": math.ceil,
    "round": round,
    "frac": lambda x: x - math.floor(x),
    "saturate": lambda x: min(1.0, max(0.0, x)),
    "radians": math.radians,
    "degrees": math.degrees,
}
_MATH_2 = {
    "min": min,
    "max": max,
    "pow": lambda x, y: math.pow(x, y) if x >= 0 or y == int(y) else 0.0,
    "fmod": math.fmod,
    "atan2": math.atan2,
}


def eval_const(node, env: Dict[str, object], funcs: Optional[Dict[str, MdlFunction]] = None,
               depth: int = 0):
    """Evaluate an expression AST to float / [k] floats / bool / str / None.

    env maps identifiers (material params, let bindings, enum-ish names) to
    VALUES or AST nodes. funcs maps user-defined function names to
    MdlFunction. None = not a constant (caller falls back)."""
    if depth > _MAX_DEPTH:
        return None
    funcs = funcs or {}
    if node is None or isinstance(node, (float, bool, str)):
        return node
    if isinstance(node, int):
        return float(node)
    if isinstance(node, _Ref):
        v = env.get(node.name)
        if isinstance(v, (_Call, _Ref)):
            return eval_const(v, env, funcs, depth + 1)
        if v is None and "::" in node.name:
            # enum-ish qualified name (e.g. tex::gamma_srgb): pass through as str
            return node.name
        return v
    if not isinstance(node, _Call):
        return None
    name = node.name.split("::")[-1]

    def ev(n):
        return eval_const(n, env, funcs, depth + 1)

    if name.startswith("__op"):
        a, b = ev(node.pos[0]), ev(node.pos[1])
        if not _is_num(a) or not _is_num(b):
            return None
        op = node.name[4]
        if op == "*":
            return _map2(lambda x, y: x * y, a, b)
        if op == "+":
            return _map2(lambda x, y: x + y, a, b)
        if op == "-":
            return _map2(lambda x, y: x - y, a, b)
        if op == "/":
            return _map2(lambda x, y: x / y if abs(y) > 1e-30 else 0.0, a, b)
        return None
    if name in ("color", "float3", "float2", "float4", "double3"):
        vals = [ev(p) for p in node.pos]
        if any(not _is_num(v) for v in vals):
            return None
        flat: List[float] = []
        for v in vals:
            flat.extend(v if isinstance(v, list) else [float(v)])
        k = 3 if name in ("color", "float3", "double3") else int(name[-1])
        if len(flat) == 1:
            flat = flat * k
        if not flat:
            flat = [0.0] * k
        return (flat + [0.0] * k)[:k]
    if name in ("float", "double", "int"):
        v = ev(node.pos[0]) if node.pos else None
        if isinstance(v, bool):
            return 1.0 if v else 0.0
        if isinstance(v, list):
            return v[0]
        return v
    if name == "lerp" or name == "mix":
        a, b, t = (ev(x) for x in (node.pos + [None, None, None])[:3])
        if not (_is_num(a) and _is_num(b) and _is_num(t)):
            return None
        return _map3(lambda x, y, w: x * (1.0 - w) + y * w, a, b, t)
    if name == "clamp":
        a, lo, hi = (ev(x) for x in (node.pos + [None, None, None])[:3])
        if not (_is_num(a) and _is_num(lo) and _is_num(hi)):
            return None
        return _map3(lambda x, l, h: min(h, max(l, x)), a, lo, hi)
    if name in _MATH_1:
        v = ev(node.pos[0]) if node.pos else None
        return _map1(_MATH_1[name], v) if _is_num(v) else None
    if name in _MATH_2:
        a = ev(node.pos[0]) if node.pos else None
        b = ev(node.pos[1]) if len(node.pos) > 1 else None
        return _map2(_MATH_2[name], a, b) if _is_num(a) and _is_num(b) else None
    if name == "luminance":
        v = ev(node.pos[0]) if node.pos else None
        return _luminance(v) if _is_num(v) else None
    if name == "average":
        v = ev(node.pos[0]) if node.pos else None
        if isinstance(v, list):
            return sum(v) / len(v)
        return v if _is_num(v) else None
    if name == "texture_2d":
        # texture constructor: value is its (resolved) path string
        v = ev(node.pos[0]) if node.pos else None
        return v if isinstance(v, str) else None
    if name in funcs:
        fn = funcs[name]
        call_env: Dict[str, object] = {}
        for i, pname in enumerate(fn.params):
            if pname in node.args:
                call_env[pname] = ev(node.args[pname])
            elif i < len(node.pos):
                call_env[pname] = ev(node.pos[i])
            elif pname in fn.defaults:
                call_env[pname] = eval_const(fn.defaults[pname], call_env, funcs, depth + 1)
            else:
                return None
        if any(v is None for v in call_env.values()):
            return None
        return eval_const(fn.body, call_env, funcs, depth + 1)
    return None


def _is_num(v) -> bool:
    if isinstance(v, bool):
        return False
    if isinstance(v, (int, float)):
        return True
    return isinstance(v, list) and all(isinstance(x, (int, float)) for x in v)


def eval_default_text(expr_text: str, env: Dict[str, object],
                      funcs: Optional[Dict[str, MdlFunction]] = None):
    """Parse + constant-evaluate one default-value expression string.

    Returns float / [k] floats / bool / str(texture path) / None."""
    try:
        ast = _BodyParser(_tokenize(expr_text)).parse_expr()
    except Exception:  # noqa: BLE001
        return None
    return eval_const(ast, env, funcs)
