"""MDL (.mdl) source ingestion — parameter-default extraction.

The reference compiles MDL source through the NVIDIA MDL SDK (neuray ->
CLASS_COMPILATION -> PTX, src/materialmanager/mdlMaterialCompiler.cpp +
mdlPtxCodeGen.cpp). The TPU build's material destination is the analytic
BSDF table, so what it needs from a .mdl FILE is: which material model
(by name) and the declared parameter DEFAULTS (the arg-block initial
values). This module extracts `export material Name(params...)` signatures
with a small tokenizer — enough for OmniPBR/OmniGlass/default-style
materials, with unknown constructs skipped gracefully.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Optional

from refport import log

_MATERIAL_RE = re.compile(r"export\s+material\s+(\w+)\s*\(", re.MULTILINE)
_PARAM_RE = re.compile(
    r"""
    (?P<type>uniform\s+\w+|\w+)\s+          # type (possibly 'uniform T')
    (?P<name>\w+)\s*
    (?:=\s*(?P<default>[^,()]*(?:\([^()]*\))?[^,()]*))?  # default expr
    \s*(?:,|$)
    """,
    re.VERBOSE,
)
_COLOR_RE = re.compile(r"color\s*\(([^)]*)\)")
_FLOAT_RE = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eEf][-+]?\d*)?$")
_TEXTURE_RE = re.compile(r'texture_2d\s*\(\s*"([^"]*)"')


def _strip_annotations(text: str) -> str:
    """Remove [[ ... ]] annotation blocks (possibly nested brackets)."""
    out = []
    i = 0
    while i < len(text):
        if text.startswith("[[", i):
            depth = 1
            i += 2
            while i < len(text) and depth > 0:
                if text.startswith("[[", i):
                    depth += 1
                    i += 2
                elif text.startswith("]]", i):
                    depth -= 1
                    i += 2
                else:
                    i += 1
        else:
            out.append(text[i])
            i += 1
    return "".join(out)


def _strip_comments(text: str) -> str:
    text = re.sub(r"//[^\n]*", "", text)
    return re.sub(r"/\*.*?\*/", "", text, flags=re.DOTALL)


def _split_params(paramlist: str) -> List[str]:
    """Split on commas at paren depth 0."""
    parts, depth, cur = [], 0, []
    for ch in paramlist:
        if ch in "([":
            depth += 1
        elif ch in ")]":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur).strip())
            cur = []
        else:
            cur.append(ch)
    if cur and "".join(cur).strip():
        parts.append("".join(cur).strip())
    return parts


def _parse_default(expr: str):
    expr = expr.strip()
    if not expr:
        return None
    m = _COLOR_RE.search(expr)
    if m:
        comps = [c.strip().rstrip("f") for c in m.group(1).split(",")]
        try:
            vals = [float(c) for c in comps if c]
        except ValueError:
            return None
        if len(vals) == 1:
            vals = vals * 3
        return vals[:3]
    m = _TEXTURE_RE.search(expr)
    if m:
        return m.group(1)
    if expr in ("true", "false"):
        return expr == "true"
    e = expr.rstrip("f")
    if _FLOAT_RE.match(e):
        return float(e)
    return None


def parse_mdl_materials(
    text: str, bodies: Optional[Dict[str, str]] = None,
    funcs: Optional[Dict[str, object]] = None,
) -> Dict[str, Dict[str, object]]:
    """All exported materials in an MDL module -> {name: {param: default}}.

    When `bodies` is given, it's filled with {name: body_text} — the `=
    <expr>` after each signature (for df-tree folding, fold_material_body).

    Computed defaults (`float r = base * 0.5`, `= my_fn(x)`, math::
    intrinsics) are constant-folded at parse time through the expression
    interpreter in loaders/mdl_expr.py — the load-time equivalent of the
    reference's class-compilation constant folding
    (mdlMaterialCompiler.cpp:93-115). Earlier parameters of the same
    signature are in scope for later defaults, matching MDL semantics.
    `funcs` is the user-defined function registry (parse_mdl_functions).
    """
    text = _strip_annotations(_strip_comments(text))
    result: Dict[str, Dict[str, object]] = {}
    for m in _MATERIAL_RE.finditer(text):
        name = m.group(1)
        # find the matching close paren of the signature
        start = m.end()
        depth = 1
        i = start
        while i < len(text) and depth > 0:
            if text[i] == "(":
                depth += 1
            elif text[i] == ")":
                depth -= 1
            i += 1
        paramlist = text[start : i - 1]
        params: Dict[str, object] = {}
        for part in _split_params(paramlist):
            pm = re.match(r"(uniform\s+)?(?P<type>\w+(::\w+)*)\s+(?P<name>\w+)\s*(=\s*(?P<default>.*))?$", part, re.DOTALL)
            if not pm:
                continue
            dtext = (pm.group("default") or "").strip()
            default = _parse_default(dtext)
            if default is None and dtext:
                # computed default: constant-fold with earlier params in scope
                from refport.loaders import mdl_expr

                default = mdl_expr.eval_default_text(dtext, dict(params), funcs)
            if default is not None:
                params[pm.group("name")] = default
        result[name] = params
        if bodies is not None:
            # body: `= <expr> ;` at depth 0 after the signature
            rest = text[i:]
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
                bodies[name] = rest[bm.end() : j]
    return result


class MdlModule:
    """A loaded MDL module (createModule analog, mdlMaterialCompiler.cpp:40-50)."""

    def __init__(
        self,
        path: str,
        materials: Dict[str, Dict[str, object]],
        has_hair: bool = False,
        bodies: Optional[Dict[str, str]] = None,
        funcs: Optional[Dict[str, object]] = None,
    ):
        self.path = path
        self.materials = materials
        self.funcs = funcs or {}
        # material uses an MDL hair df — the reference switches the link unit
        # to "hair" instead of surface.scattering when the hair expression is
        # non-constant (mdlPtxCodeGen.cpp:143-158)
        self.has_hair = has_hair
        self.bodies = bodies or {}
        self._folded: Dict[str, Dict[str, object]] = {}

    def folded(self, name: str) -> Dict[str, object]:
        """Uber-BSDF params folded from the material's df body expression
        ({} when the body isn't recognisably foldable)."""
        if name not in self._folded:
            body = self.bodies.get(name, "")
            self._folded[name] = (
                fold_material_body(body, self.materials.get(name, {}),
                                   funcs=self.funcs)
                if body
                else {}
            )
        return self._folded[name]


def load_mdl_module(file: str, search_paths: List[str]) -> Optional[MdlModule]:
    """Resolve an .mdl file against search paths and parse its materials."""
    candidates = [file]
    for sp in search_paths:
        candidates.append(os.path.join(sp, file))
    for cand in candidates:
        if os.path.exists(cand):
            try:
                with open(cand, "r", encoding="utf-8") as f:
                    text = f.read()
                has_hair = "hair_bsdf" in text or "df::hair" in text
                bodies: Dict[str, str] = {}
                from refport.loaders import mdl_expr

                funcs = mdl_expr.parse_mdl_functions(text)
                mats = parse_mdl_materials(text, bodies, funcs=funcs)
                return MdlModule(
                    cand, mats, has_hair=has_hair, bodies=bodies, funcs=funcs
                )
            except OSError as e:
                log.warning("mdl read failed {}: {}", cand, e)
                return None
    return None


# ---------------------------------------------------------------------------
# Material-body folding: evaluate the df expression tree onto uber-BSDF rows.
#
# The reference JIT-compiles arbitrary MDL bodies through the SDK
# (mdlPtxCodeGen.cpp); the TPU build's material destination is the analytic
# uber-BSDF table, so layered/weighted df expressions are FOLDED analytically:
# each elemental bsdf contributes a weighted lobe, layerers combine child
# weights, and the lobe totals map onto (diffuse_color, roughness, metallic,
# specular_level, ior, glass) — instead of guessing the model by module name.
# ---------------------------------------------------------------------------


class _Call:
    __slots__ = ("name", "args", "pos")

    def __init__(self, name, args, pos):
        self.name = name  # e.g. 'df::weighted_layer'
        self.args = args  # {arg_name: node}
        self.pos = pos  # positional nodes


class _Ref:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name


_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?f?)"
    r"|(?P<id>[A-Za-z_]\w*(?:::\w+)*)"
    r"|(?P<str>\"[^\"]*\")"
    r"|(?P<punc>[(),:\[\]*+\-/]))"
)


def _tokenize(text: str) -> List[str]:
    out, i = [], 0
    while i < len(text):
        m = _TOKEN_RE.match(text, i)
        if not m:
            i += 1
            continue
        out.append(m.group().strip())
        i = m.end()
    return out


class _BodyParser:
    """Recursive-descent parser for MDL value expressions: calls with named
    or positional args, identifiers, numeric/color literals, and */+/-
    arithmetic (enough for OmniPBR-style bodies)."""

    def __init__(self, tokens: List[str]):
        self.t = tokens
        self.i = 0

    def peek(self):
        return self.t[self.i] if self.i < len(self.t) else None

    def next(self):
        tok = self.peek()
        self.i += 1
        return tok

    def parse_expr(self):
        # additive level; parse_term binds * and / tighter (C precedence)
        node = self.parse_term()
        while self.peek() in ("+", "-"):
            op = self.next()
            rhs = self.parse_term()
            node = _Call("__op" + op, {}, [node, rhs])
        return node

    def parse_term(self):
        node = self.parse_unary()
        while self.peek() in ("*", "/"):
            op = self.next()
            rhs = self.parse_unary()
            node = _Call("__op" + op, {}, [node, rhs])
        return node

    def parse_unary(self):
        tok = self.peek()
        if tok is None:
            return None
        if tok == "(":  # parenthesised
            self.next()
            node = self.parse_expr()
            if self.peek() == ")":
                self.next()
            return node
        if tok == "[":  # array literal
            self.next()
            items = []
            while self.peek() not in ("]", None):
                items.append(self.parse_expr())
                if self.peek() == ",":
                    self.next()
            self.next()
            return _Call("__array", {}, items)
        tok = self.next()
        if re.match(r"^[-+]?(\d|\.\d)", tok):
            return float(tok.rstrip("f"))
        if tok.startswith('"'):
            return tok[1:-1]
        if tok in ("true", "false"):
            return tok == "true"
        # identifier: call or reference
        if self.peek() == "(":
            self.next()
            args, pos = {}, []
            while self.peek() not in (")", None):
                # named arg?
                if (
                    self.i + 1 < len(self.t)
                    and re.match(r"^[A-Za-z_]", self.t[self.i] or "")
                    and self.t[self.i + 1] == ":"
                ):
                    name = self.next()
                    self.next()  # ':'
                    args[name] = self.parse_expr()
                else:
                    pos.append(self.parse_expr())
                if self.peek() == ",":
                    self.next()
            self.next()  # ')'
            return _Call(tok, args, pos)
        return _Ref(tok)


def _parse_body(text: str):
    """Parse a material body `= <expr> ;` (after let-binding extraction)."""
    env_exprs: Dict[str, object] = {}
    text = text.strip()
    if text.startswith("let"):
        # let { T name = expr; ... } in <expr>   (or brace-less variant)
        braced = re.match(r"let\s*\{", text) is not None
        j = text.index("{") + 1 if braced else 3
        start = j
        depth = 0
        bindings = []
        while j < len(text):
            c = text[j]
            if c in "([" or (c == "{" and not braced):
                depth += 1
            elif c in ")]":
                depth -= 1
            elif c == ";" and depth == 0:
                bindings.append(text[start:j])
                start = j + 1
            elif braced and c == "}" and depth == 0:
                j = text.index("in", j) + 2
                break
            elif (
                not braced and depth == 0 and text.startswith("in", j)
                and not text[j - 1].isalnum() and not text[j + 2 : j + 3].isalnum()
            ):
                j += 2
                break
            j += 1
        for b in bindings:
            m = re.match(r"\s*[\w:]+\s+(\w+)\s*=\s*(.*)$", b, re.DOTALL)
            if m:
                env_exprs[m.group(1)] = _BodyParser(_tokenize(m.group(2))).parse_expr()
        text = text[j:]
    return _BodyParser(_tokenize(text)).parse_expr(), env_exprs


def _ev(node, env):
    """Evaluate a value expression to float / [3] color / str / bool / None."""
    if node is None or isinstance(node, (float, bool, str)):
        return node
    if isinstance(node, _Ref):
        v = env.get(node.name)
        if isinstance(v, (_Call, _Ref)):
            return _ev(v, env)
        return v
    name = node.name.split("::")[-1]
    if name.startswith("__op"):
        a, b = _ev(node.pos[0], env), _ev(node.pos[1], env)
        if a is None or b is None:
            return a if a is not None else b
        import numpy as _np

        a, b = _np.asarray(a, _np.float64), _np.asarray(b, _np.float64)
        op = node.name[4]
        r = {"*": a * b, "+": a + b, "-": a - b, "/": a / _np.maximum(b, 1e-12)}[op]
        return float(r) if r.ndim == 0 else list(map(float, r))
    if name == "color":
        vals = [_ev(p, env) for p in node.pos]
        vals = [v for v in vals if isinstance(v, float)]
        if len(vals) == 1:
            vals = vals * 3
        return (vals + [0.0, 0.0, 0.0])[:3] if vals else None
    if name in ("float", "float3"):
        vals = [_ev(p, env) for p in node.pos]
        if len(vals) == 1:
            return vals[0]
        return vals
    if name == "texture_2d":
        v = _ev(node.pos[0], env) if node.pos else None
        return v
    # unknown value call: route through the constant-expression interpreter
    # (math:: intrinsics, user-defined module functions) when a function
    # registry rode in under the reserved env key
    funcs = env.get("__funcs__")
    if funcs is not None:
        from refport.loaders import mdl_expr

        return mdl_expr.eval_const(node, env, funcs)
    return None  # unknown value call


class _Lobes:
    """Accumulated lobe weights from folding a df tree."""

    def __init__(self):
        self.dw = 0.0  # diffuse weight
        self.dtint = [0.0, 0.0, 0.0]  # weighted diffuse tint
        self.gw = 0.0  # glossy weight (all)
        self.gw_tinted = 0.0  # glossy weight with non-white tint (metal-like)
        self.gtint = [0.0, 0.0, 0.0]  # weighted glossy tint
        self.grough = 0.0  # weight * perceptual roughness accumulator
        self.tw = 0.0  # transmission weight
        self.ttint = [1.0, 1.0, 1.0]
        self.spec_level = None
        self.ior = None
        self.hair = False

    def scaled(self, w, tint=None):
        out = _Lobes()
        t = tint if tint is not None else [1.0, 1.0, 1.0]
        out.dw = self.dw * w
        out.gw = self.gw * w
        out.gw_tinted = self.gw_tinted * w
        out.tw = self.tw * w
        out.dtint = [c * w * tc for c, tc in zip(self.dtint, t)]
        out.gtint = [c * w * tc for c, tc in zip(self.gtint, t)]
        out.ttint = [c * tc for c, tc in zip(self.ttint, t)]
        out.grough = self.grough * w
        out.spec_level = self.spec_level
        out.ior = self.ior
        out.hair = self.hair
        return out

    def add(self, other):
        self.dw += other.dw
        self.gw += other.gw
        self.gw_tinted += other.gw_tinted
        self.tw += other.tw
        self.dtint = [a + b for a, b in zip(self.dtint, other.dtint)]
        self.gtint = [a + b for a, b in zip(self.gtint, other.gtint)]
        if other.tw > self.tw - 1e-9:
            self.ttint = other.ttint
        self.grough += other.grough
        self.spec_level = other.spec_level if other.spec_level is not None else self.spec_level
        self.ior = other.ior if other.ior is not None else self.ior
        self.hair = self.hair or other.hair
        return self


def _fold_df(node, env) -> Optional[_Lobes]:
    """Fold a df expression into lobe accumulators; None for non-df nodes."""
    if not isinstance(node, _Call):
        if isinstance(node, _Ref):
            sub = env.get(node.name)
            return _fold_df(sub, env) if isinstance(sub, (_Call, _Ref)) else None
        return None
    name = node.name.split("::")[-1]
    A = node.args

    def arg(n, idx=None, default=None):
        if n in A:
            return A[n]
        if idx is not None and idx < len(node.pos):
            return node.pos[idx]
        return default

    def num(n, idx=None, default=None):
        v = _ev(arg(n, idx), env)
        if isinstance(v, list):
            v = sum(v) / len(v)
        return float(v) if isinstance(v, (int, float)) and not isinstance(v, bool) else default

    def col(n, idx=None, default=None):
        v = _ev(arg(n, idx), env)
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            return [float(v)] * 3
        return list(v) if isinstance(v, list) else default

    if name == "diffuse_reflection_bsdf":
        L = _Lobes()
        t = col("tint", 0, [1.0, 1.0, 1.0])
        L.dw = 1.0
        L.dtint = t
        return L
    if name in (
        "microfacet_ggx_smith_bsdf", "microfacet_ggx_vcavities_bsdf",
        "microfacet_beckmann_smith_bsdf", "microfacet_beckmann_vcavities_bsdf",
        "simple_glossy_bsdf", "ward_geisler_moroder_bsdf",
    ):
        L = _Lobes()
        t = col("tint", None, [1.0, 1.0, 1.0])
        ru = num("roughness_u", 0, 0.25)
        mode = arg("mode")
        mode_name = mode.name.split("::")[-1] if isinstance(mode, _Call) else (
            mode.name.split("::")[-1] if isinstance(mode, _Ref) else ""
        )
        L.gw = 1.0
        L.gtint = t
        L.grough = min(1.0, max(0.0, ru)) ** 0.5  # roughness_u is alpha
        if max(t) - min(t) > 1e-6 or max(t) < 1.0 - 1e-6:
            L.gw_tinted = 1.0
        if "transmit" in mode_name:
            L.tw = 1.0
            L.ttint = t
        return L
    if name == "specular_bsdf":
        L = _Lobes()
        t = col("tint", 0, [1.0, 1.0, 1.0])
        mode = arg("mode")
        mode_name = mode.name.split("::")[-1] if isinstance(mode, (_Call, _Ref)) else ""
        L.gw = 1.0
        L.gtint = t
        if "transmit" in mode_name:
            L.tw = 1.0
            L.ttint = t
        return L
    if name in ("diffuse_transmission_bsdf",):
        L = _Lobes()
        L.tw = 1.0
        L.ttint = col("tint", 0, [1.0, 1.0, 1.0])
        return L
    if name.endswith("hair_bsdf"):
        L = _Lobes()
        L.hair = True
        return L
    if name == "weighted_layer" or name == "color_weighted_layer":
        w = num("weight", 0, 1.0)
        wc = col("weight", 0) if name.startswith("color") else None
        layer = _fold_df(arg("layer", 1), env) or _Lobes()
        base = _fold_df(arg("base", 2), env) or _Lobes()
        out = layer.scaled(w, wc)
        out.add(base.scaled(1.0 - w))
        return out
    if name in ("fresnel_layer", "color_fresnel_layer"):
        i = num("ior", 0, 1.5)
        w = num("weight", None, 1.0)
        f0 = ((i - 1.0) / (i + 1.0)) ** 2
        layer = _fold_df(arg("layer"), env) or _Lobes()
        base = _fold_df(arg("base"), env) or _Lobes()
        out = layer.scaled(w * f0)
        out.add(base.scaled(1.0 - w * f0))
        out.ior = i
        out.spec_level = min(1.0, w * f0 / 0.08)
        return out
    if name in ("custom_curve_layer", "color_custom_curve_layer"):
        f0 = num("normal_reflectivity", 0, 0.04)
        w = num("weight", None, 1.0)
        layer = _fold_df(arg("layer"), env) or _Lobes()
        base = _fold_df(arg("base"), env) or _Lobes()
        out = layer.scaled(w * f0)
        out.add(base.scaled(1.0 - w * f0))
        out.spec_level = min(1.0, w * f0 / 0.08)
        return out
    if name in ("tint",):
        base = _fold_df(arg("base", 1), env) or _Lobes()
        return base.scaled(1.0, col("color", 0, [1.0, 1.0, 1.0]))
    if name in ("thin_film", "directional_factor", "measured_curve_factor"):
        return _fold_df(arg("base"), env)
    if name in ("normalized_mix", "clamped_mix", "unbounded_mix"):
        comps = arg("components", 0)
        out = _Lobes()
        total = 0.0
        if isinstance(comps, _Call) and comps.name == "__array":
            for c in comps.pos:
                if isinstance(c, _Call):
                    w = _ev(c.args.get("weight", c.pos[0] if c.pos else None), env)
                    w = float(w) if isinstance(w, (int, float)) else 1.0
                    sub = _fold_df(
                        c.args.get("component", c.pos[1] if len(c.pos) > 1 else None), env
                    )
                    if sub is not None:
                        out.add(sub.scaled(w))
                        total += w
        if name == "normalized_mix" and total > 1.0:
            out = out.scaled(1.0 / total)
        return out
    return None


def fold_material_body(
    body_text: str, defaults: Dict[str, object],
    funcs: Optional[Dict[str, object]] = None,
) -> Dict[str, object]:
    """Fold an MDL material body onto uber-BSDF parameters.

    Returns {} when the body has no recognisable df expression (caller keeps
    the name-based guess). Produced keys (matching MaterialManager.set_param
    aliases): bsdf_kind ('pbr'|'glass'|'hair'), diffuse_color_constant,
    reflection_roughness_constant, metallic_constant, specular_level,
    ior, glass_color, frosting_roughness.

    `funcs` (parse_mdl_functions registry) lets df arguments that call
    user-defined module functions or math:: intrinsics fold through the
    constant-expression interpreter (mdl_expr.eval_const).
    """
    try:
        ast, let_env = _parse_body(body_text)
    except Exception:  # noqa: BLE001 — malformed body: keep name-based guess
        return {}
    if not isinstance(ast, _Call):
        return {}
    env = dict(defaults)
    env.update(let_env)
    if funcs:
        env["__funcs__"] = funcs
    # locate surface.scattering / hair inside material(...)
    df_node = None
    ior_node = None
    if ast.name.split("::")[-1] == "material":
        ior_node = ast.args.get("ior")
        surf = ast.args.get("surface")
        if isinstance(surf, _Call):
            df_node = surf.args.get("scattering") or (surf.pos[0] if surf.pos else None)
        if ast.args.get("hair") is not None:
            hair_lobes = _fold_df(ast.args["hair"], env)
            if hair_lobes is None or True:
                return {"bsdf_kind": "hair"}
    else:
        df_node = ast
    lobes = _fold_df(df_node, env)
    if lobes is None:
        return {}
    out: Dict[str, object] = {}
    if lobes.hair:
        out["bsdf_kind"] = "hair"
        return out
    if lobes.tw > 0.3:
        out["bsdf_kind"] = "glass"
        out["glass_color"] = lobes.ttint
        if lobes.grough > 1e-6 and lobes.gw > 0:
            out["frosting_roughness"] = lobes.grough / max(lobes.gw, 1e-9)
        i = lobes.ior
        if i is None and isinstance(ior_node, _Call):
            v = _ev(ior_node, env)
            if isinstance(v, list):
                i = sum(v) / 3.0
            elif isinstance(v, float):
                i = v
        if i is not None:
            out["ior"] = i
        return out
    # pure-diffuse body (no glossy/transmission lobes): plain diffuse model
    out["bsdf_kind"] = "diffuse" if lobes.gw <= 1e-6 and lobes.dw > 1e-6 else "pbr"
    cw = lobes.dw + lobes.gw_tinted
    if cw > 1e-6:
        tint = [
            (d + g) / cw for d, g in zip(lobes.dtint, lobes.gtint)
        ] if lobes.dw <= 1e-6 else [d / max(lobes.dw, 1e-9) for d in lobes.dtint]
        out["diffuse_color_constant"] = [min(1.0, max(0.0, c)) for c in tint]
    if lobes.gw > 1e-6:
        out["reflection_roughness_constant"] = min(1.0, lobes.grough / lobes.gw)
    metallic = lobes.gw_tinted / max(lobes.gw_tinted + lobes.dw, 1e-9)
    out["metallic_constant"] = metallic
    if metallic > 0.5 and lobes.gw_tinted > 1e-6:
        out["diffuse_color_constant"] = [
            min(1.0, max(0.0, g / lobes.gw_tinted)) for g in lobes.gtint
        ]
    if lobes.spec_level is not None:
        out["specular_level"] = lobes.spec_level
    if lobes.ior is not None:
        out["ior"] = lobes.ior
    return out
