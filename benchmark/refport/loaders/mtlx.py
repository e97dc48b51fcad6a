"""MaterialX (.mtlx) ingestion — the MtlxMdlCodeGen capability.

The reference translates MaterialX documents to MDL source via the MaterialX
SDK (src/materialmanager/mtlxMdlCodeGen.cpp:215-257) and compiles that with
the MDL toolchain. On TPU the material destination is the dense parameter
table (refport.materials), so the translation target is the SAME
parameter set — we parse the mtlx XML directly (stdlib xml.etree; the
environment has no MaterialX SDK) and find the single renderable
surface-shader element exactly like _FindSurfaceShaderElement
(mtlxMdlCodeGen.cpp:183-212).

Node-graph coverage (the shapes the mtlx stdlib data path produces):
  * <image>/<tiledimage> nodes -> texture descriptors, with uvtiling /
    uvoffset and <place2d> texcoord transforms folded to uv_scale/uv_offset
  * <multiply> chains between a texture/value and the shader input -> a
    constant multiplier folded onto the parameter
  * <mix> of two constants folded by its constant weight (texture side wins
    otherwise), <constant>, and pass-through conversion nodes
  * <nodegraph> indirection: inputs connected via nodegraph="G" output="o"
    resolve through the graph's <output> element into its internal nodes
Shading models: UsdPreviewSurface and standard_surface (the two node types
the reference's data path produces), plus <surfacematerial> indirection.

Copied from the JAX package (strelka_tpu/loaders/mtlx.py); stdlib and numpy only.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np

from refport import log
from refport.scene.scene import MaterialDescription

# mtlx input name -> our canonical material param (materials.py tables)
_PARAM_MAP = {
    # UsdPreviewSurface
    "diffuseColor": "diffuse_color_constant",
    "roughness": "reflection_roughness_constant",
    "metallic": "metallic_constant",
    "ior": "ior",
    "opacity": "opacity",
    "emissiveColor": "emissive_color",
    # standard_surface
    "base_color": "diffuse_color_constant",
    "specular_roughness": "reflection_roughness_constant",
    "metalness": "metallic_constant",
    "specular_IOR": "ior",
    "emission_color": "emissive_color",
    "transmission": "transmission",
}

_TEXTURE_PARAM_MAP = {
    "diffuseColor": "diffuse_texture",
    "base_color": "diffuse_texture",
    "roughness": "reflectionroughness_texture",
    "specular_roughness": "reflectionroughness_texture",
    "metallic": "metallic_texture",
    "metalness": "metallic_texture",
    "normal": "normalmap_texture",
}

_SURFACE_NODE_TYPES = ("UsdPreviewSurface", "standard_surface")
_IMAGE_NODE_TYPES = ("image", "tiledimage")
_MULTIPLY_NODE_TYPES = ("multiply",)
_MIX_NODE_TYPES = ("mix",)
# conversion/routing nodes resolved by following their main input
_PASSTHROUGH_TYPES = ("convert", "swizzle", "normalmap", "constant", "dot")


def _strip_ns(tag: str) -> str:
    return tag.split("}")[-1]


def _parse_value(type_str: str, value: str):
    if type_str in ("float", "integer"):
        return float(value)
    if type_str in ("color3", "vector3", "color4", "vector2"):
        return np.asarray([float(v) for v in value.split(",")], np.float32)
    if type_str == "boolean":
        return value.strip().lower() == "true"
    return value


def _input_elements(node) -> Dict[str, ET.Element]:
    return {
        c.get("name", ""): c for c in node if _strip_ns(c.tag) == "input"
    }


class _Graph:
    """Name-indexed view of one node scope (document root or a nodegraph)."""

    def __init__(self, scope: ET.Element, doc: "_Doc"):
        self.doc = doc
        self.nodes: Dict[str, ET.Element] = {
            n.get("name"): n for n in scope if n.get("name")
        }
        self.outputs: Dict[str, ET.Element] = {
            n.get("name", ""): n for n in scope if _strip_ns(n.tag) == "output"
        }


class _Doc:
    def __init__(self, root: ET.Element):
        self.root_graph = _Graph(root, self)
        self.nodegraphs: Dict[str, _Graph] = {
            n.get("name", ""): _Graph(n, self)
            for n in root
            if _strip_ns(n.tag) == "nodegraph"
        }


def _merge_mult(out: dict, factor) -> None:
    if factor is None:
        return
    fac = (
        np.asarray([float(x) for x in factor], np.float32)
        if isinstance(factor, (tuple, list, np.ndarray))
        else np.asarray([float(factor)], np.float32)
    )
    prev = out.get("mult")
    if prev is None:
        out["mult"] = fac.tolist() if fac.size > 1 else float(fac[0])
        return
    p = np.atleast_1d(np.asarray(prev, np.float32))
    k = max(len(p), len(fac))
    p = np.resize(p, k) if len(p) > 1 else np.full(k, p[0], np.float32)
    f = np.resize(fac, k) if len(fac) > 1 else np.full(k, fac[0], np.float32)
    m = p * f
    out["mult"] = m.tolist() if m.size > 1 else float(m[0])


def _resolve_input(graph: _Graph, node: ET.Element, name: str, depth: int = 0) -> dict:
    """Follow one input through the node graph. Returns a dict with any of
    value / tex / mult / uv_scale / uv_offset (the same contract as
    UsdLoader._resolve_network_input — both feed the uber-BSDF param fold)."""
    out: dict = {}
    inp = _input_elements(node).get(name)
    if inp is None or depth > 6:
        return out
    if inp.get("value") is not None:
        out["value"] = _parse_value(inp.get("type", "float"), inp.get("value"))
        return out
    # nodegraph indirection: inputs:x -> nodegraph G's output o
    ng = inp.get("nodegraph")
    if ng and ng in graph.doc.nodegraphs:
        sub = graph.doc.nodegraphs[ng]
        out_el = sub.outputs.get(inp.get("output", "")) or next(
            iter(sub.outputs.values()), None
        )
        if out_el is None:
            return out
        target = sub.nodes.get(out_el.get("nodename", ""))
        return _resolve_node(sub, target, depth + 1) if target is not None else out
    target = graph.nodes.get(inp.get("nodename", ""))
    if target is not None:
        return _resolve_node(graph, target, depth + 1)
    # lenient cross-scope lookup: hand-authored documents sometimes reference
    # nodegraph-internal nodes by bare nodename from the root scope
    for sub in graph.doc.nodegraphs.values():
        target = sub.nodes.get(inp.get("nodename", ""))
        if target is not None:
            return _resolve_node(sub, target, depth + 1)
    return out


def _resolve_node(graph: _Graph, node: ET.Element, depth: int) -> dict:
    """Fold one graph node into the {value, tex, mult, uv_*} contract."""
    if depth > 6:
        return {}
    ntype = _strip_ns(node.tag)
    ins = _input_elements(node)

    if ntype in _IMAGE_NODE_TYPES:
        out: dict = {}
        f = ins.get("file")
        if f is not None and f.get("value"):
            out["tex"] = f.get("value")
        fb = ins.get("fallback") or ins.get("default")
        if fb is not None and fb.get("value") is not None:
            out["value"] = _parse_value(fb.get("type", "color3"), fb.get("value"))
        # tiledimage uvtiling/uvoffset -> st transform
        for key, dest in (("uvtiling", "uv_scale"), ("uvoffset", "uv_offset")):
            v = ins.get(key)
            if v is not None and v.get("value") is not None:
                out[dest] = [float(x) for x in v.get("value").split(",")[:2]]
        # texcoord chain through place2d: scale/offset fold the same way
        tc = ins.get("texcoord")
        if tc is not None and tc.get("nodename"):
            p2d = graph.nodes.get(tc.get("nodename"))
            if p2d is not None and _strip_ns(p2d.tag) == "place2d":
                p_ins = _input_elements(p2d)
                sc = p_ins.get("scale")
                off = p_ins.get("offset")
                if sc is not None and sc.get("value") is not None:
                    out["uv_scale"] = [float(x) for x in sc.get("value").split(",")[:2]]
                if off is not None and off.get("value") is not None:
                    out["uv_offset"] = [float(x) for x in off.get("value").split(",")[:2]]
        return out

    if ntype in _MULTIPLY_NODE_TYPES:
        # constant side becomes a multiplier on the resolved other side
        r1 = _resolve_input(graph, node, "in1", depth + 1)
        r2 = _resolve_input(graph, node, "in2", depth + 1)
        if r1.get("tex") or ("value" in r1 and "value" not in r2):
            base, factor = r1, r2.get("value")
        else:
            base, factor = r2, r1.get("value")
        _merge_mult(base, factor)
        return base

    if ntype in _MIX_NODE_TYPES:
        fg = _resolve_input(graph, node, "fg", depth + 1)
        bg = _resolve_input(graph, node, "bg", depth + 1)
        w = _resolve_input(graph, node, "mix", depth + 1).get("value")
        if (
            w is not None
            and "value" in fg
            and "value" in bg
            and not fg.get("tex")
            and not bg.get("tex")
        ):
            wv = float(np.atleast_1d(np.asarray(w, np.float32))[0])
            a = np.atleast_1d(np.asarray(fg["value"], np.float32))
            b = np.atleast_1d(np.asarray(bg["value"], np.float32))
            k = max(len(a), len(b))
            a = np.resize(a, k)
            b = np.resize(b, k)
            v = a * wv + b * (1.0 - wv)
            return {"value": v if v.size > 1 else float(v[0])}
        # texture side wins; approximate a constant weight as a multiplier
        side = fg if (fg.get("tex") or "value" in fg) else bg
        if w is not None and side is fg:
            _merge_mult(side, w)
        return side

    if ntype in _PASSTHROUGH_TYPES:
        v = _input_elements(node).get("value")
        if ntype == "constant" and v is not None and v.get("value") is not None:
            return {"value": _parse_value(v.get("type", "float"), v.get("value"))}
        for in_name in ("in", "in1", "a"):
            if in_name in ins:
                return _resolve_input(graph, node, in_name, depth + 1)
    # unknown node: try its main input before giving up
    for in_name in ("in", "in1"):
        if in_name in ins:
            return _resolve_input(graph, node, in_name, depth + 1)
    return {}


def _find_surface_shader(root) -> Optional[ET.Element]:
    """_FindSurfaceShaderElement (mtlxMdlCodeGen.cpp:183-212): prefer the
    shader referenced by a surfacematerial, else the first surface node."""
    nodes = {n.get("name"): n for n in root if n.get("name")}
    for n in root:
        if _strip_ns(n.tag) == "surfacematerial":
            for inp in n:
                if inp.get("name") == "surfaceshader" and inp.get("nodename") in nodes:
                    cand = nodes[inp.get("nodename")]
                    if _strip_ns(cand.tag) in _SURFACE_NODE_TYPES:
                        return cand
    for n in root:
        if _strip_ns(n.tag) in _SURFACE_NODE_TYPES:
            return n
    return None


def parse_mtlx(xml_text: str, name: str = "") -> MaterialDescription:
    """MaterialX document -> MaterialDescription with canonical params."""
    root = ET.fromstring(xml_text)
    desc = MaterialDescription(type="mtlx", name=name or root.get("name", "mtlx"), file="OmniPBR.mdl")
    shader = _find_surface_shader(root)
    if shader is None:
        log.warning("mtlx: no renderable surface shader element found")
        return desc
    desc.name = shader.get("name", desc.name)
    doc = _Doc(root)
    graph = doc.root_graph

    for in_name, inp in _input_elements(shader).items():
        mapped = _PARAM_MAP.get(in_name)
        tex_param = _TEXTURE_PARAM_MAP.get(in_name)
        if mapped is None and tex_param is None:
            continue
        r = _resolve_input(graph, shader, in_name)
        val = r.get("value")
        mult = r.get("mult")
        if val is not None and mult is not None:
            v = np.atleast_1d(np.asarray(val, np.float32))
            m = np.atleast_1d(np.asarray(mult, np.float32))
            k = max(len(v), len(m))
            v = np.resize(v, k) if len(v) > 1 else np.full(k, v[0], np.float32)
            m = np.resize(m, k) if len(m) > 1 else np.full(k, m[0], np.float32)
            prod = v * m
            val = prod if prod.size > 1 else float(prod[0])
        if val is not None and mapped is not None:
            desc.params[mapped] = val
            if mapped == "diffuse_color_constant":
                desc.has_color = True
                desc.color = np.resize(np.atleast_1d(np.asarray(val, np.float32)), 3)
        if r.get("tex") and tex_param is not None:
            desc.params[tex_param] = r["tex"]
            # a multiplier over a texture folds onto the constant tint
            if mult is not None and mapped == "diffuse_color_constant" and val is None:
                desc.params[mapped] = np.resize(
                    np.atleast_1d(np.asarray(mult, np.float32)), 3
                )
        if r.get("uv_scale") is not None:
            desc.params["uv_scale"] = np.asarray(r["uv_scale"], np.float32)
        if r.get("uv_offset") is not None:
            desc.params["uv_offset"] = np.asarray(r["uv_offset"], np.float32)
    # transmission -> glass model
    if float(np.asarray(desc.params.get("transmission", 0.0)).reshape(-1)[0] if "transmission" in desc.params else 0.0) > 0.5:
        desc.file = "OmniGlass.mdl"
    return desc


def load_mtlx_file(path: str) -> Optional[MaterialDescription]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            return parse_mtlx(f.read())
    except (OSError, ET.ParseError) as e:
        log.error("mtlx load failed for {}: {}", path, e)
        return None
