"""Material system — the equivalent of the MDL pipeline (layer L2).

Copied from the JAX package (strelka_tpu/materials.py); host numpy only.
A texture parameter loads its file through the manager's TextureManager
(textures.py); MaterialX documents go through loaders/mtlx.py.

The reference compiles MDL/MaterialX source to per-material PTX through the
MDL SDK (src/materialmanager/: createModule -> createMaterialInstance ->
compileMaterial -> generateTargetCode, materialmanager.cpp:524-609) and binds
each material's argument block to an OptiX hit group.

On TPU, runtime codegen per material would defeat XLA: instead, materials
compile to ROWS OF A DENSE SoA PARAMETER TABLE consumed by a fixed,
jit-traceable uber-BSDF (refport.ops.bsdf). The capability surface is the
same — N materials, runtime-settable parameters, textures — with the
arg-block equivalent being the parameter table row (set_param writes a row
field, mirroring materialmanager.cpp:413-440).

Supported material models (the ones the reference's data path produces):
  * default.mdl   -> DIFFUSE     (OptixRender.cpp:1070-1097 fallback)
  * OmniPBR.mdl   -> OMNI_PBR    (gltfloader.cpp:304-356, metal/rough GGX)
  * OmniGlass.mdl -> OMNI_GLASS  (gltfloader.cpp:358-404, smooth dielectric)
  * MaterialX / UsdPreviewSurface networks are translated onto OMNI_PBR
    parameters (mirrors MtlxMdlCodeGen + HdStrelkaMaterial param mapping).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from refport import log
from refport.scene.scene import MaterialDescription


class BsdfType:
    DIFFUSE = 0
    OMNI_PBR = 1
    OMNI_GLASS = 2
    HAIR = 3  # hair df path (mdlPtxCodeGen.cpp:143-158)


class MaterialTable(NamedTuple):
    """Dense device-side material parameters (the arg-block equivalent).

    All arrays have leading dim M (number of compiled materials).
    Texture ids index the texture atlas; -1 means constant parameter.
    """

    bsdf_type: np.ndarray  # [M] int32
    diffuse_color: np.ndarray  # [M,3] f32 (albedo / base color)
    metallic: np.ndarray  # [M] f32
    roughness: np.ndarray  # [M] f32
    specular_level: np.ndarray  # [M] f32 (F0 scale: F0 = 0.08 * level)
    ior: np.ndarray  # [M] f32
    glass_color: np.ndarray  # [M,3] f32 (transmission tint)
    emission_color: np.ndarray  # [M,3] f32 (color * intensity, 0 = off)
    opacity: np.ndarray  # [M] f32
    thin_walled: np.ndarray  # [M] int32
    diffuse_tex: np.ndarray  # [M] int32
    normal_tex: np.ndarray  # [M] int32
    roughness_tex: np.ndarray  # [M] int32
    metallic_tex: np.ndarray  # [M] int32
    uv_scale: np.ndarray  # [M,2] f32
    uv_offset: np.ndarray  # [M,2] f32


@dataclass
class CompiledMaterial:
    """One compiled material instance (mirrors TargetCode+arg-block pairing)."""

    name: str = ""
    bsdf_type: int = BsdfType.DIFFUSE
    diffuse_color: np.ndarray = field(default_factory=lambda: np.array([0.7, 0.7, 0.7], np.float32))
    metallic: float = 0.0
    roughness: float = 0.5
    specular_level: float = 0.5
    ior: float = 1.491  # OmniGlass default
    glass_color: np.ndarray = field(default_factory=lambda: np.ones(3, np.float32))
    emission_color: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    emissive_intensity: float = 1.0  # OmniPBR.mdl scales emissive_color by this
    enable_emission: bool = True
    opacity: float = 1.0
    thin_walled: bool = False
    diffuse_tex: int = -1
    normal_tex: int = -1
    roughness_tex: int = -1
    metallic_tex: int = -1
    uv_scale: np.ndarray = field(default_factory=lambda: np.ones(2, np.float32))
    uv_offset: np.ndarray = field(default_factory=lambda: np.zeros(2, np.float32))


# MDL/MaterialX/UsdPreviewSurface parameter name -> CompiledMaterial field.
# Mirrors the param names produced by gltfloader.cpp:304-421 and
# HdStrelka/Material.cpp:52-163 (UsdPreviewSurface inputs).
_FLOAT3_PARAMS = {
    "diffuse_color_constant": "diffuse_color",
    "diffuseColor": "diffuse_color",
    "baseColor": "diffuse_color",
    "base_color": "diffuse_color",
    "glass_color": "glass_color",
    "transmission_color": "glass_color",
    "emissive_color": "emission_color",
    "emissiveColor": "emission_color",
}
_FLOAT_PARAMS = {
    "reflection_roughness_constant": "roughness",
    "roughness": "roughness",
    "frosting_roughness": "roughness",
    "metallic_constant": "metallic",
    "metallic": "metallic",
    "specular_level": "specular_level",
    "ior": "ior",
    "glass_ior": "ior",
    "opacity": "opacity",
    "opacity_constant": "opacity",
    "emissive_intensity": "emissive_intensity",
}
_BOOL_PARAMS = {
    "thin_walled": "thin_walled",
    "enable_emission": "enable_emission",
    "enable_opacity": None,  # accepted, no-op (alpha handled by opacity value)
}
_TEXTURE_PARAMS = {
    "diffuse_texture": "diffuse_tex",
    "normalmap_texture": "normal_tex",
    "reflectionroughness_texture": "roughness_tex",
    "metallic_texture": "metallic_tex",
}


class MaterialManager:
    """Facade mirroring include/materialmanager/materialmanager.h:11-89.

    create_module/create_material_instance/compile_material keep the
    reference pipeline's shape; generate_target_code packs the dense table
    (the analog of PTX + arg blocks, materialmanager.cpp:524-609 including
    dedup of identical compiled materials).
    """

    def __init__(self, texture_manager=None) -> None:
        import os

        self._search_paths: List[str] = []
        self.texture_manager = texture_manager
        self._compiled: List[CompiledMaterial] = []
        # builtin material library (the reference resolves default.mdl /
        # OmniPBR.mdl / OmniGlass.mdl from data/materials/mdl at cwd,
        # OptixRender.cpp:1070-1097): the copy frozen beside this file
        builtin = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mdl")
        if os.path.isdir(builtin):
            self._search_paths.append(builtin)

    def add_mdl_search_path(self, path: str) -> None:
        self._search_paths.append(path)

    # -- pipeline stages (shape parity with the reference) --
    def create_module(self, file: str):
        """Load (or name-resolve) an MDL module (mdlMaterialCompiler.cpp:40-50).

        Returns an MdlModule when the file exists on a search path (parsed
        parameter defaults become the arg-block initial values), else the
        bare file name (model selection by name only).
        """
        from refport.loaders.mdl import load_mdl_module

        if file and file.endswith(".mdl"):
            module = load_mdl_module(file, self._search_paths)
            if module is not None:
                return module
        return file

    def create_mtlx_module(self, mtlx_code: str):
        """MaterialX source -> parsed description (MtlxMdlCodeGen::translate)."""
        from refport.loaders.mtlx import parse_mtlx

        try:
            return parse_mtlx(mtlx_code)
        except Exception as e:  # noqa: BLE001 — malformed docs fall back
            log.warning("mtlx translate failed: {}", e)
            return "mtlx"

    def create_material_instance(self, module, name: str) -> Dict:
        return {"module": module, "name": name, "params": {}}

    def compile_material(self, instance: Dict, desc: Optional[MaterialDescription] = None) -> CompiledMaterial:
        """Fold module defaults + MaterialDescription params into a row."""
        from refport.loaders.mdl import MdlModule

        module = instance["module"]
        module_name = ""
        module_defaults: Dict[str, object] = {}
        if isinstance(module, MdlModule):
            module_name = module.path.lower()
            want = instance.get("name", "")
            mats = module.materials
            if mats:
                key = want if want in mats else next(iter(mats))
                module_defaults = mats[key]
        elif isinstance(module, MaterialDescription):
            # pre-parsed mtlx description
            module_name = (module.file or "mtlx").lower()
            module_defaults = dict(module.params)
        else:
            module_name = str(module).lower()

        mat = CompiledMaterial(name=instance.get("name", ""))
        # df-body folding first (mdlPtxCodeGen compile equivalent): the
        # body's layered/weighted df tree decides the BSDF model and the
        # effective defaults; the module-NAME guess is only the fallback
        # for bodies the folder can't interpret
        folded: Dict[str, object] = {}
        folded_key = None
        if isinstance(module, MdlModule) and module_defaults is not None:
            for k, v in module.materials.items():
                if v is module_defaults:
                    folded_key = k
                    break
            if folded_key is not None:
                folded = dict(module.folded(folded_key))
        kind = folded.pop("bsdf_kind", None)
        if kind == "hair" or (isinstance(module, MdlModule) and module.has_hair):
            mat.bsdf_type = BsdfType.HAIR
        elif kind == "glass":
            mat.bsdf_type = BsdfType.OMNI_GLASS
        elif kind == "pbr":
            mat.bsdf_type = BsdfType.OMNI_PBR
        elif kind == "diffuse":
            mat.bsdf_type = BsdfType.DIFFUSE
        elif "hair" in module_name:
            mat.bsdf_type = BsdfType.HAIR
        elif "omniglass" in module_name:
            mat.bsdf_type = BsdfType.OMNI_GLASS
        elif "omnipbr" in module_name or "mtlx" in module_name:
            mat.bsdf_type = BsdfType.OMNI_PBR
        else:
            mat.bsdf_type = BsdfType.DIFFUSE
        for pname, pval in module_defaults.items():
            self.set_param(mat, pname, pval)
        for pname, pval in folded.items():
            self.set_param(mat, pname, pval)
        if desc is not None:
            if desc.has_color:
                mat.diffuse_color = np.asarray(desc.color, np.float32)
            for pname, pval in desc.params.items():
                self.set_param(mat, pname, pval)
        return mat

    def set_param(self, mat: CompiledMaterial, name: str, value) -> None:
        """Arg-block write equivalent (materialmanager.cpp:413-440)."""
        if name in _FLOAT3_PARAMS:
            setattr(mat, _FLOAT3_PARAMS[name], np.asarray(value, np.float32).reshape(3))
        elif name in _FLOAT_PARAMS:
            setattr(mat, _FLOAT_PARAMS[name], float(np.asarray(value).reshape(-1)[0]))
        elif name in _BOOL_PARAMS:
            if _BOOL_PARAMS[name] is not None:
                setattr(mat, _BOOL_PARAMS[name], bool(value))
        elif name in _TEXTURE_PARAMS:
            tex_id = -1
            if self.texture_manager is not None and isinstance(value, str):
                tex_id = self.texture_manager.load(value, srgb=(name == "diffuse_texture"))
            setattr(mat, _TEXTURE_PARAMS[name], tex_id)
        elif name in ("uv_scale", "st_scale"):
            mat.uv_scale = np.asarray(value, np.float32).reshape(2)
        elif name in ("uv_offset", "st_offset"):
            mat.uv_offset = np.asarray(value, np.float32).reshape(2)
        else:
            log.debug("MaterialManager: ignoring unknown param '{}'", name)

    def dump_params(self, mat: CompiledMaterial) -> str:
        """Debug print of a compiled material's effective parameters
        (Context::dumpParams parity, materialmanager.cpp:337-411)."""
        lines = [f"material {mat.name or '<anonymous>'} (bsdf_type={mat.bsdf_type})"]
        for f in (
            "diffuse_color", "metallic", "roughness", "specular_level", "ior",
            "glass_color", "emission_color", "emissive_intensity",
            "enable_emission", "opacity", "thin_walled", "diffuse_tex",
            "normal_tex", "roughness_tex", "metallic_tex", "uv_scale", "uv_offset",
        ):
            v = getattr(mat, f)
            if isinstance(v, np.ndarray):
                v = np.asarray(v).tolist()
            lines.append(f"  {f} = {v}")
        text = "\n".join(lines)
        log.debug("{}", text)
        return text

    def compile_scene_materials(self, descs: List[MaterialDescription]) -> List[CompiledMaterial]:
        """createOptixMaterials equivalent (OptixRender.cpp:1270-1433)."""
        compiled = []
        for desc in descs:
            if desc.type == "mtlx" and desc.code:
                module = self.create_mtlx_module(desc.code)
            else:
                module = self.create_module(desc.file or desc.name or "default.mdl")
            inst = self.create_material_instance(module, desc.name)
            compiled.append(self.compile_material(inst, desc))
        if not compiled:
            compiled.append(CompiledMaterial(name="default"))
        self._compiled = compiled
        return compiled

    @staticmethod
    def material_hash(m: CompiledMaterial) -> tuple:
        """Content hash of a compiled material (name excluded) — the analog
        of the reference's dedup of identical compiled materials by MDL UUID
        hash before target-code generation (materialmanager.cpp:524-609)."""
        return (
            m.bsdf_type,
            tuple(np.asarray(m.diffuse_color, np.float32).tolist()),
            float(m.metallic), float(m.roughness), float(m.specular_level),
            float(m.ior),
            tuple(np.asarray(m.glass_color, np.float32).tolist()),
            tuple(np.asarray(m.emission_color, np.float32).tolist()),
            float(m.emissive_intensity), bool(m.enable_emission),
            float(m.opacity), bool(m.thin_walled),
            m.diffuse_tex, m.normal_tex, m.roughness_tex, m.metallic_tex,
            tuple(np.asarray(m.uv_scale, np.float32).tolist()),
            tuple(np.asarray(m.uv_offset, np.float32).tolist()),
        )

    def generate_target_code_deduped(
        self, compiled: Optional[List[CompiledMaterial]] = None
    ):
        """Dedup identical compiled materials, pack unique rows.

        Returns (MaterialTable of unique rows, remap int32 [len(compiled)])
        so scene material ids can be rewritten onto unique rows — Kitchen-
        class scenes repeat the same material across hundreds of prims.
        """
        mats = compiled if compiled is not None else self._compiled
        if not mats:
            mats = [CompiledMaterial(name="default")]
        unique: List[CompiledMaterial] = []
        index: Dict[tuple, int] = {}
        remap = np.zeros(len(mats), np.int32)
        for i, m in enumerate(mats):
            h = self.material_hash(m)
            j = index.get(h)
            if j is None:
                j = len(unique)
                unique.append(m)
                index[h] = j
            remap[i] = j
        if len(unique) < len(mats):
            log.info("Material dedup: {} descriptions -> {} unique rows", len(mats), len(unique))
        return self.generate_target_code(unique), remap

    def generate_target_code(self, compiled: Optional[List[CompiledMaterial]] = None) -> MaterialTable:
        """Pack rows into the dense SoA table (arg block/RO-data analog)."""
        mats = compiled if compiled is not None else self._compiled
        if not mats:
            mats = [CompiledMaterial(name="default")]
        return MaterialTable(
            bsdf_type=np.array([m.bsdf_type for m in mats], np.int32),
            diffuse_color=np.stack([np.asarray(m.diffuse_color, np.float32) for m in mats]),
            metallic=np.array([m.metallic for m in mats], np.float32),
            roughness=np.array([m.roughness for m in mats], np.float32),
            specular_level=np.array([m.specular_level for m in mats], np.float32),
            ior=np.array([m.ior for m in mats], np.float32),
            glass_color=np.stack([np.asarray(m.glass_color, np.float32) for m in mats]),
            emission_color=np.stack(
                [
                    np.asarray(m.emission_color, np.float32)
                    * (m.emissive_intensity if m.enable_emission else 0.0)
                    for m in mats
                ]
            ),
            opacity=np.array([m.opacity for m in mats], np.float32),
            thin_walled=np.array([int(m.thin_walled) for m in mats], np.int32),
            diffuse_tex=np.array([m.diffuse_tex for m in mats], np.int32),
            normal_tex=np.array([m.normal_tex for m in mats], np.int32),
            roughness_tex=np.array([m.roughness_tex for m in mats], np.int32),
            metallic_tex=np.array([m.metallic_tex for m in mats], np.int32),
            uv_scale=np.stack([np.asarray(m.uv_scale, np.float32) for m in mats]),
            uv_offset=np.stack([np.asarray(m.uv_offset, np.float32) for m in mats]),
        )
