"""The port's MaterialX translation against the JAX package's.

The port keeps its own copy of `loaders/mtlx.py`, and its MaterialManager's
`create_mtlx_module` returns what the JAX one returns. On the two documents
of tests/test_materials.py (UsdPreviewSurface :45, standard_surface with an
image node :63), on a malformed document and on a MaterialDescription that
carries MaterialX code:

(a) `parse_mtlx` gives the same MaterialDescription (tests/test_torch_usd.py:
    same, no tolerance);
(b) the compiled material rows are equal;
(c) test_materials.py's own assertions hold on the port.
"""

import numpy as np
import pytest

from strelka_tpu.loaders.mtlx import parse_mtlx as jax_parse_mtlx
from strelka_tpu.materials import MaterialManager as JaxMaterialManager
from strelka_tpu.scene.scene import MaterialDescription as JaxMaterialDescription
from strelka_tpu_torch.loaders.mtlx import parse_mtlx
from strelka_tpu_torch.materials import BsdfType, MaterialManager
from strelka_tpu_torch.scene.scene import MaterialDescription

from test_materials import MTLX_DOC, MTLX_STANDARD_SURFACE  # the JAX package's own documents
from test_torch_usd import same

DOCS = {"usd_preview_surface": MTLX_DOC, "standard_surface": MTLX_STANDARD_SURFACE}


@pytest.mark.parametrize("name", sorted(DOCS))
def test_parse_mtlx_matches_jax(name):
    same(jax_parse_mtlx(DOCS[name]), parse_mtlx(DOCS[name]), "desc")


@pytest.mark.parametrize("name", sorted(DOCS))
def test_compiled_material_matches_jax(name):
    jmm, mm = JaxMaterialManager(), MaterialManager()
    jmod, mod = jmm.create_mtlx_module(DOCS[name]), mm.create_mtlx_module(DOCS[name])
    same(jmod, mod, "module")
    jmat = jmm.compile_material(jmm.create_material_instance(jmod, jmod.name))
    mat = mm.compile_material(mm.create_material_instance(mod, mod.name))
    same(jmat, mat, "material")


def test_malformed_document_falls_back_as_jax():
    bad = "<materialx><unclosed>"
    assert JaxMaterialManager().create_mtlx_module(bad) == MaterialManager().create_mtlx_module(bad) == "mtlx"


def test_description_with_mtlx_code_compiles_as_jax():
    """A scene material of type mtlx with code goes through create_mtlx_module (materials.py's compile path)."""
    jdesc = JaxMaterialDescription(type="mtlx", name="SR_beige", code=MTLX_DOC)
    desc = MaterialDescription(type="mtlx", name="SR_beige", code=MTLX_DOC)
    jmm, mm = JaxMaterialManager(), MaterialManager()
    jmats, mats = jmm.compile_scene_materials([jdesc]), mm.compile_scene_materials([desc])
    same(jmats, mats, "materials")
    assert mats[0].metallic == pytest.approx(0.25)
    same(jmm.generate_target_code(jmats)._asdict(), mm.generate_target_code(mats)._asdict(), "table")


def test_mtlx_usdpreviewsurface_translate():
    """tests/test_materials.py:45 on the port."""
    desc = parse_mtlx(MTLX_DOC)
    assert desc.name == "SR_beige"
    np.testing.assert_allclose(desc.params["diffuse_color_constant"], [0.8, 0.62, 0.45])
    assert desc.params["metallic_constant"] == pytest.approx(0.25)
    assert desc.params["reflection_roughness_constant"] == pytest.approx(0.35)
    assert desc.params["ior"] == pytest.approx(1.52)
    mm = MaterialManager()
    mat = mm.compile_material(mm.create_material_instance(mm.create_mtlx_module(MTLX_DOC), "SR_beige"))
    assert mat.bsdf_type == BsdfType.OMNI_PBR
    assert mat.metallic == pytest.approx(0.25)
    np.testing.assert_allclose(mat.diffuse_color, [0.8, 0.62, 0.45], rtol=1e-6)


def test_mtlx_standard_surface_with_texture():
    """tests/test_materials.py:63 on the port."""
    desc = parse_mtlx(MTLX_STANDARD_SURFACE)
    assert desc.params["reflection_roughness_constant"] == pytest.approx(0.6)
    assert desc.params["diffuse_texture"] == "textures/wood.png"
