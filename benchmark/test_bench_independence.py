"""Nothing the benchmark runs loads jax, jaxlib, flax or the JAX package, and the
reference loads nothing of the program: top-level module names compared whole
(the program's name, strelka_tpu_torch, begins with the JAX package's)."""

import os
import re
import subprocess
import sys

import pytest

import harness

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)

LOAD_ALL = f"""
import glob, importlib.util, os, pkgutil, sys
sys.path[:0] = [{BENCH_DIR!r}, {ROOT!r}]
import harness, reference, inputs, bounds, tracing, shapes, refport
for m in pkgutil.walk_packages(refport.__path__, "refport."):
    importlib.import_module(m.name)
for path in glob.glob(os.path.join({BENCH_DIR!r}, "metrics", "*.py")) + glob.glob(os.path.join({BENCH_DIR!r}, "scenes", "*.py")):
    spec = importlib.util.spec_from_file_location("m_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
{{body}}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level_names(body: str = "") -> set:
    out = subprocess.run([sys.executable, "-c", LOAD_ALL.replace("{body}", body)], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_forbidden_names_compared_whole():
    assert harness.forbidden_modules(["strelka_tpu_torch", "strelka_tpu_torch.ops", "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["jax.numpy", "strelka_tpu.ops", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "strelka_tpu.ops"]


def test_harness_and_reference_load_no_jax_and_the_reference_no_program():
    names = _top_level_names()
    assert not names & {"jax", "jaxlib", "flax", "strelka_tpu"}, names
    # the harness imports the program only inside a run: the reference, loaded whole, did not
    assert "strelka_tpu_torch" not in names, names


def test_a_run_side_by_side_loads_no_jax():
    """The program's modules that a run loads, beside the reference's: still no jax."""
    body = ("import strelka_tpu_torch.render.render, strelka_tpu_torch.loaders.usd, "
            "strelka_tpu_torch.scene.testscenes, strelka_tpu_torch.kernels.bvh, strelka_tpu_torch.kernels.cones")
    names = _top_level_names(body)
    assert "strelka_tpu_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "strelka_tpu"}, names


def test_reference_sources_import_no_program():
    """No source of the reference imports the program, jax or the JAX package, at any level."""
    pattern = re.compile(r"^\s*(from|import)\s+(strelka_tpu|jax|jaxlib|flax)\b", re.M)
    sources = [os.path.join(BENCH_DIR, "reference.py")]
    for base, _, files in os.walk(os.path.join(BENCH_DIR, "refport")):
        sources += [os.path.join(base, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as fh:
            assert not pattern.search(fh.read()), path


@pytest.mark.parametrize("kind,spec", [("cornell", {}), ("box_field", {"grid": 6, "field_seed": 7})])
def test_an_added_builder_gives_the_reference_no_program(kind, spec):
    """The reference side of a frozen builder loads neither the program nor jax; the program side no jax."""
    scene = {"scene": dict(spec, kind=kind)}
    names = _top_level_names(f"inputs.load_scene('reference', {ROOT!r}, {scene!r}, 3)")
    assert not names & {"jax", "jaxlib", "flax", "strelka_tpu", "strelka_tpu_torch"}, names
    names = _top_level_names(f"inputs.load_scene('program', {ROOT!r}, {scene!r}, 3)")
    assert "strelka_tpu_torch" in names and not names & {"jax", "jaxlib", "flax", "strelka_tpu"}, names
