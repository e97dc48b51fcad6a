"""The port and its probe import neither JAX nor the JAX package.

An AST scan of every module under strelka_tpu_torch/ and of chip_smoke.py:
no `import jax...`, `from jax... import`, `import strelka_tpu...` or
`from strelka_tpu... import` (strelka_tpu_torch itself is allowed).
"""

import ast
import os

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sources():
    files = [os.path.join(_ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(_ROOT, "strelka_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(os.path.relpath(f, _ROOT) for f in files)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "strelka_tpu")


@pytest.mark.parametrize("path", _sources())
def test_no_jax_or_reference_import(path):
    with open(os.path.join(_ROOT, path), encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module and _forbidden(node.module):
            bad.append(node.module)
    assert not bad, f"{path} imports {bad}"


def test_scan_covers_the_package():
    paths = _sources()
    assert "chip_smoke.py" in paths
    assert any(p.endswith(os.path.join("kernels", "intersect.py")) for p in paths)
    assert len(paths) >= 25
