"""The port's modules depend one way: nn/ -> ops/ -> {kernels/,
engine/autotune} -> {utils/, sparse/, engine/context}. The choice of kernel
lives in ops/: no kernel module imports the router (``engine.autotune``,
``ops``, ``nn``), and engine/autotune.py, which measures and caches the
candidates the router hands it, imports no ``kernels``, ``ops`` or ``nn``.
An AST scan of every import statement, at module level or inside a
function."""

import ast
from pathlib import Path

import pytest

PKG = "caffe_escoin_tpu_torch"
ROOT = Path(__file__).resolve().parents[1] / PKG

# file under the package -> the modules (and their submodules) it may not
# import
REFUSED = {
    **{f"kernels/{p.name}": ("engine.autotune", "ops", "nn")
       for p in sorted((ROOT / "kernels").glob("*.py"))},
    "engine/autotune.py": ("kernels", "ops", "nn"),
}


def _imported(source: str, package: str):
    """Every module an import statement of ``source`` (a module of
    ``package``) names, relative imports resolved, and every name a
    ``from`` import takes from it (a submodule, or an attribute, which no
    refused prefix can match by mistake)."""
    parts = package.split(".")
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                up = parts[:len(parts) - node.level + 1]
                base = ".".join(up + ([base] if base else []))
            yield base
            yield from (f"{base}.{a.name}" for a in node.names)


def _refused_imports(source, package, refused):
    refused = [f"{PKG}.{m}" for m in refused]
    return sorted({name for name in _imported(source, package)
                   for r in refused
                   if name == r or name.startswith(r + ".")})


@pytest.mark.parametrize("rel", sorted(REFUSED))
def test_module_imports_nothing_above_it(rel):
    path = ROOT / rel
    package = ".".join((PKG,) + Path(rel).parent.parts)
    bad = _refused_imports(path.read_text(), package, REFUSED[rel])
    assert not bad, f"{rel} imports {bad}"


def test_the_scan_sees_function_level_and_relative_imports():
    src = ("import torch\n\n\ndef late():\n"
           "    from caffe_escoin_tpu_torch.engine import autotune\n"
           "    from ..ops import conv\n"
           "    from . import sconv_fused\n")
    package = f"{PKG}.kernels"
    assert _refused_imports(src, package, REFUSED["kernels/lrn.py"]) == [
        f"{PKG}.engine.autotune", f"{PKG}.ops", f"{PKG}.ops.conv"]
    assert f"{PKG}.kernels.sconv_fused" in set(_imported(src, package))
