"""No module of the benchmark imports JAX or the JAX package, and the plain
reference imports nothing of the port; top-level names are compared whole
(``frostnet_tpu_torch`` begins with ``frostnet_tpu``)."""
import ast

import pytest

from portbench.core import FORBIDDEN, PACKAGE


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


SOURCES = sorted(p for p in PACKAGE.rglob("*.py") if "__pycache__" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PACKAGE)))
def test_no_jax(path):
    assert not imported_tops(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((PACKAGE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "frostnet_tpu_torch" not in imported_tops(path)
    assert imported_tops(path) <= {"__future__", "contextlib", "dataclasses", "math", "typing",
                                   "numpy", "torch", "portbench"}


def test_whole_names(monkeypatch):
    import sys
    import types

    from portbench.core import forbidden_modules

    monkeypatch.setitem(sys.modules, "frostnet_tpu_torch_probe", types.ModuleType("probe"))
    monkeypatch.setitem(sys.modules, "jaxlike.sub", types.ModuleType("probe"))
    assert not {"frostnet_tpu_torch_probe", "jaxlike"} & set(forbidden_modules())
    monkeypatch.setitem(sys.modules, "frostnet_tpu.models", types.ModuleType("probe"))
    assert "frostnet_tpu" in forbidden_modules()
