"""Nothing under portbench imports JAX or the JAX package (top-level
names compared whole: ``tpumil_torch`` is not ``tpumil``), the plain
references import nothing of the port, and nothing reads the JAX
package's old benchmark records."""

from __future__ import annotations

import ast

import pytest

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "tpumil"}
OLD_RECORDS = ("bench.py", "benchmarks/", "BASELINE", "BENCH_r",
               "MULTICHIP_r")
SOURCES = sorted((REPO / "portbench").rglob("*.py"))


def imported_tops(path):
    tree = ast.parse(path.read_text(), str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(REPO)) for p in SOURCES])
def test_no_jax_and_no_port_in_references(path):
    tops = imported_tops(path)
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    if "reference" in path.relative_to(REPO).parts:
        assert "tpumil_torch" not in tops
        assert tops <= {"__future__", "math", "typing", "concurrent",
                        "numpy", "torch", "PIL", "portbench"}, tops


def test_the_guard_compares_whole_names():
    from portbench.harness import FORBIDDEN_MODULES

    assert "tpumil" in FORBIDDEN_MODULES
    assert "tpumil_torch".split(".")[0] not in FORBIDDEN_MODULES


def test_no_old_records_read():
    for path in SOURCES:
        if path.parent.name == "tests":
            continue
        text = path.read_text()
        assert not any(r in text for r in OLD_RECORDS), path
