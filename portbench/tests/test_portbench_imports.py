"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the port either (top-level names compared
whole: ``pipe_tpu_torch`` is not ``pipe_tpu``)."""

import ast

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "pipe_tpu"}
PKG = ROOT / "portbench"


def imported_tops(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = imported_tops(f) & FORBIDDEN
        assert not bad, f"{f.relative_to(ROOT)} imports {bad}"


def test_the_reference_imports_nothing_of_the_port():
    for f in sorted((PKG / "reference").rglob("*.py")):
        tops = imported_tops(f)
        assert not tops & (FORBIDDEN | {"pipe_tpu_torch", "torch"}), f


def test_whole_name_comparison():
    assert "pipe_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "pipe_tpu.ops".split(".")[0] in FORBIDDEN
