"""Nothing the harness runs imports JAX or the JAX package, and the plain
references import nothing of the program: every module under
``perfbench/`` is read with ``ast``, and each import's top-level name (the
part before the first dot) is compared whole, since the program's name
``repro_torch`` begins with the JAX package's ``repro``."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    """Top-level names of every absolute import in ``path``, and of every
    ``importlib.import_module("...")`` / ``probe("...", ...)`` call with
    a literal module name."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "probe")):
            names.add(node.args[0].value.split(".")[0])
    return names


MODULES = sorted(p for p in BENCH.rglob("*.py"))


def test_every_module_is_read():
    rel = {str(p.relative_to(BENCH)) for p in MODULES}
    assert {"run.py", "harness.py", "reference/moe_lm.py",
            "reference/purification.py", "drivers/lm_serving.py"} <= rel


@pytest.mark.parametrize("path", MODULES,
                         ids=[str(p.relative_to(BENCH)) for p in MODULES])
def test_no_jax_anywhere(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in _imports(path)


def test_the_check_compares_whole_names(tmp_path):
    ok = tmp_path / "ok.py"
    ok.write_text("import repro_torch.models\nfrom repro_torch import x\n"
                  "import jaxtyping\n")
    assert not _imports(ok) & FORBIDDEN
    bad = tmp_path / "bad.py"
    bad.write_text("from repro.core import bsm\n")
    assert _imports(bad) & FORBIDDEN == {"repro"}


def test_forbidden_modules_by_whole_name():
    from perfbench import harness

    loaded = ["repro_torch.models.moe", "jaxtyping", "reprox", "torch",
              "jax.numpy", "repro", "flax.linen", "jaxlib"]
    assert harness.forbidden_modules(loaded) == [
        "flax.linen", "jax.numpy", "jaxlib", "repro"]
