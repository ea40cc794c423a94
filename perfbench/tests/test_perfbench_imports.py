"""What the benchmark may import: no JAX package anywhere under `perfbench/`,
and nothing of the program under `perfbench/reference/`. Names are compared
whole, by the part before the first dot: `lwdetr_tpu_torch` is not
`lwdetr_tpu`."""
import ast
import sys
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(PERFBENCH.parent))
JAX = {"jax", "jaxlib", "flax", "lwdetr_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


SOURCES = sorted(PERFBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_module_imports_a_jax_package(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & {"lwdetr_tpu_torch", "lwdetr_tpu"}


def test_whole_names_are_compared(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import lwdetr_tpu_torch.ops\nfrom jax import numpy\n")
    assert top_level_imports(f) & JAX == {"jax"}


def test_the_run_refuses_a_process_that_loaded_jax():
    from perfbench.lib.common import forbidden_modules

    assert forbidden_modules(["lwdetr_tpu_torch", "lwdetr_tpu_torch.ops", "torch"]) == []
    assert forbidden_modules(["flax.linen", "lwdetr_tpu.models", "jaxlib"]) == \
        ["flax", "jaxlib", "lwdetr_tpu"]
