"""No module under portbench/ imports the JAX stack or the JAX package, or
reads the JAX-side benchmark or smoke scripts: a static scan of every
import and string, comparing each module's top-level name whole (the
port's own name begins with the JAX package's)."""
import ast
from pathlib import Path

import pytest

from portbench.common.harness import FORBIDDEN, forbidden_modules

BENCH_DIR = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH_DIR.rglob("*.py"))
NOT_READ = ("bench.py", "chip_smoke.py", "tools/")


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_forbidden_import(path):
    tree = ast.parse(path.read_text())
    tops = {name.split(".")[0] for name in _imports(tree)}
    assert not tops & set(FORBIDDEN), (path, tops & set(FORBIDDEN))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_jax_side_script_read(path):
    if path.name == Path(__file__).name:
        return
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            assert not any(node.value.endswith(n) or node.value == n
                           for n in NOT_READ), (path, node.value)


def test_top_level_names_compared_whole():
    assert forbidden_modules(["pctpu_torch", "pctpu_torch.ops", "numpy",
                              "jaxtyping", "flaxen"]) == []
    assert forbidden_modules(["pctpu.ops", "jax._src", "flax",
                              "optax"]) == ["flax", "jax", "optax", "pctpu"]
