"""Nothing under perfbench/ imports JAX or the JAX package, and the
reference imports nothing of the program; names are compared whole."""
import ast
import importlib.util
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    bad = {"jax", "jaxlib", "flax", "crossloc_tpu"} & set(_top_level_imports(path))
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = set(_top_level_imports(path))
    assert not names & {"crossloc_tpu_torch", "perfbench"}, names
    assert names <= {"__future__", "math", "typing", "torch"}, names


def test_the_runs_check_compares_whole_names():
    spec = importlib.util.spec_from_file_location("perfbench_run", BENCH / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    assert run.forbidden_modules(["crossloc_tpu_torch", "crossloc_tpu_torch.ops", "torch"]) == []
    assert run.forbidden_modules(["crossloc_tpu.models", "jaxlib.xla_client", "flax"]) == \
        ["crossloc_tpu", "flax", "jaxlib"]
