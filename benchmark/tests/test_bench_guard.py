"""Nothing under ``benchmark/`` imports JAX or the JAX package, and the
reference imports nothing of the program. Module names are compared by
their top-level name, whole: the port's name begins with the JAX
package's."""

import ast
import sys
import types
from pathlib import Path

import pytest

from benchmark import run as entry

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "mode_tpu"}


def _imports(path: Path) -> set:
  tree = ast.parse(path.read_text(), filename=str(path))
  found = set()
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      found |= {a.name.split(".")[0] for a in node.names}
    elif isinstance(node, ast.ImportFrom) and node.level == 0:
      found.add(node.module.split(".")[0])
  return found


SOURCES = sorted(p for p in BENCH.rglob("*.py") if ".cache" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
  assert not _imports(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
  assert "mode_tpu_torch" not in _imports(path)
  assert _imports(path) <= {"__future__", "functools", "math", "numpy",
                            "torch", "benchmark"}


def test_the_runtime_guard_compares_whole_top_level_names(monkeypatch):
  import mode_tpu_torch  # noqa: F401  the port's name begins with mode_tpu
  assert "mode_tpu" not in entry._forbidden_modules()
  monkeypatch.setitem(sys.modules, "mode_tpu.geometry", types.ModuleType("g"))
  assert "mode_tpu" in entry._forbidden_modules()
