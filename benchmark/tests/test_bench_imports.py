"""Nothing under benchmark/ imports JAX or the JAX package, and the
yardstick (reference, generator, roofline, checks, traffic) imports
nothing of the port. Top-level names are compared whole: the port's
name, fourdgs_torch, begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
YARDSTICK = [p for p in FILES if "reference" in p.parts
             or p.name in ("roofline.py", "checks.py", "traffic.py", "window.py", "devtrace.py")]


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "fourdgs"}


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: str(p.relative_to(BENCH)))
def test_yardstick_imports_nothing_of_the_port(path):
    assert "fourdgs_torch" not in top_level_imports(path)


def code_strings(path: Path) -> list[str]:
    """The string literals of a file's code (docstrings left out)."""
    tree = ast.parse(path.read_text())
    docs = {id(n.value) for n in ast.walk(tree) if isinstance(n, ast.Expr)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_reads_no_older_benchmark(path):
    """No code names bench.py, its BENCH_*.json records or BASELINE.json."""
    if path == Path(__file__).resolve():
        return
    for text in code_strings(path):
        assert "bench.py" not in text and "BENCH_" not in text and "BASELINE" not in text
    assert "bench" not in top_level_imports(path)
