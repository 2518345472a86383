"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the port's name begins with the JAX
package's), nor reads the JAX package's benchmarks; the references
import nothing of the program."""
import ast
import pathlib

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
SOURCES = sorted(p for p in PKG.rglob("*.py") if "tests" not in p.parts)


def _imports(path: pathlib.Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    PKG)))
def test_no_jax_or_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
    text = path.read_text()
    assert "BENCH_" not in text and "repro_torch.benchmarks" not in text


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for m in _imports(path):
        top = m.split(".")[0]
        assert top in {"torch", "numpy", "math", "time", "__future__",
                       "pudbench"}, m
        assert not m.startswith("pudbench.") or m.startswith(
            "pudbench.reference"), m


def test_forbidden_check_compares_whole_names():
    import pudbench.run as run
    assert set(run.FORBIDDEN) == FORBIDDEN
    assert "repro_torch".split(".")[0] not in FORBIDDEN
