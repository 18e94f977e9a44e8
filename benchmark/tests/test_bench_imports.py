"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
reference imports nothing of the program.  Module names are compared by
their top-level part whole, so `pix2pix3d_tpu_torch` is not `pix2pix3d_tpu`."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "pix2pix3d_tpu"}
PROGRAM = "pix2pix3d_tpu_torch"


def imported_tops(path):
    """Top-level names of every absolute import in `path`."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


SOURCES = sorted(BENCH.rglob("*.py"))


def test_the_check_sees_the_sources():
    names = {p.relative_to(BENCH).as_posix() for p in SOURCES}
    assert {"run.py", "harness/generate.py", "reference/generator.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(BENCH).as_posix())
def test_no_jax(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.relative_to(BENCH).as_posix())
def test_reference_imports_nothing_of_the_program(path):
    assert PROGRAM not in imported_tops(path)


def test_the_check_tells_the_port_from_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import pix2pix3d_tpu_torch.models\nfrom pix2pix3d_tpu.ops import x\n")
    assert imported_tops(f) & FORBIDDEN == {"pix2pix3d_tpu"}
    f.write_text("import pix2pix3d_tpu_torch.models\n")
    assert not imported_tops(f) & FORBIDDEN
