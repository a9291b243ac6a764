"""What the benchmark may import: nothing under benchmark/ imports JAX or
the JAX package (top-level module names compared whole: the port's name
begins with the JAX package's), and the references import nothing of the
program either."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
NEVER = {"jax", "jaxlib", "flax", "llava_align_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=[str(p.relative_to(BENCH)) for p in FILES])
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "llava_align_tpu_torch" not in top_level_imports(path)
    assert top_level_imports(path) <= {"__future__", "math", "typing", "numpy", "torch", "benchmark"}


def test_whole_name_comparison(tmp_path):
    p = tmp_path / "probe.py"
    p.write_text("import llava_align_tpu_torch.models\nfrom llava_align_tpu.models import llama\n")
    assert top_level_imports(p) == {"llava_align_tpu_torch", "llava_align_tpu"}
    assert "llava_align_tpu_torch" not in NEVER
