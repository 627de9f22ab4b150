"""No module of the benchmark imports JAX or the JAX package (top-level
names compared whole, so the port's own name passes), and the plain
references import nothing of the program."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(ROOT.rglob("*.py"))
NEVER = {"jax", "jaxlib", "flax", "reflow_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & NEVER


@pytest.mark.parametrize(
    "path", sorted((ROOT / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_references_take_nothing_of_the_program(path):
    assert "reflow_tpu_torch" not in top_level_imports(path)


def test_the_check_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import reflow_tpu_torch.delta\nfrom reflow_tpu import x\n")
    got = top_level_imports(p)
    assert "reflow_tpu_torch" in got and got & NEVER == {"reflow_tpu"}
