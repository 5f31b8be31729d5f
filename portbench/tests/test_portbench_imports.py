"""No module under portbench/ imports JAX, its relatives or the JAX
package; the program (`ffmpeg_tpu_torch`) only outside the references
and the input generators.  Names are compared by their whole top-level
part: the program's name begins with the JAX package's."""

import ast

import pytest

from portbench import run as bench

FORBIDDEN = {"jax", "jaxlib", "flax", "ffmpeg_tpu"}
FILES = sorted(bench.HERE.rglob("*.py"))


def top_levels(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(bench.HERE)) for p in FILES])
def test_imports(path):
    names = set(top_levels(path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    rel = path.relative_to(bench.HERE).parts
    if rel[0] in ("reference", "inputs"):
        assert "ffmpeg_tpu_torch" not in names


def test_top_level_names_are_compared_whole():
    assert bench.forbidden_modules() == []
    import sys
    sys.modules["ffmpeg_tpu_torch_probe"] = sys
    try:
        assert bench.forbidden_modules() == []
        sys.modules["ffmpeg_tpu.x"] = sys
        assert bench.forbidden_modules() == ["ffmpeg_tpu"]
    finally:
        sys.modules.pop("ffmpeg_tpu_torch_probe")
        sys.modules.pop("ffmpeg_tpu.x", None)
