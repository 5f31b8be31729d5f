"""Name-level parity of the PyTorch port with the JAX package.

For every `.py` of `ffmpeg_tpu/` (one case each), the counterpart at the
same path under `ffmpeg_tpu_torch/` must exist and define or import every
public name of the reference module:

- the top-level `def`, `class` and assignment targets whose names do not
  start with `_` (also inside a top-level `if` or `try`);
- the entries of `__all__`, which must list the same names in the port;
- the public members of public classes: methods, and the class body's
  assignments (class attributes, dataclass fields, enum members), which
  the port's class must define in its own body.

Both packages are read as source with `ast`; neither is imported.  The
exceptions are NOT_PORTED_BY_DESIGN, each with the item of ROADMAP.md's
"Not ported, by design" that it falls under; a second test keeps that
table from going stale.
"""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
REF = REPO / "ffmpeg_tpu"
PORT = REPO / "ffmpeg_tpu_torch"

_PALLAS = ("the Pallas kernels, ported as hand-written Hopper kernels: K1 "
           "ops/huffman.py jpeg_scan_decode_packed, K2 ops/me.py "
           "sad_cost_volume_strip")

# "module path:name" -> the ROADMAP.md "Not ported, by design" item
NOT_PORTED_BY_DESIGN = {
    "models/mjpeg_pipeline.py:jitted_decode_scale":
        "the jit wrappers: build_decode_scale returns the function that "
        "runs on the device of its inputs",
    "models/mjpeg_tpu_entropy.py:MjpegTpuEntropyPipeline.fn_window":
        "the flagship's staging (fn_window/lax.map, the length sort)",
    "models/vp9_tpu.py:Vp9TpuDecoder.window_shapes":
        "the pow-2 work-list padding and program-per-geometry of VP9",
    "ops/huffman.py:jpeg_scan_decode9_pl": _PALLAS,
    "ops/huffman.py:NL_PL": _PALLAS,
    "ops/me.py:sad_cost_volume_pl": _PALLAS,
    "codecs/hevc/recon_tpu.py:INVALID":
        "the pow-2 work-list padding of HEVC (its sentinel)",
    "codecs/vp9/recon_tpu.py:INVALID":
        "the pow-2 work-list padding of VP9 (its sentinel)",
    "codecs/vp9/recon_tpu.py:SENT16":
        "the pow-2 work-list padding of VP9 (its sentinel)",
    "native.py:NativeUnavailable":
        "the Python fallback behind the host C++: the port has none, and "
        "native.get() raises NativeBuildError",
    "native.py:available":
        "the Python fallback behind the host C++: the port has none, and "
        "native.get() raises NativeBuildError",
}


def _targets(node):
    if isinstance(node, ast.Name):
        yield node.id
    elif isinstance(node, (ast.Tuple, ast.List)):
        for e in node.elts:
            yield from _targets(e)


def _top_level(body):
    """The statements of a module body, with those of top-level `if` and
    `try` blocks."""
    for node in body:
        if isinstance(node, (ast.If, ast.Try)):
            yield from _top_level(node.body + node.orelse
                                  + getattr(node, "finalbody", []))
            for h in getattr(node, "handlers", []):
                yield from _top_level(h.body)
        else:
            yield node


def _class_members(cls: ast.ClassDef) -> set:
    out = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                out.update(_targets(t))
        elif isinstance(node, ast.AnnAssign):
            out.update(_targets(node.target))
    return out


class _Names:
    """What a module defines, imports, lists in `__all__`, and the
    members of its classes."""

    def __init__(self, path: Path):
        self.defined, self.imported = set(), set()
        self.all = None
        self.members = {}
        for node in _top_level(ast.parse(path.read_text()).body):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defined.add(node.name)
            elif isinstance(node, ast.ClassDef):
                self.defined.add(node.name)
                self.members[node.name] = _class_members(node)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    self.defined.update(_targets(t))
                    if (isinstance(t, ast.Name) and t.id == "__all__"
                            and node.value is not None):
                        self.all = [ast.literal_eval(e)
                                    for e in node.value.elts]
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for a in node.names:
                    self.imported.add((a.asname or a.name).split(".")[0])

    def public(self) -> set:
        """The public names, as "name" and "Class.member"."""
        out = {n for n in self.defined if not n.startswith("_")}
        out.update(self.all or ())
        for cls, members in self.members.items():
            if not cls.startswith("_"):
                out.update(f"{cls}.{m}" for m in members
                           if not m.startswith("_"))
        return out

    def has(self, name: str) -> bool:
        if "." in name:
            cls, member = name.split(".", 1)
            return member in self.members.get(cls, ())
        return name in self.defined or name in self.imported


REF_MODULES = sorted(p.relative_to(REF).as_posix()
                     for p in REF.rglob("*.py"))


def _missing(rel: str) -> list:
    ref, port = _Names(REF / rel), _Names(PORT / rel)
    return sorted(n for n in ref.public() if not port.has(n))


def test_every_reference_module_is_counted():
    assert len(REF_MODULES) >= 234


@pytest.mark.parametrize("rel", REF_MODULES)
def test_module_public_names_ported(rel):
    assert (PORT / rel).is_file(), f"no counterpart for ffmpeg_tpu/{rel}"
    missing = [n for n in _missing(rel)
               if f"{rel}:{n}" not in NOT_PORTED_BY_DESIGN]
    assert not missing, (f"ffmpeg_tpu_torch/{rel} lacks public names of "
                         f"the reference: {missing}")
    ref_all = _Names(REF / rel).all
    if ref_all is not None:
        assert sorted(_Names(PORT / rel).all or ()) == sorted(ref_all)


@pytest.mark.parametrize("entry", sorted(NOT_PORTED_BY_DESIGN))
def test_not_ported_by_design_is_current(entry):
    """Each exception names a public name that the reference has and the
    port lacks, with its reason."""
    rel, name = entry.split(":")
    assert (REF / rel).is_file()
    assert name in _Names(REF / rel).public()
    assert name in _missing(rel)
    assert NOT_PORTED_BY_DESIGN[entry].strip()
