"""Structured output writers for the probe tool (analogs of
fftools/textformat/tf_{default,json,csv,flat,ini,compact,xml,mermaid}.c).

The port's copy of ffmpeg_tpu/cli/textformat.py, held equal to it by
tests/test_torch_cli.py.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List
from xml.sax.saxutils import escape, quoteattr


class Writer:
    def render(self, sections: List[tuple]) -> str:
        """sections: list of (section_name, dict) in print order."""
        raise NotImplementedError


class DefaultWriter(Writer):
    def render(self, sections):
        out = []
        for name, kv in sections:
            out.append(f"[{name.upper()}]")
            for k, v in kv.items():
                out.append(f"{k}={v}")
            out.append(f"[/{name.upper()}]")
        return "\n".join(out) + "\n"


class JsonWriter(Writer):
    def render(self, sections):
        grouped: Dict[str, Any] = {}
        for name, kv in sections:
            if name in ("stream", "packet", "frame", "chapter"):
                grouped.setdefault(name + "s", []).append(kv)
            else:
                grouped[name] = kv
        return json.dumps(grouped, indent=4) + "\n"


class CsvWriter(Writer):
    def render(self, sections):
        out = []
        for name, kv in sections:
            out.append(",".join([name] + [str(v) for v in kv.values()]))
        return "\n".join(out) + "\n"


class FlatWriter(Writer):
    def render(self, sections):
        out = []
        counts: Dict[str, int] = {}
        for name, kv in sections:
            idx = counts.get(name, 0)
            counts[name] = idx + 1
            prefix = f"{name}s.{name}.{idx}." if name in ("stream", "packet", "frame", "chapter") \
                else f"{name}."
            for k, v in kv.items():
                sv = v if isinstance(v, (int, float)) else f'"{v}"'
                out.append(f"{prefix}{k}={sv}")
        return "\n".join(out) + "\n"


class IniWriter(Writer):
    def render(self, sections):
        out = []
        counts: Dict[str, int] = {}
        for name, kv in sections:
            idx = counts.get(name, 0)
            counts[name] = idx + 1
            hdr = f"{name}s.{name}.{idx}" if name in ("stream", "packet", "frame", "chapter") \
                else name
            out.append(f"[{hdr}]")
            for k, v in kv.items():
                out.append(f"{k}={v}")
            out.append("")
        return "\n".join(out) + "\n"


class CompactWriter(Writer):
    def render(self, sections):
        out = []
        for name, kv in sections:
            out.append("|".join([name] +
                                [f"{k}={v}" for k, v in kv.items()]))
        return "\n".join(out) + "\n"


class XmlWriter(Writer):
    """tf_xml.c layout: one self-closing element per section with
    attribute-encoded fields, plural wrappers for repeated sections."""

    def render(self, sections):
        out = ['<?xml version="1.0" encoding="UTF-8"?>',
               '<ffprobe>']
        open_plural = None
        for name, kv in sections:
            plural = name + "s" if name in ("stream", "packet",
                                            "frame", "chapter") else None
            if plural != open_plural:
                if open_plural:
                    out.append(f"    </{open_plural}>")
                if plural:
                    out.append(f"    <{plural}>")
                open_plural = plural
            attrs = " ".join(f"{k}={quoteattr(str(v))}"
                             for k, v in kv.items())
            indent = "        " if plural else "    "
            out.append(f"{indent}<{escape(name)} {attrs}/>")
        if open_plural:
            out.append(f"    </{open_plural}>")
        out.append("</ffprobe>")
        return "\n".join(out) + "\n"


class MermaidWriter(Writer):
    """tf_mermaid.c-style entity diagram: one node per section."""

    def render(self, sections):
        out = ["graph LR"]
        counts: Dict[str, int] = {}
        prev = None
        for name, kv in sections:
            idx = counts.get(name, 0)
            counts[name] = idx + 1
            node = f"{name}_{idx}"
            label = "<br/>".join(
                f"{k}: {v}" for k, v in list(kv.items())[:6])
            out.append(f'    {node}["{name}<br/>{label}"]')
            if prev and name in ("stream", "packet", "frame", "chapter"):
                out.append(f"    {prev} --> {node}")
            prev = node
        return "\n".join(out) + "\n"


WRITERS = {
    "default": DefaultWriter,
    "json": JsonWriter,
    "csv": CsvWriter,
    "flat": FlatWriter,
    "ini": IniWriter,
    "compact": CompactWriter,
    "xml": XmlWriter,
    "mermaid": MermaidWriter,
}


def get_writer(name: str) -> Writer:
    cls = WRITERS.get(name)
    if cls is None:
        raise ValueError(f"unknown output format {name!r}")
    return cls()
