"""Filter graph (counterpart of ffmpeg_tpu/filters/graph.py; analog of
AVFilterGraph, libavfilter/avfiltergraph.c).

  * Whole-chain fusion: maximal runs of TraceableFilters are merged into
    a FusedChain whose composed transform is built once per input props.
    The reference jits the composition into one XLA program; the port
    calls it eagerly, one PyTorch op after another on the planes' device
    (no torch.compile, no CUDA graph).
  * Push-based execution on the host: frames enter via named inputs
    (buffersrc analog), flow through topologically, and collect at sinks
    (buffersink analog).  EOF propagates as a None sentinel so stateful
    filters (fps) can flush.
  * The graph has a device, the card unless the caller names another:
    numpy video planes fed to it are copied there once, tensor planes
    there go in as they are, and tensor planes on another device raise.
    Audio planes stay on the host; the filters that keep device state
    (the resamplers) make it on the graph's device.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch

from .. import trace
from ..core.frame import Frame, device_planes
from ..utils.error import InvalidData
from .base import Filter, TraceableFilter, get_filter


class FusedChain(TraceableFilter):
    """A run of traceable filters composed into one function."""

    name = "fused"

    def __init__(self, parts: List[TraceableFilter]):
        Filter.__init__(self)
        self.parts = parts
        self.name = "+".join(p.name for p in parts)
        self.log_name = self.name
        self._cache: Dict[object, Tuple[Callable, object]] = {}

    def make_tracer(self, props):
        hit = self._cache.get(props)
        if hit is not None:
            return hit
        trace.count("graph.tracers_built")
        fns = []
        cur = props
        for p in self.parts:
            fn, cur = p.make_tracer(cur)
            fns.append(fn)

        def composed(comps):
            for f in fns:
                comps = f(comps)
            return comps

        self._cache[props] = (composed, cur)
        return composed, cur


@dataclass
class _Node:
    filter: Filter
    name: str
    consumers: List[Tuple["_Node", int]] = field(default_factory=list)
    n_inputs_unlinked: int = 0
    eof_seen: int = 0
    is_sink: bool = False
    sink_frames: List[Frame] = field(default_factory=list)
    sink_labels: List[str] = field(default_factory=list)


class FilterGraph:
    """Build with add/link or parse_graph(); run with
    feed()/feed_eof()/pull()."""

    def __init__(self, device: torch.device | str = "cuda"):
        self.device = torch.device(device)
        self.nodes: List[_Node] = []
        self.inputs: Dict[str, _Node] = {}
        self.outputs: Dict[str, _Node] = {}
        self._sink_q: Dict[str, List[Frame]] = {}

    # --- construction --------------------------------------------------------
    def add(self, filt: Filter, name: Optional[str] = None) -> _Node:
        filt.device = self.device
        node = _Node(filter=filt, name=name or filt.name)
        self.nodes.append(node)
        return node

    def link(self, src: _Node, dst: _Node, dstpad: int = 0) -> None:
        src.consumers.append((dst, dstpad))

    def set_input(self, label: str, node: _Node) -> None:
        self.inputs[label] = node

    def set_output(self, label: str, node: _Node) -> None:
        node.is_sink = True
        node.sink_labels.append(label)
        self.outputs[label] = node
        self._sink_q.setdefault(label, [])

    def fuse(self) -> None:
        """Merge linear runs of traceable filters (call before feeding)."""
        changed = True
        while changed:
            changed = False
            for node in self.nodes:
                if not isinstance(node.filter, TraceableFilter) or node.is_sink:
                    continue
                if len(node.consumers) != 1:
                    continue
                nxt, pad = node.consumers[0]
                if not isinstance(nxt.filter, TraceableFilter):
                    continue
                if sum(1 for n in self.nodes for c, _ in n.consumers
                       if c is nxt) != 1:
                    continue
                parts = (node.filter.parts if isinstance(node.filter, FusedChain)
                         else [node.filter])
                parts2 = (nxt.filter.parts if isinstance(nxt.filter, FusedChain)
                          else [nxt.filter])
                node.filter = FusedChain(parts + parts2)
                node.consumers = nxt.consumers
                node.is_sink = nxt.is_sink
                node.sink_labels = nxt.sink_labels
                for lbl, n in list(self.outputs.items()):
                    if n is nxt:
                        self.outputs[lbl] = node
                self.nodes.remove(nxt)
                changed = True
                break

    # --- execution -----------------------------------------------------------
    def feed(self, frame: Frame, label: str = "in") -> None:
        node = self.inputs.get(label)
        if node is None:
            raise InvalidData(f"no graph input {label!r}")
        pad = getattr(node, "input_pads", {}).get(label, 0)
        if not frame.is_audio:
            frame = frame.clone_props()
            frame.planes = device_planes(frame.planes, self.device)
        self._push(node, frame, pad)

    def feed_eof(self, label: str = "in") -> None:
        node = self.inputs.get(label)
        if node is None:
            raise InvalidData(f"no graph input {label!r}")
        self._push_eof(node)

    def _push(self, node: _Node, frame: Optional[Frame], pad: int) -> None:
        outs = node.filter.process(frame, pad)
        for f in outs:
            if node.is_sink:
                for lbl in node.sink_labels:
                    self._sink_q[lbl].append(f)
            for nxt, npad in node.consumers:
                self._push(nxt, f, npad)

    def _push_eof(self, node: _Node) -> None:
        tail = node.filter.process(None, 0)
        for f in tail:
            if node.is_sink:
                for lbl in node.sink_labels:
                    self._sink_q[lbl].append(f)
            for nxt, npad in node.consumers:
                self._push(nxt, f, npad)
        for nxt, _ in node.consumers:
            self._push_eof(nxt)

    def pull(self, label: str = "out") -> List[Frame]:
        if label not in self.outputs:
            raise InvalidData(f"no graph output {label!r}")
        out = self._sink_q.get(label, [])
        self._sink_q[label] = []
        return out

    # convenience: run a full stream through a single-input/-output graph
    def run(self, frames, input_label: str = "in",
            output_label: str = "out") -> List[Frame]:
        with trace.span("graph.run"):
            out: List[Frame] = []
            for f in frames:
                self.feed(f, input_label)
                out.extend(self.pull(output_label))
            self.feed_eof(input_label)
            out.extend(self.pull(output_label))
            return out


# ---------------------------------------------------------------------------
# textual graph parser ("[in]scale=64:48,fps=30[out]" — graphparser.c analog)
# ---------------------------------------------------------------------------

_LABEL_RE = re.compile(r"\[([^\]]+)\]")


def parse_graph(text: str, device: torch.device | str = "cuda"
                ) -> FilterGraph:
    """Parse a filtergraph description into a graph on `device`.
    Supports chains separated by ';', [label] routing, and ','
    sequencing.  Unlabeled first input → 'in', unlabeled last output →
    'out'."""
    g = FilterGraph(device)
    pending_out: Dict[str, _Node] = {}   # label → producing node

    chains = [c.strip() for c in text.split(";") if c.strip()]
    for ci, chain in enumerate(chains):
        pos = 0
        prev: Optional[_Node] = None
        while pos < len(chain):
            # leading labels
            in_labels = []
            while True:
                m = _LABEL_RE.match(chain, pos)
                if not m:
                    break
                in_labels.append(m.group(1))
                pos = m.end()
            # filter name + args up to ',' ';' or '['
            m = re.match(r"\s*([a-zA-Z0-9_]+)\s*(=((?:[^,\[\]\\]|\\.)*))?",
                         chain[pos:])
            if not m:
                break
            fname = m.group(1)
            fargs = (m.group(3) or "").strip()
            pos += m.end()
            node = g.add(get_filter(fname)(fargs))
            # wire inputs (pad index increases per wired input)
            padno = 0
            if prev is not None:
                g.link(prev, node, 0)
                padno = 1
            for lbl in in_labels:
                if lbl in pending_out:
                    g.link(pending_out.pop(lbl), node, padno)
                else:
                    g.set_input(lbl, node)
                    node.input_pads = getattr(node, "input_pads", {})
                    node.input_pads[lbl] = padno
                padno += 1
            if prev is None and not in_labels:
                g.set_input("in" if ci == 0 else f"in{ci}", node)
            # trailing labels
            out_labels = []
            while True:
                m = _LABEL_RE.match(chain, pos)
                if not m:
                    break
                out_labels.append(m.group(1))
                pos = m.end()
            for lbl in out_labels:
                pending_out[lbl] = node
            prev = node
            if pos < len(chain) and chain[pos] == ",":
                pos += 1
            elif out_labels:
                prev = None
                # a comma may still follow labels
                if pos < len(chain) and chain[pos] == ",":
                    pos += 1
        if prev is not None:
            g.set_output("out" if ci == len(chains) - 1 else f"out{ci}", prev)
    # leftover labeled outputs become graph outputs
    for lbl, node in pending_out.items():
        g.set_output(lbl, node)
    g.fuse()
    return g
