"""Filter graph layer (counterpart of ffmpeg_tpu/filters; libavfilter
analog).

Registers only the filters the port has: those of `video.py` and
`audio.py`.  The reference's other 13 filter modules (`video2`-`video8`,
`audio2`-`audio6`, `sources`; 101 filters) are still to port, and
`get_filter` raises FilterNotFound on their names.
"""

from .base import (Filter, TraceableFilter, filter_names, get_filter,
                   register_filter)
from .graph import FilterGraph, FusedChain, parse_graph

# register built-in filters
from . import audio, video  # noqa: F401

__all__ = ["Filter", "TraceableFilter", "FilterGraph", "FusedChain",
           "parse_graph", "filter_names", "get_filter", "register_filter"]
