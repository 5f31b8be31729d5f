"""Filter graph layer (counterpart of ffmpeg_tpu/filters; libavfilter
analog).

Registers only the filters the port has: those of `video.py`.  The
reference's other 14 filter modules (`video2`-`video8`, `audio`-`audio6`,
`sources`; 111 filters) are still to port, and `get_filter` raises
FilterNotFound on their names.
"""

from .base import (Filter, TraceableFilter, filter_names, get_filter,
                   register_filter)
from .graph import FilterGraph, FusedChain, parse_graph

# register built-in filters
from . import video  # noqa: F401

__all__ = ["Filter", "TraceableFilter", "FilterGraph", "FusedChain",
           "parse_graph", "filter_names", "get_filter", "register_filter"]
