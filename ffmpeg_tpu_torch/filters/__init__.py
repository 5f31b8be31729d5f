"""Filter graph layer (counterpart of ffmpeg_tpu/filters; libavfilter
analog).

Registers the filters the port has: those of `video.py`-`video8.py`,
`sources.py` and `audio.py`.  The reference's host audio filters
(`audio2`-`audio6`, 29 filters) are still to port, and `get_filter`
raises FilterNotFound on their names.
"""

from .base import (Filter, TraceableFilter, filter_names, get_filter,
                   register_filter)
from .graph import FilterGraph, FusedChain, parse_graph

# register built-in filters
from . import (video, video2, video3, video4, video5, video6,  # noqa: F401
               video7, video8, audio, sources)

__all__ = ["Filter", "TraceableFilter", "FilterGraph", "FusedChain",
           "parse_graph", "filter_names", "get_filter", "register_filter"]
