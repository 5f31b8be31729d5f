"""Filter graph layer (counterpart of ffmpeg_tpu/filters; libavfilter
analog).

Registers the filters the port has: all 125 of the reference's, those
of `video.py`-`video8.py`, `sources.py` and `audio.py`-`audio6.py`.
"""

from .base import (Filter, TraceableFilter, filter_names, get_filter,
                   register_filter)
from .graph import FilterGraph, FusedChain, parse_graph

# register built-in filters
from . import (video, video2, video3, video4, video5, video6,  # noqa: F401
               video7, video8, audio, audio2, audio3, audio4, audio5,
               audio6, sources)

__all__ = ["Filter", "TraceableFilter", "FilterGraph", "FusedChain",
           "parse_graph", "filter_names", "get_filter", "register_filter"]
