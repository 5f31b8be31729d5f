"""Host prep: ms a frame of `prep_frame` (MJPEG cells)."""

from portbench.core.readers import prep_ms_per_frame as read  # noqa: F401
