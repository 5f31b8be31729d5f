"""Host prep: ms a frame of the program's `mjpeg.prep.parse` span, the
Python header parse (MJPEG cells)."""

from portbench.core.spans import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx, "mjpeg.prep.parse")
