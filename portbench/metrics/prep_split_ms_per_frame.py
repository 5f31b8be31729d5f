"""Host prep: ms a frame of the program's `mjpeg.prep.split` span, the
C++ destuff and split with its checks (MJPEG cells)."""

from portbench.core.spans import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx, "mjpeg.prep.split")
