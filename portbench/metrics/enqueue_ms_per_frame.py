"""Dispatch: ms a frame of the program's `mjpeg.run_batch` span, the
host's enqueue of the upload and the device program (MJPEG cells)."""

from portbench.core.spans import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx, "mjpeg.run_batch")
