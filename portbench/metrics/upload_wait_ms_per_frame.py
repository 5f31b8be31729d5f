"""Copy to the card: ms a frame of the program's `mjpeg.prep.wait` span,
the host blocked until the last upload has left the pinned buffer (MJPEG
cells)."""

from portbench.core.spans import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx, "mjpeg.prep.wait")
