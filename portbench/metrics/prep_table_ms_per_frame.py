"""Host prep: ms a frame of the program's `mjpeg.prep.table` span, the
Huffman table: its key, the cache, the build on a miss (MJPEG cells)."""

from portbench.core.spans import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx, "mjpeg.prep.table")
