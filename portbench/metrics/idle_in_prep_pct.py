"""Host prep: share of the traced window, in %, in which the card was idle
while the program's `mjpeg.prep` was open outside `mjpeg.prep.wait`
(MJPEG cells)."""

from portbench.core.spans import idle_in_pct


def read(ctx):
    return idle_in_pct(ctx, "mjpeg.prep", "mjpeg.prep.wait")
