"""Copy to the card: device ms of the uploads a frame (the clip-graph cell)."""

from portbench.core.readers import h2d_ms_per_frame as read  # noqa: F401
