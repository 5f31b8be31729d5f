"""Copy to the card: device ms of the uploads a frame (MJPEG cells)."""

from portbench.core.readers import h2d_ms_per_frame as read  # noqa: F401
