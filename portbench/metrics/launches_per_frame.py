"""Dispatch: kernels a frame (MJPEG cells)."""

from portbench.core.readers import launches_per_frame as read  # noqa: F401
