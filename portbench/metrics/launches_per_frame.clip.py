"""Dispatch: kernels a frame (the clip-graph cell)."""

from portbench.core.readers import launches_per_frame as read  # noqa: F401
