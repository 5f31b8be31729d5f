"""Reconstruction: device ms a frame beside K1 and the upload (MJPEG cells)."""

from portbench.core.readers import recon_ms_per_frame as read  # noqa: F401
