"""The device's idle share of the traced window (MJPEG cells)."""

from portbench.core.readers import device_idle_pct as read  # noqa: F401
