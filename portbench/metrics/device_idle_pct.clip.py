"""The device's idle share of the traced window (the clip-graph cell)."""

from portbench.core.readers import device_idle_pct as read  # noqa: F401
