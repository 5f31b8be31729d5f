"""K1's share of its roofline (MJPEG cells)."""

from portbench.core.readers import k1_roofline as read  # noqa: F401
