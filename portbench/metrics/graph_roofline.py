"""The fused graph's share of its roofline by bytes (the clip-graph cell)."""

from portbench.core.readers import graph_roofline as read  # noqa: F401
