"""Filter graph: host ms a frame of the program's `graph.run` span (the
clip-graph cell)."""

from portbench.core.spans import ms_per_frame


def read(ctx):
    return ms_per_frame(ctx, "graph.run")
