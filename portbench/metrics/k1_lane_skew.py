"""Entropy decode kernel: the mean over the window's batches of the
batch's longest segment over its mean segment, as the camera path counts
them from its generator's segment lengths (`k1_skew`).  With one lane a
segment, K1 waits on its longest lane.  A property of the traffic, not
of the program: it explains K1's time beside `k1_roofline` and moves
only with the stream.  None in a cell whose path keeps no such count."""


def read(ctx):
    skews = ctx.counts.get("k1_skew")
    return sum(skews) / len(skews) if skews else None
