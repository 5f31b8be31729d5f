"""The arithmetic of the per-layer metrics, shared by the reader files
under metrics/ that measure one quantity in cells that report different
end-to-end metrics.  Each takes the traced run's context and returns the
value, or None where it finds nothing to read (never 0 for a share)."""

from .peaks import bound_s
from .trace import is_copy, is_h2d

K1 = "jpeg_scan_decode_packed"


def launches_per_frame(ctx):
    """Kernels the device ran in the traced window, a frame
    (torch.profiler's kernel records; copies and sets not counted)."""
    kernels = ctx.trace.op_count(lambda n: not is_copy(n))
    if not ctx.counts["frames"] or not kernels:
        return None
    return kernels / ctx.counts["frames"]


def h2d_ms_per_frame(ctx):
    """Device ms of the host-to-device copies a frame."""
    s = ctx.trace.op_seconds(is_h2d)
    if not ctx.counts["frames"] or not s:
        return None
    return s * 1e3 / ctx.counts["frames"]


def device_idle_pct(ctx):
    """Share of the traced window in which no kernel, copy or set ran on
    the card, in %."""
    w = ctx.trace.window_s
    if w <= 0 or not ctx.trace.device_ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / w)


def prep_ms_per_frame(ctx):
    """ms a frame of the program's `prep_frame`, on the host's clock
    around each call that does not also wait for the previous upload."""
    spans = ctx.counts.get("prep_s")
    if not spans:
        return None
    return sum(spans) * 1e3 / len(spans)


def k1_roofline(ctx):
    """K1's least time by the path's count of its bytes and instructions,
    at the card's published peaks, over its kernel time by name, in %."""
    if "k1_bytes" not in ctx.counts:
        return None
    t = ctx.trace.op_seconds(lambda n: K1 in n)
    if not t:
        return None
    return 100.0 * bound_s(ctx.counts["k1_bytes"], ctx.counts["k1_instr"]) / t


def recon_ms_per_frame(ctx):
    """Device ms a frame of every operation of the MJPEG path other than
    K1 and the host-to-device copy."""
    if "k1_bytes" not in ctx.counts or not ctx.counts["frames"]:
        return None
    s = ctx.trace.op_seconds(lambda n: K1 not in n and not is_h2d(n))
    return s * 1e3 / ctx.counts["frames"] if s else None


def graph_roofline(ctx):
    """The graph's least time by bytes, each frame's 4:2:0 8-bit input
    planes read once and its float32 RGB crop written once at the card's
    memory rate, over the device time of every operation but the upload,
    in %.  The count is of the task, not of how it is computed."""
    c = ctx.config
    if "crop" not in c or not ctx.counts["frames"]:
        return None
    w, h = c["src_w"], c["src_h"]
    per_frame = w * h + 2 * (-(-w // 2)) * (-(-h // 2)) \
        + 3 * c["crop"][0] * c["crop"][1] * 4
    t = ctx.trace.op_seconds(lambda n: not is_h2d(n))
    if not t:
        return None
    return 100.0 * bound_s(per_frame * ctx.counts["frames"]) / t
