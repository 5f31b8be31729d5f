"""The reference's demuxers that the port has not copied yet, as probe
claims only: each keeps its name, extensions and probe (the reference's
scores, copied from the module named beside it), so that the port's
probe_format ranks a file as the reference's does.  Where one of these
wins, the port raises DemuxerNotFound naming the module, where otherwise
a ported demuxer with a lower score could take a file that is not its
own.  Left is AV1's OBU stream alone, which waits for codecs/av1.py.

REFERENCE_ORDER is the reference's order of registration: ties in score
go to the first registered, there as here.  (The reference's codecs/av1.py
registers "obu" when its codecs package loads, so there its place follows
the order of imports; no other demuxer scores an OBU stream's head.)
"""

from __future__ import annotations

# the reference registry's demuxer names, in its order of registration
REFERENCE_ORDER = (
    "exr_pipe", "webvtt", "wav", "yuv4mpegpipe", "rawvideo", "s16le",
    "mjpeg", "image2", "image_pipe", "mpegvideo", "mov", "flac", "aac",
    "matroska", "mpegts", "avi", "concat", "srt", "gif", "hls", "mp3",
    "h264", "vvc", "hevc", "obu", "ac3", "eac3", "dts", "ivf", "dash",
    "webp_pipe", "sdp", "rtsp", "ass", "ogg", "flv", "mlp", "truehd")


class Claim:
    """An unported demuxer: its name, extensions, module and probe."""

    name = "?"
    module = ""
    extensions: tuple = ()

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        return 0


def _claim(name: str, module: str, extensions: tuple, probe):
    return type(f"Claim_{name}", (Claim,), {
        "name": name, "module": module, "extensions": extensions,
        "probe": classmethod(probe)})


def _obu_types(data: bytes) -> list:
    """The OBU types of a byte string in obu_has_size_field form
    (codecs/av1.py split_obus); ValueError where it is malformed."""
    out, pos, n = [], 0, len(data)
    while pos < n:
        hdr = data[pos]
        pos += 1
        if hdr & 0x80:
            raise ValueError("obu_forbidden_bit")
        if (hdr >> 2) & 1:
            if pos >= n:
                raise ValueError("truncated obu extension")
            pos += 1
        if (hdr >> 1) & 1:
            size = 0
            for i in range(8):
                if pos >= n:
                    raise ValueError("truncated leb128")
                b = data[pos]
                pos += 1
                size |= (b & 0x7F) << (7 * i)
                if not b & 0x80:
                    break
            else:
                raise ValueError("leb128 too long")
        else:
            size = n - pos
        if pos + size > n:
            raise ValueError("obu overruns buffer")
        out.append((hdr >> 3) & 0xF)
        pos += size
    return out


def _obu_probe(cls, head: bytes, filename: str = "") -> int:
    if len(head) >= 2 and head[0] == 0x12 and head[1] == 0x00:
        try:
            types = _obu_types(bytes(head[:64]))
        except ValueError:
            types = []
        if 1 in types:                       # OBU_SEQUENCE_HEADER
            return 75
        return 25 if types else 0
    return 0


CLAIMS = {c.name: c for c in (
    _claim("obu", "codecs/av1.py", ("obu",), _obu_probe),
)}
