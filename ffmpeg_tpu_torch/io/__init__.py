"""Container and byte I/O layer (the port's counterpart of
ffmpeg_tpu/io/__init__.py; libavformat analog).

Importing the package registers the formats the port has: the reference's
demuxers and muxers of y4m, rawvideo (with s16le and f32le), wav, the
hash muxers, mjpeg/image2/image_pipe/mpegvideo, ivf, raw H.264/HEVC/VVC,
ADTS, raw MPEG audio, raw AC-3/E-AC-3, raw DTS, FLAC, GIF, Matroska,
MOV/MP4, MPEG-TS, AVI, FLV, Ogg, raw MLP/TrueHD, WebP, EXR, SRT, WebVTT,
ASS, concat/segment, tee/fifo, HLS, DASH, SDP and RTSP input, in the
reference's order of registration, so that probing and guessing by
extension pick as the reference does.  As in the reference, the RTP and
RTSP muxers register when io/formats/rtpenc.py is imported, and URLs
(http://, rtmp://, concat:, ...) open through io/protocols.py.  AV1's
OBU stream demuxer registers when the codecs package loads
(codecs/av1.py), as in the reference.  Any other format name raises
DemuxerNotFound or MuxerNotFound.

The readers io/adts.py, io/ivf.py and io/mjpeg.py stand beside the
registry and give the same packets as its demuxers.
"""

from . import avio
from .demux import Demuxer, open_input, probe_format, demuxer_names
from .mux import Muxer, open_output, muxer_names
from .stream import CodecParameters, MediaType, StreamInfo

# register the ported formats, in the reference's order
from .formats import exrfmt, tee_fifo, webvtt, wav, y4m, rawvideo, hashenc, img_mjpeg, mov, flac, adts, matroska, matroskaenc, movenc, mpegts, avi, concat_seg, srt, gif, hls, mp3raw, h26x, ac3raw, dtsraw, ivf, dash, dashenc, webpfmt, rtp, assfmt, ogg, flv, mlpraw  # noqa: F401,E501

__all__ = [
    "avio", "Demuxer", "Muxer", "open_input", "open_output", "probe_format",
    "demuxer_names", "muxer_names", "CodecParameters", "MediaType",
    "StreamInfo",
]
