"""Raw video demuxer/muxer (libavformat/rawvideodec.c / rawvideoenc.c).
Demuxer needs explicit width/height/pix_fmt/framerate options.

The port's copy of ffmpeg_tpu/io/formats/rawvideo.py, held equal to it
by tests/test_torch_io_formats.py.
"""

from __future__ import annotations

from ...core.imgutils import image_buffer_size
from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer
from ..mux import Muxer, register_muxer
from ..stream import CodecParameters, MediaType


@register_demuxer
class RawVideoDemuxer(Demuxer):
    name = "rawvideo"
    extensions = ("yuv", "rgb", "raw")

    # options (set via open_input kwargs)
    video_size = None          # (w, h)
    pixel_format = "yuv420p"
    framerate = Rational(25, 1)

    def read_header(self) -> None:
        if not self.video_size:
            raise InvalidData("rawvideo: video_size option required")
        w, h = self.video_size
        rate = self.framerate if isinstance(self.framerate, Rational) else \
            Rational(int(self.framerate), 1)
        par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="rawvideo",
                              width=w, height=h, pix_fmt=self.pixel_format,
                              framerate=rate)
        self.add_stream(codecpar=par, time_base=rate.inv())
        self._frame_size = image_buffer_size(self.pixel_format, w, h)
        self._pts = 0

    def read_packet(self) -> Packet:
        data = self.r.read(self._frame_size)
        if len(data) < self._frame_size:
            raise EndOfStream()
        pkt = Packet(data=data, pts=self._pts, dts=self._pts, duration=1,
                     stream_index=0, flags=PKT_FLAG_KEY,
                     time_base=self.streams[0].time_base)
        self._pts += 1
        return pkt


@register_muxer
class RawVideoMuxer(Muxer):
    name = "rawvideo"
    extensions = ("yuv", "rgb", "raw")
    default_video_codec = "rawvideo"
    interleave = False

    def _write_header(self) -> None:
        pass

    def _write_packet(self, pkt: Packet) -> None:
        self.w.write(pkt.data)


@register_demuxer
class PcmS16leDemuxer(Demuxer):
    """Headerless PCM (libavformat/pcmdec.c family), s16le default."""

    name = "s16le"
    extensions = ("sw", "pcm")
    sample_rate = 44100
    channels = 1

    BLOCK = 4096

    def read_header(self) -> None:
        from ...formats.channel_layout import default_layout
        par = CodecParameters(
            codec_type=MediaType.AUDIO, codec_id="pcm_s16le",
            sample_rate=self.sample_rate,
            ch_layout=default_layout(self.channels),
            block_align=2 * self.channels)
        self.add_stream(codecpar=par, time_base=Rational(1, self.sample_rate))
        self._pts = 0

    def read_packet(self) -> Packet:
        ba = self.streams[0].codecpar.block_align
        data = self.r.read(self.BLOCK * ba)
        if not data:
            raise EndOfStream()
        n = len(data) // ba
        pkt = Packet(data=data, pts=self._pts, dts=self._pts, duration=n,
                     stream_index=0, flags=PKT_FLAG_KEY,
                     time_base=self.streams[0].time_base)
        self._pts += n
        return pkt


@register_muxer
class PcmS16leMuxer(Muxer):
    name = "s16le"
    extensions = ("sw",)
    default_audio_codec = "pcm_s16le"
    interleave = False

    def _write_header(self) -> None:
        pass

    def _write_packet(self, pkt: Packet) -> None:
        self.w.write(pkt.data)


@register_muxer
class PcmF32leMuxer(Muxer):
    name = "f32le"
    default_audio_codec = "pcm_f32le"
    interleave = False

    def _write_header(self) -> None:
        pass

    def _write_packet(self, pkt: Packet) -> None:
        self.w.write(pkt.data)
