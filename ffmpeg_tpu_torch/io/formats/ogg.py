"""Ogg container demuxer (reference: libavformat/oggdec.c page/packet
layer; codec mappings oggparsevorbis.c, oggparseopus.c, oggparseflac.c,
oggparsetheora.c).

Page layer: 'OggS' capture pattern, segment lacing (255-byte runs
continue a packet, a <255 segment ends it), continuation across pages
via header_type bit 0, BOS/EOS via bits 1/2, 64-bit granule position
per page. Packets are assembled per logical stream (serial number).

Codec mapping: the first packet of a BOS page identifies the codec by
magic. Vorbis keeps its three header packets as xiph-laced extradata
(the layout our vorbis decoder and the Matroska CodecPrivate path
already use); Opus keeps OpusHead; FLAC extracts the STREAMINFO block.

Timestamps: granulepos is the sample index of the last sample of the
last packet completed on a page (Opus: in 48 kHz units including
pre-skip). Opus packet durations are computed exactly from the TOC
byte, so every Opus packet carries pts/duration; Vorbis/FLAC packets
are anchored at page boundaries (first packet of a page gets the
previous page's end granule as pts), matching the reference's
granule-anchored scheme without a full setup-header parse.

The port's copy of ffmpeg_tpu/io/formats/ogg.py, held equal to it by
tests/test_torch_io_containers.py.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Optional

from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer
from ..stream import CodecParameters, MediaType

NOPTS = None


def _opus_packet_duration(data: bytes) -> int:
    """Samples at 48 kHz from the TOC byte (RFC 6716 §3.1)."""
    if not data:
        return 0
    toc = data[0]
    config = toc >> 3
    code = toc & 3
    if config < 12:
        frame = (480, 960, 1920, 2880)[config & 3]      # SILK 10..60ms
    elif config < 16:
        frame = (480, 960)[config & 1]                  # hybrid 10/20ms
    else:
        frame = (120, 240, 480, 960)[config & 3]        # CELT 2.5..20ms
    if code == 0:
        n = 1
    elif code in (1, 2):
        n = 2
    else:
        n = data[1] & 0x3F if len(data) > 1 else 0
    return frame * n


class _OggStream:
    def __init__(self, serial: int):
        self.serial = serial
        self.index = -1
        self.codec: Optional[str] = None
        self.buf = b""                 # partial packet (continuation)
        self.header_pkts: List[bytes] = []
        self.headers_needed = 0
        self.done_headers = False
        self.granule = 0               # samples at end of prev page
        self.pre_skip = 0
        self.sample_rate = 0
        self.got_data = False


@register_demuxer
class OggDemuxer(Demuxer):
    name = "ogg"
    long_name = "Ogg"
    extensions = ("ogg", "oga", "opus", "spx", "ogv")

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        if head[:4] == b"OggS" and len(head) > 5 and head[4] == 0:
            return 100
        return 0

    # --- page layer -----------------------------------------------------------
    def _read_page(self):
        """Returns (serial, header_type, granule, [segments...]) where
        segments are (data, is_packet_end)."""
        r = self.r
        # resync to capture pattern
        sync = r.read(4)
        skipped = 0
        while sync != b"OggS":
            if len(sync) < 4:
                raise EndOfStream()
            b = r.read(1)
            if not b:
                raise EndOfStream()
            sync = sync[1:] + b
            skipped += 1
            if skipped > 1 << 16:
                raise InvalidData("ogg: lost sync")
        hdr = r.read_exact(23)
        version, htype = hdr[0], hdr[1]
        if version != 0:
            raise InvalidData(f"ogg: unsupported version {version}")
        granule = struct.unpack("<q", hdr[2:10])[0]
        serial = struct.unpack("<I", hdr[10:14])[0]
        nsegs = hdr[22]
        segtab = r.read_exact(nsegs)
        segs = []
        cur = b""
        for i, sl in enumerate(segtab):
            cur += r.read_exact(sl)
            if sl < 255:
                segs.append((cur, True))
                cur = b""
        if cur:
            segs.append((cur, False))    # packet continues on next page
        return serial, htype, granule, segs

    # --- header ---------------------------------------------------------------
    def read_header(self) -> None:
        self._streams_by_serial: Dict[int, _OggStream] = {}
        self._queue: List[Packet] = []
        # Parse pages until every discovered stream has its headers.
        # BOS pages all come first (spec), so after the first non-BOS
        # page the stream set is fixed.
        saw_non_bos = False
        while True:
            pos = self.r.tell()
            try:
                serial, htype, granule, segs = self._read_page()
            except EndOfStream:
                break
            is_bos = bool(htype & 2)
            if not is_bos:
                saw_non_bos = True
            os_ = self._streams_by_serial.get(serial)
            if os_ is None:
                if not is_bos:
                    continue              # chained/unknown: ignore
                os_ = self._streams_by_serial[serial] = _OggStream(serial)
            done_before = all(s.done_headers
                              for s in self._streams_by_serial.values())
            self._page_to_packets(os_, htype, granule, segs,
                                  header_scan=True)
            if saw_non_bos and all(s.done_headers
                                   for s in self._streams_by_serial.values()):
                if self._queue or done_before:
                    break
                # headers complete and data packets may start next page
                if any(s.got_data for s in self._streams_by_serial.values()):
                    break
        if not self._streams_by_serial:
            raise InvalidData("ogg: no streams")

    def _identify(self, os_: _OggStream, first: bytes) -> None:
        par = CodecParameters(codec_type=MediaType.AUDIO)
        tb = Rational(1, 48000)
        if first[:7] == b"\x01vorbis":
            os_.codec = "vorbis"
            os_.headers_needed = 3
            if len(first) < 30:
                raise InvalidData("ogg: short vorbis id header")
            ch = first[11]
            rate = struct.unpack("<I", first[12:16])[0]
            par.codec_id = "vorbis"
            par.sample_rate = rate
            par.ch_layout = default_layout(ch)
            os_.sample_rate = rate
            tb = Rational(1, rate)
        elif first[:8] == b"OpusHead":
            os_.codec = "opus"
            os_.headers_needed = 2        # OpusHead + OpusTags
            ch = first[9]
            os_.pre_skip = struct.unpack("<H", first[10:12])[0]
            par.codec_id = "opus"
            par.sample_rate = 48000
            par.ch_layout = default_layout(ch)
            par.extradata = first
            os_.sample_rate = 48000
        elif first[:5] == b"\x7fFLAC":
            os_.codec = "flac"
            # 0x7F 'FLAC' maj min (u16 nheaders) 'fLaC' METADATA_BLOCK;
            # nheaders = following metadata packets (0 = unknown, then
            # we skip packets until an audio frame syncs with 0xFF)
            nhdr = struct.unpack(">H", first[7:9])[0]
            os_.headers_needed = 1 + nhdr
            if len(first) >= 51 and first[9:13] == b"fLaC":
                streaminfo = first[17:51]
                par.extradata = streaminfo
                rate = (streaminfo[10] << 12 | streaminfo[11] << 4
                        | streaminfo[12] >> 4)
                ch = ((streaminfo[12] >> 1) & 7) + 1
                par.codec_id = "flac"
                par.sample_rate = rate
                par.ch_layout = default_layout(ch)
                os_.sample_rate = rate
                tb = Rational(1, max(1, rate))
            else:
                raise InvalidData("ogg: bad FLAC mapping header")
        elif first[:7] == b"\x80theora":
            os_.codec = "theora"
            os_.headers_needed = 3
            par = CodecParameters(codec_type=MediaType.VIDEO,
                                  codec_id="theora")
            if len(first) >= 42:
                par.width = struct.unpack(">H", first[10:12])[0] << 4
                par.height = struct.unpack(">H", first[12:14])[0] << 4
            tb = Rational(1, 25)
        elif first[:8] == b"Speex   ":
            os_.codec = "speex"
            os_.headers_needed = 2
            par.codec_id = "speex"
            if len(first) >= 68:
                par.sample_rate = struct.unpack("<I", first[36:40])[0]
                par.ch_layout = default_layout(
                    struct.unpack("<I", first[48:52])[0])
            os_.sample_rate = par.sample_rate or 8000
            tb = Rational(1, max(1, os_.sample_rate))
        else:
            os_.codec = "unknown"
            os_.headers_needed = 1
            par = CodecParameters(codec_type=MediaType.DATA,
                                  codec_id="unknown")
        st = self.add_stream(codecpar=par, time_base=tb)
        os_.index = st.index

    def _finish_headers(self, os_: _OggStream) -> None:
        os_.done_headers = True
        if os_.codec == "vorbis":
            # xiph lacing: n-1, then lacing sizes of first n-1 pkts
            pkts = os_.header_pkts
            if len(pkts) != 3:
                raise InvalidData("ogg: vorbis needs 3 header packets")
            ed = bytes([2])
            for p in pkts[:2]:
                n = len(p)
                while n >= 255:
                    ed += b"\xff"
                    n -= 255
                ed += bytes([n])
            ed += pkts[0] + pkts[1] + pkts[2]
            self.streams[os_.index].codecpar.extradata = ed

    def _page_to_packets(self, os_: _OggStream, htype: int, granule: int,
                         segs, header_scan: bool = False) -> None:
        completed: List[bytes] = []
        for i, (data, ends) in enumerate(segs):
            if i == 0 and (htype & 1):
                if not os_.buf and not completed and os_.done_headers:
                    # continuation of a packet we never started (seek):
                    # drop it
                    if ends:
                        continue
                data = os_.buf + data
                os_.buf = b""
            if ends:
                completed.append(data)
            else:
                os_.buf = data
        for j, p in enumerate(completed):
            if os_.codec is None:
                self._identify(os_, p)
                os_.header_pkts.append(p)
                if len(os_.header_pkts) >= os_.headers_needed:
                    self._finish_headers(os_)
                continue
            if not os_.done_headers:
                os_.header_pkts.append(p)
                if len(os_.header_pkts) >= os_.headers_needed:
                    self._finish_headers(os_)
                continue
            if (os_.codec == "flac" and not os_.got_data
                    and not (len(p) >= 2 and p[0] == 0xFF
                             and (p[1] & 0xFC) == 0xF8)):
                continue          # stray metadata packet (nheaders == 0)
            os_.got_data = True
            pkt = Packet(data=p, stream_index=os_.index,
                         flags=PKT_FLAG_KEY,
                         time_base=self.streams[os_.index].time_base)
            if os_.codec == "opus":
                dur = _opus_packet_duration(p)
                pkt.duration = dur
                pkt.pts = os_.granule - os_.pre_skip
                pkt.dts = pkt.pts
                os_.granule += dur
            else:
                # anchor first packet of the page at the previous
                # page's end granule
                if j == 0 and os_.granule is not None:
                    pkt.pts = pkt.dts = os_.granule
            self._queue.append(pkt)
        if granule >= 0:
            if os_.codec == "opus":
                # trust our TOC-accumulated position; re-sync to the
                # page granule when they disagree (e.g. after seek)
                if not os_.buf and abs(os_.granule - granule) > 0:
                    os_.granule = granule
            else:
                os_.granule = granule

    # --- packets --------------------------------------------------------------
    def read_packet(self) -> Packet:
        while not self._queue:
            serial, htype, granule, segs = self._read_page()
            os_ = self._streams_by_serial.get(serial)
            if os_ is None:
                continue
            self._page_to_packets(os_, htype, granule, segs)
        return self._queue.pop(0)
