"""MPEG-TS demuxer (reference: libavformat/mpegts.c, 3.9k LoC core).

188-byte packet sync, PAT → PMT → PES reassembly with PTS/DTS parsing.

The port's copy of ffmpeg_tpu/io/formats/mpegts.py, held equal to it by
tests/test_torch_io_containers.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ...core.packet import Packet, PKT_FLAG_KEY
from ...formats.channel_layout import default_layout
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import NOPTS, Rational
from ..demux import Demuxer, register_demuxer
from ..parsers import SPLITTERS
from ..stream import CodecParameters, MediaType

TS_PACKET_SIZE = 188

# stream_type → (codec_id, media_type)
_STREAM_TYPES = {
    0x01: ("mpeg1video", MediaType.VIDEO), 0x02: ("mpeg2video", MediaType.VIDEO),
    0x03: ("mp3", MediaType.AUDIO), 0x04: ("mp3", MediaType.AUDIO),
    0x0F: ("aac", MediaType.AUDIO), 0x11: ("aac_latm", MediaType.AUDIO),
    0x10: ("mpeg4", MediaType.VIDEO),
    0x1B: ("h264", MediaType.VIDEO), 0x24: ("hevc", MediaType.VIDEO),
    0x21: ("jpeg2000", MediaType.VIDEO),
    0x81: ("ac3", MediaType.AUDIO), 0x87: ("eac3", MediaType.AUDIO),
    0x82: ("dts", MediaType.AUDIO), 0x06: ("data", MediaType.DATA),
    0xD1: ("dirac", MediaType.VIDEO), 0xEA: ("vc1", MediaType.VIDEO),
}


@dataclass
class _PesState:
    pid: int
    stream_index: int
    buffer: bytearray = field(default_factory=bytearray)
    pts: int = NOPTS
    dts: int = NOPTS
    key: bool = True
    started: bool = False


@register_demuxer
class MpegTsDemuxer(Demuxer):
    name = "mpegts"
    long_name = "MPEG-TS (MPEG-2 Transport Stream)"
    extensions = ("ts", "m2t", "m2ts", "mts")

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        score = 0
        for start in range(min(188, max(1, len(head) - 188 * 4))):
            if all(start + i * 188 < len(head) and head[start + i * 188] == 0x47
                   for i in range(4)):
                score = 50 if start else 100
                break
        return score

    def read_header(self) -> None:
        self._pmt_pids: set = set()
        self._pes: Dict[int, _PesState] = {}
        self._queue: List[Packet] = []
        self._started = False
        self._sync()
        # scan for PAT/PMT before declaring streams
        scanned = 0
        while not self._pes and scanned < 5000:
            if not self._read_ts_packet():
                break
            scanned += 1
        if not self._pes:
            raise InvalidData("mpegts: no PMT found")
        # private (0x06) streams need their first ES payload to identify
        # the codec — keep scanning (packets land in the queue, not lost)
        scanned = 0
        while any(st.codecpar.codec_id == "data"
                  for st in self.streams) and scanned < 20000:
            if not self._read_ts_packet():
                for ps in self._pes.values():
                    if ps.started and ps.buffer:
                        self._emit(ps)
                break
            scanned += 1

    def _sync(self) -> None:
        while True:
            b = self.r.peek(1)
            if not b:
                raise EndOfStream()
            if b[0] == 0x47:
                return
            self.r.skip(1)

    def _read_ts_packet(self) -> bool:
        data = self.r.read(TS_PACKET_SIZE)
        if len(data) < TS_PACKET_SIZE:
            return False
        if data[0] != 0x47:
            self._sync()
            return True
        pid = (data[1] & 0x1F) << 8 | data[2]
        pusi = bool(data[1] & 0x40)
        afc = (data[3] >> 4) & 3
        pos = 4
        if afc & 2:   # adaptation field
            af_len = data[4]
            pos = 5 + af_len
        if not (afc & 1) or pos >= TS_PACKET_SIZE:
            return True
        payload = data[pos:]

        if pid == 0:                      # PAT
            self._parse_pat(payload, pusi)
        elif pid in self._pmt_pids:
            self._parse_pmt(payload, pusi)
        elif pid in self._pes:
            self._feed_pes(self._pes[pid], payload, pusi)
        return True

    @staticmethod
    def _section(payload: bytes, pusi: bool) -> Optional[bytes]:
        if not pusi:
            return None
        ptr = payload[0]
        return payload[1 + ptr:]

    def _parse_pat(self, payload: bytes, pusi: bool) -> None:
        sec = self._section(payload, pusi)
        if not sec or sec[0] != 0x00:
            return
        slen = (sec[1] & 0x0F) << 8 | sec[2]
        i = 8
        end = 3 + slen - 4
        while i + 4 <= end:
            prog = sec[i] << 8 | sec[i + 1]
            pid = (sec[i + 2] & 0x1F) << 8 | sec[i + 3]
            if prog != 0:
                self._pmt_pids.add(pid)
            i += 4

    def _parse_pmt(self, payload: bytes, pusi: bool) -> None:
        sec = self._section(payload, pusi)
        if not sec or sec[0] != 0x02:
            return
        slen = (sec[1] & 0x0F) << 8 | sec[2]
        end = 3 + slen - 4
        pcr = (sec[8] & 0x1F) << 8 | sec[9]
        pinfo_len = (sec[10] & 0x0F) << 8 | sec[11]
        i = 12 + pinfo_len
        while i + 5 <= end:
            stype = sec[i]
            epid = (sec[i + 1] & 0x1F) << 8 | sec[i + 2]
            es_len = (sec[i + 3] & 0x0F) << 8 | sec[i + 4]
            i += 5 + es_len
            if epid in self._pes:
                continue
            codec, mtype = _STREAM_TYPES.get(stype, (f"type{stype}", MediaType.DATA))
            par = CodecParameters(codec_type=mtype, codec_id=codec)
            st = self.add_stream(codecpar=par, time_base=Rational(1, 90000))
            self._pes[epid] = _PesState(pid=epid, stream_index=st.index)

    def _feed_pes(self, ps: _PesState, payload: bytes, pusi: bool) -> None:
        if pusi:
            if ps.started and ps.buffer:
                self._emit(ps)
            ps.buffer = bytearray(payload)
            ps.started = True
        elif ps.started:
            ps.buffer += payload

    def _emit(self, ps: _PesState) -> None:
        buf = bytes(ps.buffer)
        ps.buffer = bytearray()
        if len(buf) < 9 or buf[:3] != b"\x00\x00\x01":
            return
        hdr_len = buf[8]
        flags = buf[7]
        pts = dts = NOPTS

        def ts_at(i):
            return ((buf[i] >> 1 & 7) << 30 | buf[i + 1] << 22 |
                    (buf[i + 2] >> 1) << 15 | buf[i + 3] << 7 | buf[i + 4] >> 1)

        if flags & 0x80:
            pts = ts_at(9)
            dts = ts_at(14) if flags & 0x40 else pts
        data = buf[9 + hdr_len:]
        if not data:
            return
        st = self.streams[ps.stream_index]
        if st.codecpar.codec_id == "data":
            self._sniff_es(st, data)
        splitter = SPLITTERS.get(st.codecpar.codec_id)
        if splitter is not None:
            frames, rate, rest = splitter(data)
            if rate and not st.codecpar.sample_rate:
                st.codecpar.sample_rate = rate
            step = 0
            if rate:
                nsamp = 1024 if st.codecpar.codec_id == "aac" else 1152
                step = nsamp * 90000 // rate
            for j, fr in enumerate(frames):
                self._queue.append(Packet(
                    data=fr,
                    pts=(pts + j * step) if pts != NOPTS else NOPTS,
                    dts=(dts + j * step) if dts != NOPTS else NOPTS,
                    stream_index=ps.stream_index, flags=PKT_FLAG_KEY,
                    time_base=Rational(1, 90000)))
            return
        self._queue.append(Packet(
            data=data, pts=pts, dts=dts, stream_index=ps.stream_index,
            flags=PKT_FLAG_KEY, time_base=Rational(1, 90000)))

    @staticmethod
    def _sniff_es(st, data: bytes) -> None:
        """stream_type 0x06 (private PES) carries no codec id — identify
        the ES from its first payload like mpegts.c does by probing."""
        par = st.codecpar
        if data[:2] == b"\xff\xd8":
            par.codec_id, par.codec_type = "mjpeg", MediaType.VIDEO
        elif data[:3] == b"\x00\x00\x01" and data[3:4] in (b"\xb3", b"\x00"):
            par.codec_id, par.codec_type = "mpeg2video", MediaType.VIDEO
        elif len(data) > 1 and data[0] == 0xFF and (data[1] & 0xF6) == 0xF0:
            par.codec_id, par.codec_type = "aac", MediaType.AUDIO
        elif data[:3] == b"ID3" or (len(data) > 1 and data[0] == 0xFF and
                                    (data[1] & 0xE6) in (0xE2, 0xE4, 0xE6)):
            par.codec_id, par.codec_type = "mp3", MediaType.AUDIO

    def read_packet(self) -> Packet:
        while not self._queue:
            if not self._read_ts_packet():
                # EOF: flush pending PES payloads
                for ps in self._pes.values():
                    if ps.started and ps.buffer:
                        self._emit(ps)
                if self._queue:
                    break
                raise EndOfStream()
        return self._queue.pop(0)


# ---------------------------------------------------------------------------
# Muxer (reference: libavformat/mpegtsenc.c — PAT/PMT sections with
# CRC32/MPEG-2, PES packetization with PTS/DTS + PCR, per-PID continuity)

from ..mux import Muxer, register_muxer   # noqa: E402

_CRC_TABLE = None


def _crc32_mpeg(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        tab = []
        for i in range(256):
            c = i << 24
            for _ in range(8):
                c = ((c << 1) ^ 0x04C11DB7) if c & 0x80000000 else (c << 1)
            tab.append(c & 0xFFFFFFFF)
        _CRC_TABLE = tab
    crc = 0xFFFFFFFF
    for b in data:
        crc = ((crc << 8) & 0xFFFFFFFF) ^ _CRC_TABLE[(crc >> 24) ^ b]
    return crc


_MUX_STREAM_TYPES = {
    "mpeg1video": 0x01, "mpeg2video": 0x02, "mp2": 0x03, "mp3": 0x03,
    "mpeg4": 0x10, "h264": 0x1B, "hevc": 0x24, "aac": 0x0F,
    "ac3": 0x81, "mjpeg": 0x06, "gif": 0x06, "png": 0x06,
}

_PMT_PID = 0x1000
_START_PID = 0x100


@register_muxer
class MpegtsMuxer(Muxer):
    name = "mpegts"
    extensions = ("ts", "m2t", "mts")
    default_video_codec = "mpeg2video"
    default_audio_codec = "aac"

    def _write_header(self) -> None:
        self._cc: Dict[int, int] = {}
        self._pcr_pid = None
        self._types = []
        for st in self.streams:
            stype = _MUX_STREAM_TYPES.get(st.codecpar.codec_id)
            if stype is None:
                raise InvalidData(
                    f"mpegts: cannot mux codec {st.codecpar.codec_id}")
            self._types.append(stype)
            if self._pcr_pid is None and \
                    st.codecpar.codec_type == MediaType.VIDEO:
                self._pcr_pid = _START_PID + st.index
        if self._pcr_pid is None:
            self._pcr_pid = _START_PID
        self._write_tables()
        self._pkts_since_tables = 0

    # --- sections -------------------------------------------------------------
    def _section_packet(self, pid: int, table: bytes) -> None:
        payload = b"\x00" + table          # pointer_field
        self._ts_packet(pid, payload, pusi=True, pad_sections=True)

    def _write_tables(self) -> None:
        # PAT: program 1 -> PMT pid
        pat = bytes([0x00, 0xB0, 13, 0x00, 0x01, 0xC1, 0x00, 0x00,
                     0x00, 0x01, 0xE0 | (_PMT_PID >> 8), _PMT_PID & 0xFF])
        pat += _crc32_mpeg(pat).to_bytes(4, "big")
        self._section_packet(0, pat)
        # PMT
        es = b""
        for st, stype in zip(self.streams, self._types):
            pid = _START_PID + st.index
            es += bytes([stype, 0xE0 | (pid >> 8), pid & 0xFF, 0xF0, 0x00])
        length = 13 + len(es)
        pmt = bytes([0x02, 0xB0, length, 0x00, 0x01, 0xC1, 0x00, 0x00,
                     0xE0 | (self._pcr_pid >> 8), self._pcr_pid & 0xFF,
                     0xF0, 0x00]) + es
        pmt += _crc32_mpeg(pmt).to_bytes(4, "big")
        self._section_packet(_PMT_PID, pmt)

    # --- transport packets ------------------------------------------------------
    def _ts_packet(self, pid: int, payload: bytes, pusi: bool,
                   pcr: Optional[int] = None,
                   pad_sections: bool = False) -> bytes:
        """Emit one 188-byte packet; returns unconsumed payload."""
        cc = self._cc.get(pid, 0)
        self._cc[pid] = (cc + 1) & 0xF
        hdr = bytearray(4)
        hdr[0] = 0x47
        hdr[1] = (0x40 if pusi else 0) | (pid >> 8)
        hdr[2] = pid & 0xFF
        room = 184
        af = b""
        if pcr is not None:
            base = pcr // 300
            ext = pcr % 300
            af = bytes([7, 0x10,
                        (base >> 25) & 0xFF, (base >> 17) & 0xFF,
                        (base >> 9) & 0xFF, (base >> 1) & 0xFF,
                        ((base & 1) << 7) | 0x7E | (ext >> 8), ext & 0xFF])
            room -= len(af)
        take = payload[:room]
        rest = payload[room:]
        stuffing = room - len(take)
        if stuffing and pad_sections:
            # sections are padded with 0xFF after the data
            body = af + take + b"\xFF" * stuffing
            hdr[3] = (0x30 if af else 0x10) | cc
        elif stuffing:
            # pad via adaptation field stuffing
            if af:
                af = bytes([af[0] + stuffing]) + af[1:] + b"\xFF" * stuffing
            else:
                if stuffing == 1:
                    af = b"\x00"
                else:
                    af = bytes([stuffing - 1, 0x00]) + b"\xFF" * (stuffing - 2)
            body = af + take
            hdr[3] = 0x30 | cc
        else:
            body = af + take
            hdr[3] = (0x30 if af else 0x10) | cc
        self.w.write(bytes(hdr) + body)
        return rest

    def _write_packet(self, pkt: Packet) -> None:
        st = self.streams[pkt.stream_index]
        pid = _START_PID + st.index
        if self._pkts_since_tables >= 40 or \
                (pkt.is_keyframe and self._pkts_since_tables > 0):
            self._write_tables()
            self._pkts_since_tables = 0
        self._pkts_since_tables += 1

        # rescale to 90 kHz
        pts = dts = None
        if pkt.pts != NOPTS and pkt.time_base:
            pts = pkt.pts * 90000 * pkt.time_base.num // pkt.time_base.den
            d = pkt.dts if pkt.dts != NOPTS else pkt.pts
            dts = d * 90000 * pkt.time_base.num // pkt.time_base.den
        sid = 0xE0 if st.codecpar.codec_type == MediaType.VIDEO else 0xC0

        pes = bytearray(b"\x00\x00\x01")
        pes.append(sid)
        flags = 0
        hdata = b""
        if pts is not None:
            if dts != pts:
                flags = 0xC0
                hdata = _pes_ts(0x3, pts) + _pes_ts(0x1, dts)
            else:
                flags = 0x80
                hdata = _pes_ts(0x2, pts)
        body_len = 3 + len(hdata) + len(pkt.data)
        pes += (body_len if body_len <= 0xFFFF else 0).to_bytes(2, "big")
        pes += bytes([0x80, flags, len(hdata)])
        pes += hdata
        pes += pkt.data

        payload = bytes(pes)
        first = True
        while payload:
            pcr = None
            if first and pid == self._pcr_pid and dts is not None:
                pcr = max(dts - 9000, 0) * 300
            payload = self._ts_packet(pid, payload, pusi=first, pcr=pcr)
            first = False

    def _write_trailer(self) -> None:
        pass


def _pes_ts(prefix: int, ts: int) -> bytes:
    ts &= (1 << 33) - 1
    return bytes([(prefix << 4) | ((ts >> 29) & 0x0E) | 1,
                  (ts >> 22) & 0xFF, ((ts >> 14) & 0xFE) | 1,
                  (ts >> 7) & 0xFF, ((ts << 1) & 0xFE) | 1])
