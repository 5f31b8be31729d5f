"""RTP/SDP/RTSP ingest (reference: libavformat/rtpdec*.c, sdp.c,
rtsp.c).

- `SdpDemuxer`: opens a .sdp session description, binds the UDP
  ports and depacketizes the RTP payloads (H264 RFC 6184, MPEG
  audio/video RFC 2250, AAC RFC 3640, L16, and MP2T full transport
  streams).
- `RtspListenDemuxer`: rtsp://host:port RECORD-mode server (the
  `-rtsp_flags listen` analog): accepts one publisher (ANNOUNCE /
  SETUP with TCP-interleaved transport / RECORD) and yields its
  depacketized packets.

The port's copy of ffmpeg_tpu/io/formats/rtp.py, held equal to it by
tests/test_torch_io_streaming.py.
"""

from __future__ import annotations

import base64
import binascii
import select
import socket
import struct
from urllib.parse import urlparse

from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import EndOfStream, InvalidData
from ...utils.rational import Rational
from ..demux import Demuxer, register_demuxer, open_input
from ..stream import CodecParameters, MediaType


def parse_rtp(data: bytes):
    """→ (payload_type, seq, timestamp, marker, payload)."""
    if len(data) < 12 or (data[0] >> 6) != 2:
        raise InvalidData("rtp: bad packet")
    cc = data[0] & 0xF
    x = (data[0] >> 4) & 1
    marker = data[1] >> 7
    pt = data[1] & 0x7F
    seq, ts = struct.unpack(">HI", data[2:8])
    off = 12 + 4 * cc
    if x:
        if len(data) < off + 4:
            raise InvalidData("rtp: bad extension")
        xlen = struct.unpack(">H", data[off + 2:off + 4])[0]
        off += 4 + 4 * xlen
    pad = data[-1] if (data[0] >> 5) & 1 else 0
    return pt, seq, ts, marker, data[off:len(data) - pad]


def parse_sdp(text: str):
    """→ (media list) of dicts: type, port, pt, enc, clock, fmtp,
    dest."""
    medias = []
    cur = None
    dest = None
    for line in text.splitlines():
        line = line.strip()
        if not line or len(line) < 2 or line[1] != "=":
            continue
        k, v = line[0], line[2:]
        if k == "c":
            parts = v.split()
            addr = parts[2].split("/")[0] if len(parts) >= 3 else None
            if cur is None:
                dest = addr
            else:
                cur["dest"] = addr
        elif k == "m":
            parts = v.split()
            cur = {"type": parts[0], "port": int(parts[1]),
                   "pt": int(parts[3]), "enc": None, "clock": 90000,
                   "channels": 1, "fmtp": {}, "dest": dest}
            medias.append(cur)
        elif k == "a" and cur is not None:
            if v.startswith("rtpmap:"):
                ptv, rest = v[7:].split(" ", 1)
                if int(ptv) == cur["pt"]:
                    enc = rest.split("/")
                    cur["enc"] = enc[0].upper()
                    cur["clock"] = int(enc[1])
                    if len(enc) > 2:
                        cur["channels"] = int(enc[2])
            elif v.startswith("control:"):
                cur["control"] = v[8:]
            elif v.startswith("fmtp:"):
                body = v[5:].split(" ", 1)
                if len(body) == 2 and int(body[0]) == cur["pt"]:
                    for kv in body[1].split(";"):
                        kv = kv.strip()
                        if "=" in kv:
                            kk, vv = kv.split("=", 1)
                            cur["fmtp"][kk.lower()] = vv
    # static payload types (RFC 3551)
    for m in medias:
        if m["enc"] is None:
            m["enc"], m["clock"] = {
                14: ("MPA", 90000), 32: ("MPV", 90000),
                33: ("MP2T", 90000), 10: ("L16", 44100),
                11: ("L16", 44100), 0: ("PCMU", 8000),
                8: ("PCMA", 8000),
            }.get(m["pt"], ("UNKNOWN", 90000))
    return medias


class _Depay:
    """Base depacketizer: returns a list of (bytes, key) per RTP
    packet."""

    def __init__(self, media):
        self.media = media

    def codecpar(self):
        raise NotImplementedError

    def handle(self, seq, ts, marker, payload):
        return [(payload, True)]


class _DepayMPA(_Depay):
    def codecpar(self):
        return CodecParameters(codec_type=MediaType.AUDIO,
                               codec_id="mp3")

    def handle(self, seq, ts, marker, payload):
        return [(payload[4:], True)]      # RFC 2250 audio header


class _DepayMPV(_Depay):
    def __init__(self, media):
        super().__init__(media)
        self.buf = bytearray()

    def codecpar(self):
        return CodecParameters(codec_type=MediaType.VIDEO,
                               codec_id="mpeg2video")

    def handle(self, seq, ts, marker, payload):
        if len(payload) < 4:
            return []
        off = 4
        if payload[0] & 0x04:             # T bit: MPEG-2 extension
            off += 4
        self.buf += payload[off:]
        if marker:
            out = bytes(self.buf)
            self.buf = bytearray()
            return [(out, True)]
        return []


class _DepayL16(_Depay):
    def codecpar(self):
        return CodecParameters(codec_type=MediaType.AUDIO,
                               codec_id="pcm_s16be",
                               sample_rate=self.media["clock"],
                               channels=self.media["channels"])


class _DepayH264(_Depay):
    def __init__(self, media):
        super().__init__(media)
        self.au = bytearray()
        self.frag = bytearray()
        extra = b""
        sprop = media["fmtp"].get("sprop-parameter-sets")
        if sprop:
            for ps in sprop.split(","):
                try:
                    extra += b"\x00\x00\x00\x01" + \
                        base64.b64decode(ps + "===")
                except binascii.Error:
                    pass
        self.extra = extra
        self.sent_extra = False

    def codecpar(self):
        return CodecParameters(codec_type=MediaType.VIDEO,
                               codec_id="h264",
                               extradata=self.extra or None)

    def _add_nal(self, nal):
        self.au += b"\x00\x00\x00\x01" + nal

    def handle(self, seq, ts, marker, payload):
        if not payload:
            return []
        t = payload[0] & 0x1F
        if 1 <= t <= 23:
            self._add_nal(payload)
        elif t == 24:                     # STAP-A
            pos = 1
            while pos + 2 <= len(payload):
                sz = struct.unpack(">H", payload[pos:pos + 2])[0]
                pos += 2
                self._add_nal(payload[pos:pos + sz])
                pos += sz
        elif t == 28:                     # FU-A
            fu = payload[1]
            if fu & 0x80:                 # start
                nal_hdr = (payload[0] & 0xE0) | (fu & 0x1F)
                self.frag = bytearray([nal_hdr]) + payload[2:]
            else:
                self.frag += payload[2:]
            if fu & 0x40:                 # end
                self._add_nal(bytes(self.frag))
                self.frag = bytearray()
        if marker and self.au:
            out = bytes(self.au)
            self.au = bytearray()
            if not self.sent_extra and self.extra:
                out = self.extra + out
                self.sent_extra = True
            key = False
            pos = 0
            while True:
                pos = out.find(b"\x00\x00\x00\x01", pos)
                if pos < 0 or pos + 4 >= len(out):
                    break
                if (out[pos + 4] & 0x1F) == 5:
                    key = True
                    break
                pos += 4
            return [(out, key)]
        return []


class _DepayAAC(_Depay):
    """mpeg4-generic AU-header mode (RFC 3640)."""

    def __init__(self, media):
        super().__init__(media)
        f = media["fmtp"]
        self.sizelength = int(f.get("sizelength", 13))
        self.indexlength = int(f.get("indexlength", 3))
        cfg = f.get("config")
        self.extra = bytes.fromhex(cfg) if cfg else None

    def codecpar(self):
        return CodecParameters(codec_type=MediaType.AUDIO,
                               codec_id="aac", extradata=self.extra,
                               sample_rate=self.media["clock"],
                               channels=self.media["channels"])

    def handle(self, seq, ts, marker, payload):
        if len(payload) < 2:
            return []
        au_bits = struct.unpack(">H", payload[:2])[0]
        nbytes = (au_bits + 7) // 8
        hdr = payload[2:2 + nbytes]
        pos = 2 + nbytes
        out = []
        bit = 0
        while bit + self.sizelength + self.indexlength <= au_bits:
            v = 0
            for i in range(self.sizelength):
                byte = (bit + i) >> 3
                v = (v << 1) | ((hdr[byte] >> (7 - ((bit + i) & 7)))
                                & 1)
            bit += self.sizelength + self.indexlength
            out.append((payload[pos:pos + v], True))
            pos += v
        return out


_DEPAYS = {"MPA": _DepayMPA, "MPV": _DepayMPV, "L16": _DepayL16,
           "H264": _DepayH264, "MPEG4-GENERIC": _DepayAAC}


class _RtpSession:
    """One media's RTP state: depacketizer + timestamp unwrapping."""

    def __init__(self, media):
        enc = media["enc"]
        if enc not in _DEPAYS:
            raise InvalidData(f"rtp: unsupported payload {enc}")
        self.media = media
        self.depay = _DEPAYS[enc](media)
        self.first_ts = None
        self.last_ext = 0

    def unwrap(self, ts):
        if self.first_ts is None:
            self.first_ts = ts
            self.last_ext = ts
        # 32-bit wrap handling
        delta = (ts - self.last_ext) & 0xFFFFFFFF
        if delta < 0x80000000:
            self.last_ext = self.last_ext + delta
        else:
            self.last_ext = self.last_ext - ((1 << 32) - delta)
        return self.last_ext - self.first_ts

    def packets(self, data, stream_index, time_base):
        pt, seq, ts, marker, payload = parse_rtp(data)
        if pt != self.media["pt"]:
            return []
        pts = self.unwrap(ts)
        out = []
        for buf, key in self.depay.handle(seq, ts, marker, payload):
            if buf:
                out.append(Packet(data=buf, pts=pts, dts=pts,
                                  stream_index=stream_index,
                                  flags=PKT_FLAG_KEY if key else 0,
                                  time_base=time_base))
        return out


@register_demuxer
class SdpDemuxer(Demuxer):
    """RTP session bootstrapped from an SDP file (sdp.c analog)."""

    name = "sdp"
    extensions = ("sdp",)
    listen_timeout = 10.0
    idle_timeout = 2.0

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        if head[:2] == b"v=" and b"\nm=" in head.replace(b"\r", b""):
            return 60
        return 0

    def read_header(self) -> None:
        text = self.r.read(1 << 20).decode("utf-8", "replace")
        medias = parse_sdp(text)
        if not medias:
            raise InvalidData("sdp: no media sections")
        mp2t = next((m for m in medias if m["enc"] == "MP2T"), None)
        if mp2t is not None:
            self._read_mpegts(mp2t)
            return
        self._inner = None
        self._socks = []
        self._sessions = []
        self._queue = []
        for i, m in enumerate(medias):
            s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("0.0.0.0", m["port"]))
            s.setblocking(False)
            sess = _RtpSession(m)
            tb = Rational(1, m["clock"])
            self.add_stream(codecpar=sess.depay.codecpar(),
                            time_base=tb)
            self._socks.append(s)
            self._sessions.append(sess)
        self._started = False

    def _read_mpegts(self, m):
        """MP2T payload: collect the transport stream, then delegate
        to the mpegts demuxer."""
        import io as _io
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("0.0.0.0", m["port"]))
        s.settimeout(self.listen_timeout)
        buf = bytearray()
        timeout = self.listen_timeout
        while True:
            try:
                data = s.recv(65536)
            except socket.timeout:
                break
            timeout = self.idle_timeout
            s.settimeout(timeout)
            try:
                _, _, _, _, payload = parse_rtp(data)
            except InvalidData:
                continue
            buf += payload
        s.close()
        if not buf:
            raise InvalidData("sdp: no RTP data received")
        self._inner = open_input(_io.BytesIO(bytes(buf)))
        for st in self._inner.streams:
            self.add_stream(codecpar=st.codecpar.copy(),
                            time_base=st.time_base)

    def read_packet(self) -> Packet:
        if self._inner is not None:
            p = self._inner.read_packet()
            return p
        while True:
            if self._queue:
                return self._queue.pop(0)
            timeout = self.idle_timeout if self._started else \
                self.listen_timeout
            ready, _, _ = select.select(self._socks, [], [], timeout)
            if not ready:
                raise EndOfStream()
            for s in ready:
                i = self._socks.index(s)
                try:
                    data = s.recv(65536)
                except BlockingIOError:
                    continue
                self._started = True
                try:
                    self._queue.extend(self._sessions[i].packets(
                        data, i, self.streams[i].time_base))
                except InvalidData:
                    continue


@register_demuxer
class RtspListenDemuxer(Demuxer):
    """RTSP input (rtsp.c analog).

    Default mode is the PLAY client: connect to a server, DESCRIBE →
    SDP, SETUP each media with TCP-interleaved transport, PLAY, and
    depacketize the interleaved RTP (rtsp.c + rtpdec.c).

    With `rtsp_flags="listen"` it is the RECORD-mode server
    (`-rtsp_flags listen`): a publisher connects, ANNOUNCEs an SDP,
    SETUPs TCP-interleaved transports and RECORDs."""

    name = "rtsp"
    extensions = ()
    listen_timeout = 10.0
    rtsp_flags = ""

    @classmethod
    def probe(cls, head: bytes, filename: str = "") -> int:
        return 100 if str(filename).startswith("rtsp://") else 0

    flags_no_file = True

    def read_header(self) -> None:
        if self.rtsp_flags != "listen":
            self._client_play()
            return
        u = urlparse(self.url)
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((u.hostname or "0.0.0.0", u.port or 8554))
        srv.listen(1)
        srv.settimeout(self.listen_timeout)
        self._conn, _ = srv.accept()
        srv.close()
        self._conn.settimeout(self.listen_timeout)
        self._rbuf = bytearray()
        self._sessions = {}
        self._chan_map = {}
        self._queue = []
        self._recording = False
        while not self._recording:
            self._handle_request()

    # ---- PLAY client (rtsp.c DESCRIBE/SETUP/PLAY state machine) -------

    def _client_play(self):
        u = urlparse(self.url)
        self._conn = socket.create_connection(
            (u.hostname or "127.0.0.1", u.port or 554),
            timeout=self.listen_timeout)
        self._conn.settimeout(self.listen_timeout)
        self._rbuf = bytearray()
        self._sessions = {}
        self._chan_map = {}
        self._queue = []
        self._cseq = 1
        self._rtsp_session = None
        self._creq("OPTIONS", self.url)
        hdrs, body = self._creq("DESCRIBE", self.url,
                                extra={"Accept": "application/sdp"})
        base = hdrs.get("content-base", self.url).rstrip("/")
        medias = parse_sdp(body.decode("utf-8", "replace"))
        if not medias:
            raise InvalidData("rtsp: DESCRIBE returned no media")
        for i, m in enumerate(medias):
            sess = _RtpSession(m)
            tb = Rational(1, m["clock"])
            self.add_stream(codecpar=sess.depay.codecpar(), time_base=tb)
            self._sessions[i] = sess
            ctl = m.get("control", f"streamid={i}")
            setup_url = ctl if ctl.startswith("rtsp://") else \
                f"{base}/{ctl}"
            chan = 2 * i
            h, _ = self._creq(
                "SETUP", setup_url,
                extra={"Transport": f"RTP/AVP/TCP;unicast;"
                                    f"interleaved={chan}-{chan + 1}"})
            tr = h.get("transport", "")
            for part in tr.split(";"):
                if part.startswith("interleaved="):
                    chan = int(part.split("=")[1].split("-")[0])
            self._chan_map[chan] = i
            s = h.get("session")
            if s:
                self._rtsp_session = s.split(";")[0]
        self._creq("PLAY", self.url, extra={"Range": "npt=0.000-"})
        self._recording = True

    def _creq(self, method, url, extra=None):
        lines = [f"{method} {url} RTSP/1.0", f"CSeq: {self._cseq}"]
        if self._rtsp_session:
            lines.append(f"Session: {self._rtsp_session}")
        if extra:
            lines += [f"{k}: {v}" for k, v in extra.items()]
        self._conn.sendall(("\r\n".join(lines) + "\r\n\r\n")
                           .encode("latin1"))
        self._cseq += 1
        # responses may be preceded by interleaved data frames
        while True:
            while not self._rbuf:
                self._recv_more()
            if self._rbuf[:1] == b"$":
                self._read_interleaved()
                continue
            break
        status = self._read_line()
        while not status.strip():
            status = self._read_line()
        headers = {}
        while True:
            line = self._read_line()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        clen = int(headers.get("content-length", 0))
        while len(self._rbuf) < clen:
            self._recv_more()
        body = bytes(self._rbuf[:clen])
        self._rbuf = self._rbuf[clen:]
        if " 200 " not in status:
            raise InvalidData(f"rtsp: {method} -> {status}")
        return headers, body

    def _recv_more(self):
        data = self._conn.recv(65536)
        if not data:
            raise EndOfStream()
        self._rbuf += data

    def _read_line(self):
        while b"\r\n" not in self._rbuf:
            self._recv_more()
        line, _, rest = bytes(self._rbuf).partition(b"\r\n")
        self._rbuf = bytearray(rest)
        return line.decode("latin1")

    def _handle_request(self):
        # skip any interleaved data before the next request
        while self._rbuf[:1] == b"$":
            self._read_interleaved()
        req = self._read_line()
        while not req.strip():
            req = self._read_line()
        method = req.split()[0].upper()
        headers = {}
        while True:
            line = self._read_line()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        clen = int(headers.get("content-length", 0))
        while len(self._rbuf) < clen:
            self._recv_more()
        body = bytes(self._rbuf[:clen])
        self._rbuf = self._rbuf[clen:]
        cseq = headers.get("cseq", "0")
        extra = ""
        if method == "OPTIONS":
            extra = ("Public: OPTIONS, ANNOUNCE, SETUP, RECORD, "
                     "TEARDOWN\r\n")
        elif method == "ANNOUNCE":
            medias = parse_sdp(body.decode("utf-8", "replace"))
            for i, m in enumerate(medias):
                sess = _RtpSession(m)
                tb = Rational(1, m["clock"])
                self.add_stream(codecpar=sess.depay.codecpar(),
                                time_base=tb)
                self._sessions[i] = sess
        elif method == "SETUP":
            tr = headers.get("transport", "")
            chan = 2 * len(self._chan_map)
            for part in tr.split(";"):
                if part.startswith("interleaved="):
                    chan = int(part.split("=")[1].split("-")[0])
            self._chan_map[chan] = len(self._chan_map)
            extra = (f"Transport: {tr}\r\n"
                     f"Session: 1\r\n")
        elif method == "RECORD":
            extra = "Session: 1\r\n"
            self._recording = True
        elif method == "TEARDOWN":
            self._teardown = True
        resp = (f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n{extra}\r\n")
        self._conn.sendall(resp.encode("latin1"))
        if method == "TEARDOWN":
            raise EndOfStream()

    def _read_interleaved(self):
        while len(self._rbuf) < 4:
            self._recv_more()
        if self._rbuf[:1] != b"$":
            return False
        chan = self._rbuf[1]
        size = struct.unpack(">H", self._rbuf[2:4])[0]
        while len(self._rbuf) < 4 + size:
            self._recv_more()
        data = bytes(self._rbuf[4:4 + size])
        self._rbuf = self._rbuf[4 + size:]
        if chan & 1:
            return True                   # RTCP: ignore
        idx = self._chan_map.get(chan)
        if idx is None or idx >= len(self._sessions):
            return True
        try:
            self._queue.extend(self._sessions[idx].packets(
                data, idx, self.streams[idx].time_base))
        except InvalidData:
            pass
        return True

    def read_packet(self) -> Packet:
        while True:
            if self._queue:
                return self._queue.pop(0)
            if self._rbuf[:1] == b"$" or not self._rbuf:
                try:
                    if not self._rbuf:
                        self._recv_more()
                except (EndOfStream, socket.timeout, OSError):
                    raise EndOfStream()
                if self._rbuf[:1] == b"$":
                    self._read_interleaved()
                else:
                    self._handle_request()
            else:
                self._handle_request()
