"""RTP packetizers + RTP/RTSP output (reference: libavformat/rtpenc*.c,
rtspenc.c, sdp.c).

- Packetizers: H.264 (RFC 6184 single-NAL + FU-A), AAC (RFC 3640
  mpeg4-generic), MPEG audio/video (RFC 2250), L16.
- `RtpMuxer` ("rtp"): one RTP packet per datagram/write (pairs with a
  UDP protocol writer, like rtpenc.c over udp.c).
- `RtspMuxer` ("rtsp"): default mode is the reference's RECORD client
  (connect + ANNOUNCE + SETUP + RECORD, TCP-interleaved); with
  `listen=True` it is a PLAY server (DESCRIBE/SETUP/PLAY) so PLAY
  clients — ours or the reference binary — can pull the stream.

The port's copy of ffmpeg_tpu/io/formats/rtpenc.py, held equal to it by
tests/test_torch_io_streaming.py.
"""

from __future__ import annotations

import base64
import socket
import struct
from urllib.parse import urlparse

from ...core.packet import Packet
from ...utils.error import InvalidData, NotSupported
from ..mux import Muxer, register_muxer

_MTU = 1472          # typical ethernet payload budget (rtpenc.h s->max_payload_size analog)


class _Pay:
    """Base packetizer: codec packet → list of RTP packets."""

    pt = 96
    clock = 90000
    enc = "UNKNOWN"

    def __init__(self, st, pt):
        self.st = st
        self.pt = pt
        self.seq = 0
        self.ssrc = 0x46465450 + st.index       # 'FFTP' + idx

    def _rtp(self, payload: bytes, ts: int, marker: bool) -> bytes:
        hdr = struct.pack(">BBHII", 0x80,
                          (0x80 if marker else 0) | self.pt,
                          self.seq & 0xFFFF, ts & 0xFFFFFFFF,
                          self.ssrc)
        self.seq += 1
        return hdr + payload

    def ts_of(self, pkt: Packet) -> int:
        tb = pkt.time_base or self.st.time_base
        pts = pkt.pts if pkt.pts is not None else 0
        return int(pts * self.clock * tb.num // tb.den)

    def sdp(self, idx: int) -> str:
        raise NotImplementedError

    def packets(self, pkt: Packet):
        raise NotImplementedError


class _PayH264(_Pay):
    enc = "H264"

    def sdp(self, idx: int) -> str:
        lines = [f"m=video 0 RTP/AVP {self.pt}",
                 f"a=rtpmap:{self.pt} H264/90000"]
        fmtp = "packetization-mode=1"
        ed = self.st.codecpar.extradata
        if ed and bytes(ed[:3]) in (b"\x00\x00\x01", b"\x00\x00\x00"):
            nals = _split_annexb(bytes(ed))
            ps = [n for n in nals if n and (n[0] & 0x1F) in (7, 8)]
            if ps:
                fmtp += ";sprop-parameter-sets=" + ",".join(
                    base64.b64encode(n).decode() for n in ps)
        lines.append(f"a=fmtp:{self.pt} {fmtp}")
        lines.append(f"a=control:streamid={idx}")
        return "\r\n".join(lines)

    def packets(self, pkt: Packet):
        ts = self.ts_of(pkt)
        nals = _split_annexb(bytes(pkt.data))
        out = []
        for i, nal in enumerate(nals):
            if not nal:
                continue
            last_nal = i == len(nals) - 1
            if len(nal) <= _MTU - 12:
                out.append(self._rtp(nal, ts, last_nal))
                continue
            # FU-A fragmentation (RFC 6184 5.8)
            ind = (nal[0] & 0xE0) | 28
            t = nal[0] & 0x1F
            body = nal[1:]
            step = _MTU - 14
            for off in range(0, len(body), step):
                chunk = body[off:off + step]
                s = 0x80 if off == 0 else 0
                e = 0x40 if off + step >= len(body) else 0
                out.append(self._rtp(bytes([ind, s | e | t]) + chunk,
                                     ts, last_nal and bool(e)))
        return out


class _PayAAC(_Pay):
    enc = "MPEG4-GENERIC"

    def __init__(self, st, pt):
        super().__init__(st, pt)
        self.clock = st.codecpar.sample_rate or 48000

    def sdp(self, idx: int) -> str:
        ch = getattr(self.st.codecpar, "channels", None) or 2
        cfg = ""
        ed = self.st.codecpar.extradata
        if ed:
            cfg = f";config={bytes(ed).hex().upper()}"
        return "\r\n".join([
            f"m=audio 0 RTP/AVP {self.pt}",
            f"a=rtpmap:{self.pt} MPEG4-GENERIC/{self.clock}/{ch}",
            f"a=fmtp:{self.pt} streamtype=5;profile-level-id=1;mode=AAC-hbr;"
            f"sizelength=13;indexlength=3;indexdeltalength=3" + cfg,
            f"a=control:streamid={idx}"])

    def packets(self, pkt: Packet):
        data = bytes(pkt.data)
        hdr = struct.pack(">HH", 16, (len(data) << 3) & 0xFFF8)
        return [self._rtp(hdr + data, self.ts_of(pkt), True)]


class _PayMPA(_Pay):
    enc = "MPA"

    def __init__(self, st, pt):
        super().__init__(st, 14)                # static PT

    def sdp(self, idx: int) -> str:
        return "\r\n".join([
            "m=audio 0 RTP/AVP 14", "a=rtpmap:14 MPA/90000",
            f"a=control:streamid={idx}"])

    def packets(self, pkt: Packet):
        return [self._rtp(b"\x00\x00\x00\x00" + bytes(pkt.data),
                          self.ts_of(pkt), True)]


class _PayMPV(_Pay):
    enc = "MPV"

    def __init__(self, st, pt):
        super().__init__(st, 32)                # static PT

    def sdp(self, idx: int) -> str:
        return "\r\n".join([
            "m=video 0 RTP/AVP 32", "a=rtpmap:32 MPV/90000",
            f"a=control:streamid={idx}"])

    def packets(self, pkt: Packet):
        data = bytes(pkt.data)
        ts = self.ts_of(pkt)
        out = []
        step = _MTU - 16
        for off in range(0, len(data), step):
            chunk = data[off:off + step]
            # RFC 2250 3.4 video header: B/E flags around the fragment
            b = 1 if off == 0 else 0
            e = 1 if off + step >= len(data) else 0
            vhdr = struct.pack(">I", (b << 12) | (e << 11))
            out.append(self._rtp(vhdr + chunk, ts, bool(e)))
        return out


class _PayL16(_Pay):
    enc = "L16"

    def __init__(self, st, pt):
        super().__init__(st, pt)
        self.clock = st.codecpar.sample_rate or 44100

    def sdp(self, idx: int) -> str:
        ch = getattr(self.st.codecpar, "channels", None) or 1
        return "\r\n".join([
            f"m=audio 0 RTP/AVP {self.pt}",
            f"a=rtpmap:{self.pt} L16/{self.clock}/{ch}",
            f"a=control:streamid={idx}"])

    def packets(self, pkt: Packet):
        data = bytes(pkt.data)
        ts = self.ts_of(pkt)
        out = []
        step = (_MTU - 12) & ~1
        for off in range(0, len(data), step):
            out.append(self._rtp(data[off:off + step], ts, False))
            ts += (len(data[off:off + step]) // 2)
        return out


_PAYS = {"h264": _PayH264, "aac": _PayAAC, "mp3": _PayMPA,
         "mp2": _PayMPA, "mpeg2video": _PayMPV, "mpeg1video": _PayMPV,
         "pcm_s16be": _PayL16}


def _split_annexb(data: bytes):
    """Annex-B byte stream → NAL payloads (no start codes)."""
    nals = []
    i = 0
    n = len(data)
    while i + 3 <= n:
        if data[i:i + 3] == b"\x00\x00\x01":
            i += 3
        elif data[i:i + 4] == b"\x00\x00\x00\x01":
            i += 4
        else:
            i += 1
            continue
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            nals.append(data[i:])
            break
        end = j
        while end > i and data[end - 1] == 0:
            end -= 1
        nals.append(data[i:end])
        i = j
    return [n for n in nals if n]


def make_pay(st, idx):
    cid = st.codecpar.codec_id
    cls = _PAYS.get(cid)
    if cls is None:
        raise NotSupported(f"rtpenc: no packetizer for {cid}")
    return cls(st, 96 + idx)


def build_sdp(streams, dest="127.0.0.1", title="fftpu"):
    pays = [make_pay(st, i) for i, st in enumerate(streams)]
    lines = ["v=0", f"o=- 0 0 IN IP4 {dest}", f"s={title}",
             f"c=IN IP4 {dest}", "t=0 0"]
    for i, p in enumerate(pays):
        lines.append(p.sdp(i))
    return "\r\n".join(lines) + "\r\n", pays


@register_muxer
class RtpMuxer(Muxer):
    """Single-stream RTP output: each RTP packet is one write (over a
    UDP writer each write is one datagram, matching rtpenc.c)."""

    name = "rtp"
    interleave = False

    def _write_header(self) -> None:
        if len(self.streams) != 1:
            raise InvalidData("rtp: exactly one stream")
        self._pay = make_pay(self.streams[0], 0)

    def _write_packet(self, pkt: Packet) -> None:
        for rp in self._pay.packets(pkt):
            self.w.write(rp)

    def sdp(self, dest="127.0.0.1", port=5004) -> str:
        text, _ = build_sdp(self.streams, dest)
        return text.replace("m=video 0", f"m=video {port}").replace(
            "m=audio 0", f"m=audio {port}")


@register_muxer
class RtspMuxer(Muxer):
    """RTSP output over TCP-interleaved RTP.

    Default: RECORD client (rtspenc.c semantics — connect to a server,
    ANNOUNCE the SDP, SETUP each stream, RECORD, stream interleaved).
    With `listen=True`: PLAY server — wait for a client (ours or the
    reference's rtsp demuxer), answer DESCRIBE/SETUP/PLAY, stream
    interleaved.
    """

    name = "rtsp"
    interleave = True
    flags_no_file = True
    listen = False
    timeout = 20.0

    def _write_header(self) -> None:
        u = urlparse(self.url)
        host = u.hostname or "127.0.0.1"
        port = u.port or 8554
        self._pays = [make_pay(st, i) for i, st in
                      enumerate(self.streams)]
        self._sdp, _ = build_sdp(self.streams, host)
        if self.listen:
            srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            srv.bind((host, port))
            srv.listen(1)
            srv.settimeout(self.timeout)
            self._conn, _ = srv.accept()
            srv.close()
            self._conn.settimeout(self.timeout)
            self._rbuf = bytearray()
            self._serve_until_play()
        else:
            self._conn = socket.create_connection((host, port),
                                                  timeout=self.timeout)
            self._conn.settimeout(self.timeout)
            self._rbuf = bytearray()
            self._cseq = 1
            self._session = None
            self._request("OPTIONS", self.url)
            self._request("ANNOUNCE", self.url, body=self._sdp,
                          ctype="application/sdp")
            for i in range(len(self.streams)):
                hdrs, _ = self._request(
                    "SETUP", f"{self.url}/streamid={i}",
                    extra={"Transport":
                           f"RTP/AVP/TCP;unicast;"
                           f"interleaved={2 * i}-{2 * i + 1};mode=record"})
                sess = hdrs.get("session")
                if sess:
                    self._session = sess.split(";")[0]
            self._request("RECORD", self.url)

    # ---- RECORD-client plumbing ----------------------------------------

    def _request(self, method, url, body=None, ctype=None, extra=None):
        lines = [f"{method} {url} RTSP/1.0", f"CSeq: {self._cseq}"]
        if self._session:
            lines.append(f"Session: {self._session}")
        if extra:
            lines += [f"{k}: {v}" for k, v in extra.items()]
        if body is not None:
            lines.append(f"Content-Type: {ctype}")
            lines.append(f"Content-Length: {len(body)}")
        msg = "\r\n".join(lines) + "\r\n\r\n" + (body or "")
        self._conn.sendall(msg.encode("latin1"))
        self._cseq += 1
        return self._response()

    def _recv_line(self):
        while b"\r\n" not in self._rbuf:
            data = self._conn.recv(65536)
            if not data:
                raise InvalidData("rtsp: connection closed")
            self._rbuf += data
        line, _, rest = bytes(self._rbuf).partition(b"\r\n")
        self._rbuf = bytearray(rest)
        return line.decode("latin1")

    def _response(self):
        status = self._recv_line()
        while not status.strip():
            status = self._recv_line()
        if "200" not in status.split(None, 2)[1:2] and \
                " 200 " not in status:
            raise InvalidData(f"rtsp: {status}")
        headers = {}
        while True:
            line = self._recv_line()
            if not line:
                break
            k, _, v = line.partition(":")
            headers[k.strip().lower()] = v.strip()
        clen = int(headers.get("content-length", 0))
        while len(self._rbuf) < clen:
            data = self._conn.recv(65536)
            if not data:
                break
            self._rbuf += data
        body = bytes(self._rbuf[:clen])
        self._rbuf = self._rbuf[clen:]
        return headers, body

    # ---- PLAY-server plumbing ------------------------------------------

    def _serve_until_play(self):
        playing = False
        session = "1"
        while not playing:
            req = self._recv_line()
            while not req.strip():
                req = self._recv_line()
            method, target = (req.split() + ["", ""])[:2]
            method = method.upper()
            headers = {}
            while True:
                line = self._recv_line()
                if not line:
                    break
                k, _, v = line.partition(":")
                headers[k.strip().lower()] = v.strip()
            cseq = headers.get("cseq", "0")
            extra = ""
            body = ""
            if method == "OPTIONS":
                extra = ("Public: OPTIONS, DESCRIBE, SETUP, PLAY, "
                         "TEARDOWN\r\n")
            elif method == "DESCRIBE":
                body = self._sdp
                extra = (f"Content-Base: {self.url}/\r\n"
                         "Content-Type: application/sdp\r\n"
                         f"Content-Length: {len(body)}\r\n")
            elif method == "SETUP":
                tr = headers.get("transport", "")
                if "TCP" not in tr.upper():
                    resp = (f"RTSP/1.0 461 Unsupported Transport\r\n"
                            f"CSeq: {cseq}\r\n\r\n")
                    self._conn.sendall(resp.encode("latin1"))
                    continue
                chan = None
                for part in tr.split(";"):
                    if part.startswith("interleaved="):
                        chan = part.split("=")[1]
                if chan is None:
                    # assign by stream id in the URL
                    sid = 0
                    if "streamid=" in target:
                        sid = int(target.rsplit("streamid=", 1)[1]
                                  .split("/")[0])
                    chan = f"{2 * sid}-{2 * sid + 1}"
                    tr = tr + f";interleaved={chan}"
                extra = (f"Transport: {tr}\r\n"
                         f"Session: {session}\r\n")
            elif method == "PLAY":
                extra = f"Session: {session}\r\n"
                playing = True
            elif method == "TEARDOWN":
                raise InvalidData("rtsp: client tore down before PLAY")
            resp = (f"RTSP/1.0 200 OK\r\nCSeq: {cseq}\r\n{extra}\r\n"
                    + body)
            self._conn.sendall(resp.encode("latin1"))

    # ---- data path -------------------------------------------------------

    def _write_packet(self, pkt: Packet) -> None:
        pay = self._pays[pkt.stream_index]
        chan = 2 * pkt.stream_index
        for rp in pay.packets(pkt):
            frame = b"$" + bytes([chan]) + \
                struct.pack(">H", len(rp)) + rp
            self._conn.sendall(frame)

    def _write_trailer(self) -> None:
        try:
            if not self.listen:
                self._request("TEARDOWN", self.url)
        except Exception:
            pass
        try:
            self._conn.close()
        except OSError:
            pass
