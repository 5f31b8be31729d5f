"""RTMP protocol (reference: libavformat/rtmpproto.c, rtmppkt.c).

Same architecture as the reference: the protocol layer speaks the RTMP
chunk stream + AMF0 command sequence and exposes the media as an FLV
byte stream — the FLV (de)muxer rides on top unchanged (rtmpproto.c
builds FLV tags from messages on read and parses FLV tags into
messages on write). Implements the unencrypted handshake, chunk
assembly/fragmentation (fmt 0-3, extended timestamps), set-chunk-size,
window acknowledgement, connect/createStream/publish/play, and a small
server used for ingest and loopback tests.

The port's copy of ffmpeg_tpu/io/rtmp.py, held equal to it by
tests/test_torch_protocols.py.
"""

from __future__ import annotations

import os
import socket
import struct
import threading
import time
from typing import Dict, List, Optional, Tuple
from urllib.parse import urlparse

from ..utils.error import InvalidData

# message types
MSG_SET_CHUNK_SIZE = 1
MSG_ACK = 3
MSG_USER_CONTROL = 4
MSG_WINDOW_ACK_SIZE = 5
MSG_SET_PEER_BW = 6
MSG_AUDIO = 8
MSG_VIDEO = 9
MSG_DATA_AMF0 = 18
MSG_COMMAND_AMF0 = 20

_MEDIA_TYPES = (MSG_AUDIO, MSG_VIDEO, MSG_DATA_AMF0)


# --------------------------------------------------------------------------
# AMF0

def amf_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return b"\x02" + struct.pack(">H", len(b)) + b


def amf_number(v: float) -> bytes:
    return b"\x00" + struct.pack(">d", float(v))


def amf_bool(v: bool) -> bytes:
    return b"\x01" + (b"\x01" if v else b"\x00")


def amf_null() -> bytes:
    return b"\x05"


def amf_object(d: dict) -> bytes:
    out = bytearray(b"\x03")
    for k, v in d.items():
        kb = k.encode("utf-8")
        out += struct.pack(">H", len(kb)) + kb
        out += amf_value(v)
    out += b"\x00\x00\x09"
    return bytes(out)


def amf_value(v) -> bytes:
    if isinstance(v, bool):
        return amf_bool(v)
    if isinstance(v, (int, float)):
        return amf_number(v)
    if isinstance(v, str):
        return amf_string(v)
    if isinstance(v, dict):
        return amf_object(v)
    if v is None:
        return amf_null()
    raise InvalidData(f"amf: cannot encode {type(v)}")


def amf_decode(data: bytes, pos: int = 0):
    t = data[pos]
    pos += 1
    if t == 0x00:
        return struct.unpack_from(">d", data, pos)[0], pos + 8
    if t == 0x01:
        return bool(data[pos]), pos + 1
    if t == 0x02:
        n, = struct.unpack_from(">H", data, pos)
        return data[pos + 2:pos + 2 + n].decode("utf-8", "replace"), \
            pos + 2 + n
    if t in (0x03, 0x08):
        if t == 0x08:
            pos += 4                          # ecma array count
        obj = {}
        while pos + 2 <= len(data):
            n, = struct.unpack_from(">H", data, pos)
            pos += 2
            if n == 0 and pos < len(data) and data[pos] == 0x09:
                return obj, pos + 1
            key = data[pos:pos + n].decode("utf-8", "replace")
            pos += n
            obj[key], pos = amf_decode(data, pos)
        return obj, pos
    if t in (0x05, 0x06):
        return None, pos
    raise InvalidData(f"amf: type {t:#x} unsupported")


def amf_decode_all(data: bytes) -> List:
    out, pos = [], 0
    while pos < len(data):
        v, pos = amf_decode(data, pos)
        out.append(v)
    return out


# --------------------------------------------------------------------------
# chunk stream

class ChunkIO:
    """RTMP chunk-stream reader/writer over a connected socket
    (rtmppkt.c)."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.in_chunk = 128
        self.out_chunk = 128
        self.window = 2500000
        self._rx: Dict[int, dict] = {}        # per-csid assembly state
        self._tx_prev: Dict[int, tuple] = {}
        self._rx_bytes = 0
        self._acked = 0

    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            c = self.sock.recv(n - len(buf))
            if not c:
                raise EOFError("rtmp: connection closed")
            buf += c
        self._rx_bytes += n
        return bytes(buf)

    # --- send ---------------------------------------------------------------
    def send_message(self, csid: int, mtype: int, msid: int, ts: int,
                     payload: bytes) -> None:
        ext = ts >= 0xFFFFFF
        ts_f = 0xFFFFFF if ext else ts
        hdr = bytes([(0 << 6) | csid])
        hdr += struct.pack(">I", ts_f)[1:]
        hdr += struct.pack(">I", len(payload))[1:]
        hdr += bytes([mtype])
        hdr += struct.pack("<I", msid)
        if ext:
            hdr += struct.pack(">I", ts)
        out = bytearray(hdr)
        pos = 0
        first = True
        while pos < len(payload) or first:
            if not first:
                out += bytes([(3 << 6) | csid])
                if ext:
                    out += struct.pack(">I", ts)
            out += payload[pos:pos + self.out_chunk]
            pos += self.out_chunk
            first = False
        self.sock.sendall(out)

    def set_chunk_size(self, size: int) -> None:
        self.send_message(2, MSG_SET_CHUNK_SIZE, 0, 0,
                          struct.pack(">I", size))
        self.out_chunk = size

    # --- receive ------------------------------------------------------------
    def recv_message(self) -> Tuple[int, int, int, bytes]:
        """Returns (mtype, msid, timestamp, payload); handles protocol
        control messages internally and loops until a full app-level
        message arrives."""
        while True:
            msg = self._recv_one()
            if msg is None:
                continue
            mtype, msid, ts, payload = msg
            if mtype == MSG_SET_CHUNK_SIZE and len(payload) >= 4:
                self.in_chunk = struct.unpack(">I", payload[:4])[0]
                continue
            if mtype == MSG_WINDOW_ACK_SIZE and len(payload) >= 4:
                self.window = struct.unpack(">I", payload[:4])[0]
                continue
            if mtype in (MSG_ACK, MSG_SET_PEER_BW):
                continue
            if mtype == MSG_USER_CONTROL and len(payload) >= 2:
                ev = struct.unpack(">H", payload[:2])[0]
                if ev == 6:                   # ping request → pong
                    self.send_message(2, MSG_USER_CONTROL, 0, 0,
                                      b"\x00\x07" + payload[2:6])
                continue
            if self._rx_bytes - self._acked >= self.window // 2:
                self._acked = self._rx_bytes
                self.send_message(2, MSG_ACK, 0, 0,
                                  struct.pack(">I", self._rx_bytes))
            return mtype, msid, ts, payload

    def _recv_one(self):
        b0 = self._read_exact(1)[0]
        fmt = b0 >> 6
        csid = b0 & 0x3F
        if csid == 0:
            csid = 64 + self._read_exact(1)[0]
        elif csid == 1:
            ext2 = self._read_exact(2)
            csid = 64 + ext2[0] + 256 * ext2[1]
        st = self._rx.setdefault(csid, {
            "ts": 0, "len": 0, "type": 0, "msid": 0, "buf": b"",
            "delta": 0, "ext": False})
        if fmt == 0:
            h = self._read_exact(11)
            ts = int.from_bytes(h[0:3], "big")
            st["len"] = int.from_bytes(h[3:6], "big")
            st["type"] = h[6]
            st["msid"] = struct.unpack("<I", h[7:11])[0]
            st["ext"] = ts == 0xFFFFFF
            if st["ext"]:
                ts = struct.unpack(">I", self._read_exact(4))[0]
            st["ts"] = ts
            st["delta"] = 0
        elif fmt == 1:
            h = self._read_exact(7)
            d = int.from_bytes(h[0:3], "big")
            st["len"] = int.from_bytes(h[3:6], "big")
            st["type"] = h[6]
            st["ext"] = d == 0xFFFFFF
            if st["ext"]:
                d = struct.unpack(">I", self._read_exact(4))[0]
            st["delta"] = d
            if not st["buf"]:
                st["ts"] += d
        elif fmt == 2:
            h = self._read_exact(3)
            d = int.from_bytes(h, "big")
            st["ext"] = d == 0xFFFFFF
            if st["ext"]:
                d = struct.unpack(">I", self._read_exact(4))[0]
            st["delta"] = d
            if not st["buf"]:
                st["ts"] += d
        else:                                 # fmt 3: continuation
            if st["ext"]:
                self._read_exact(4)
            if not st["buf"] and st["delta"]:
                st["ts"] += st["delta"]
        need = st["len"] - len(st["buf"])
        take = min(self.in_chunk, need)
        st["buf"] += self._read_exact(take)
        if len(st["buf"]) < st["len"]:
            return None
        payload, st["buf"] = st["buf"], b""
        return st["type"], st["msid"], st["ts"], payload


# --------------------------------------------------------------------------
# handshake (unencrypted, version 3)

def handshake_client(sock: socket.socket) -> None:
    c1 = struct.pack(">II", 0, 0) + os.urandom(1528)
    sock.sendall(b"\x03" + c1)
    _read_n(sock, 1)                          # S0
    s1 = _read_n(sock, 1536)
    _read_n(sock, 1536)                       # S2
    sock.sendall(s1)                          # C2 = echo of S1


def handshake_server(sock: socket.socket) -> None:
    _read_n(sock, 1)                          # C0
    c1 = _read_n(sock, 1536)
    s1 = struct.pack(">II", 0, 0) + os.urandom(1528)
    sock.sendall(b"\x03" + s1 + c1)           # S0 S1 S2=C1 echo
    _read_n(sock, 1536)                       # C2


def _read_n(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        c = sock.recv(n - len(buf))
        if not c:
            raise EOFError("rtmp: handshake EOF")
        buf += c
    return bytes(buf)


# --------------------------------------------------------------------------
# client

class RtmpClient:
    """NetConnection client: connect → createStream → publish/play."""

    def __init__(self, url: str, publish: bool, timeout: float = 10.0):
        u = urlparse(url)
        host = u.hostname or "localhost"
        port = u.port or 1935
        parts = (u.path or "/").strip("/").split("/")
        if len(parts) < 2:
            raise InvalidData("rtmp: url must be rtmp://host/app/stream")
        self.app = "/".join(parts[:-1])
        self.stream = parts[-1]
        self.publish = publish
        self.sock = socket.create_connection((host, port), timeout)
        self.sock.settimeout(timeout)
        handshake_client(self.sock)
        self.io = ChunkIO(self.sock)
        self._txn = 0
        self.msid = 0
        tcurl = f"rtmp://{host}:{port}/{self.app}"
        self._command(3, 0, "connect", {
            "app": self.app, "flashVer": "FMLE/3.0", "tcUrl": tcurl,
            "fpad": False, "capabilities": 15.0,
            "audioCodecs": 4071.0, "videoCodecs": 252.0,
            "videoFunction": 1.0})
        self._wait_result("connect")
        self.io.set_chunk_size(4096)
        self._command(3, 0, "createStream", None)
        res = self._wait_result("createStream")
        self.msid = int(res[3]) if len(res) > 3 and res[3] else 1
        if publish:
            self._command(8, self.msid, "publish", None,
                          amf_string(self.stream) + amf_string("live"))
            self._wait_status("NetStream.Publish.Start")
        else:
            self._command(8, self.msid, "play", None,
                          amf_string(self.stream))
            self._wait_status("NetStream.Play.Start")

    def _command(self, csid, msid, name, obj, extra: bytes = b"") -> None:
        self._txn += 1
        body = amf_string(name) + amf_number(self._txn) + \
            (amf_object(obj) if obj is not None else amf_null()) + extra
        self.io.send_message(csid, MSG_COMMAND_AMF0, msid, 0, body)

    def _wait_result(self, what: str) -> List:
        while True:
            mtype, msid, ts, payload = self.io.recv_message()
            if mtype != MSG_COMMAND_AMF0:
                continue
            vals = amf_decode_all(payload)
            if vals and vals[0] == "_result":
                return vals
            if vals and vals[0] == "_error":
                raise InvalidData(f"rtmp: {what} failed: {vals}")

    def _wait_status(self, code: str) -> None:
        while True:
            mtype, msid, ts, payload = self.io.recv_message()
            if mtype != MSG_COMMAND_AMF0:
                continue
            vals = amf_decode_all(payload)
            if vals and vals[0] == "onStatus":
                info = next((v for v in vals if isinstance(v, dict)
                             and "code" in v), {})
                if info.get("code") == code:
                    return
                if str(info.get("level")) == "error":
                    raise InvalidData(f"rtmp: status {info}")

    def send_media(self, mtype: int, ts: int, payload: bytes) -> None:
        csid = {MSG_AUDIO: 6, MSG_VIDEO: 7}.get(mtype, 5)
        self.io.send_message(csid, mtype, self.msid, ts, payload)

    def recv_media(self) -> Optional[Tuple[int, int, bytes]]:
        """Next (type, ts, payload) media message; None at stream end."""
        while True:
            try:
                mtype, msid, ts, payload = self.io.recv_message()
            except EOFError:
                return None
            if mtype in _MEDIA_TYPES:
                return mtype, ts, payload
            if mtype == MSG_COMMAND_AMF0:
                vals = amf_decode_all(payload)
                if vals and vals[0] == "onStatus":
                    info = next((v for v in vals if isinstance(v, dict)),
                                {})
                    if str(info.get("code", "")).endswith(
                            ("Stop", "Complete")):
                        return None

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


# --------------------------------------------------------------------------
# server (ingest for publish clients, source for play clients)

class RtmpServer:
    """Single-connection RTMP server (test + ingest analog of the
    reference's rtmp listen=1 mode)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.lsock.bind((host, port))
        self.lsock.listen(1)
        self.port = self.lsock.getsockname()[1]
        self.app = self.stream = ""
        self.mode = ""
        self.io: Optional[ChunkIO] = None
        self.msid = 1

    def accept(self, timeout: float = 10.0) -> str:
        """Accept one client; returns 'publish' or 'play'."""
        self.lsock.settimeout(timeout)
        sock, _ = self.lsock.accept()
        sock.settimeout(timeout)
        handshake_server(sock)
        io = ChunkIO(sock)
        self.io = io
        while True:
            mtype, msid, ts, payload = io.recv_message()
            if mtype != MSG_COMMAND_AMF0:
                continue
            vals = amf_decode_all(payload)
            name = vals[0] if vals else ""
            txn = vals[1] if len(vals) > 1 else 0
            if name == "connect":
                self.app = (vals[2] or {}).get("app", "")
                io.send_message(2, MSG_WINDOW_ACK_SIZE, 0, 0,
                                struct.pack(">I", 2500000))
                io.send_message(2, MSG_SET_PEER_BW, 0, 0,
                                struct.pack(">IB", 2500000, 2))
                io.set_chunk_size(4096)
                io.send_message(3, MSG_COMMAND_AMF0, 0, 0,
                                amf_string("_result") + amf_number(txn) +
                                amf_object({"fmsVer": "FMS/3,0,1,123"}) +
                                amf_object({"level": "status",
                                            "code":
                                            "NetConnection.Connect.Success"}))
            elif name == "createStream":
                io.send_message(3, MSG_COMMAND_AMF0, 0, 0,
                                amf_string("_result") + amf_number(txn) +
                                amf_null() + amf_number(self.msid))
            elif name in ("publish", "play"):
                self.stream = next(
                    (v for v in vals[3:] if isinstance(v, str)), "")
                self.mode = name
                code = "NetStream.Publish.Start" if name == "publish" \
                    else "NetStream.Play.Start"
                io.send_message(2, MSG_USER_CONTROL, 0, 0,
                                b"\x00\x00" + struct.pack(">I", self.msid))
                io.send_message(5, MSG_COMMAND_AMF0, self.msid, 0,
                                amf_string("onStatus") + amf_number(0) +
                                amf_null() +
                                amf_object({"level": "status",
                                            "code": code}))
                return name

    def recv_media(self) -> Optional[Tuple[int, int, bytes]]:
        while True:
            try:
                mtype, msid, ts, payload = self.io.recv_message()
            except (EOFError, OSError):
                return None
            if mtype in _MEDIA_TYPES:
                return mtype, ts, payload
            if mtype == MSG_COMMAND_AMF0:
                vals = amf_decode_all(payload)
                if vals and vals[0] in ("FCUnpublish", "deleteStream",
                                        "closeStream"):
                    return None

    def send_media(self, mtype: int, ts: int, payload: bytes) -> None:
        csid = {MSG_AUDIO: 6, MSG_VIDEO: 7}.get(mtype, 5)
        self.io.send_message(csid, mtype, self.msid, ts, payload)

    def close(self) -> None:
        try:
            if self.io is not None:
                self.io.sock.close()
        finally:
            self.lsock.close()


# --------------------------------------------------------------------------
# FLV byte-stream adapters (the rtmpproto.c read/write surface)

_FLV_HEADER = b"FLV\x01\x05\x00\x00\x00\x09\x00\x00\x00\x00"


def _flv_tag(mtype: int, ts: int, payload: bytes) -> bytes:
    hdr = bytes([mtype]) + len(payload).to_bytes(3, "big") + \
        (ts & 0xFFFFFF).to_bytes(3, "big") + bytes([(ts >> 24) & 0xFF]) + \
        b"\x00\x00\x00"
    return hdr + payload + struct.pack(">I", 11 + len(payload))


class RtmpReadStream:
    """File-like: a play session rendered as FLV bytes (rtmp_read)."""

    def __init__(self, url: str):
        self.client = RtmpClient(url, publish=False)
        self._buf = _FLV_HEADER
        self._eof = False

    def read(self, n: int = -1) -> bytes:
        while not self._eof and (n < 0 or len(self._buf) < n):
            m = self.client.recv_media()
            if m is None:
                self._eof = True
                break
            mtype, ts, payload = m
            self._buf += _flv_tag(mtype, ts, payload)
        if n < 0:
            out, self._buf = self._buf, b""
        else:
            out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def close(self) -> None:
        self.client.close()


class RtmpWriteStream:
    """File-like: FLV bytes written by the flv muxer are re-packetised
    into RTMP messages (rtmp_write)."""

    def __init__(self, url: str):
        self.client = RtmpClient(url, publish=True)
        self._buf = b""
        self._skipped_header = False

    def write(self, data: bytes) -> int:
        self._buf += bytes(data)
        if not self._skipped_header:
            if len(self._buf) < 13:
                return len(data)
            if self._buf[:3] != b"FLV":
                raise InvalidData("rtmp: expected FLV stream")
            self._buf = self._buf[13:]        # header + first prev-size
            self._skipped_header = True
        while len(self._buf) >= 11:
            mtype = self._buf[0]
            size = int.from_bytes(self._buf[1:4], "big")
            if len(self._buf) < 11 + size + 4:
                break
            ts = int.from_bytes(self._buf[4:7], "big") | \
                (self._buf[7] << 24)
            payload = self._buf[11:11 + size]
            self._buf = self._buf[11 + size + 4:]
            if mtype in _MEDIA_TYPES and size:
                self.client.send_media(mtype, ts, payload)
        return len(data)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        self.client.close()
