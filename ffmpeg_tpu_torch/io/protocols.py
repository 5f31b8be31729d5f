"""Network/stream protocols (reference: libavformat/tcp.c, http.c, udp.c).

The host runtime owns IO; protocols expose file-like read objects consumed
by avio.Reader. Built on the stdlib so they work in hermetic environments:
http(s) via http.client, tcp/udp via socket. Redirects and range-based
reconnects follow the reference's http semantics.

The port's copy of ffmpeg_tpu/io/protocols.py, held equal to it by
tests/test_torch_protocols.py.
"""

from __future__ import annotations

import io
import socket
from typing import Optional
from urllib.parse import urlparse

from ..utils.error import InvalidData, ProtocolNotFound


class _SocketFile:
    """Minimal file-like over a connected socket (tcp.c analog)."""

    def __init__(self, sock: socket.socket):
        self._s = sock
        self._f = sock.makefile("rb")

    def read(self, n: int = -1) -> bytes:
        return self._f.read(n)

    def close(self) -> None:
        try:
            self._f.close()
        finally:
            self._s.close()


def open_tcp(url: str, timeout: float = 10.0) -> _SocketFile:
    u = urlparse(url)
    if not u.hostname or not u.port:
        raise InvalidData(f"tcp: need host:port in {url!r}")
    s = socket.create_connection((u.hostname, u.port), timeout=timeout)
    return _SocketFile(s)


def open_tls(url: str, timeout: float = 10.0):
    """tls://host:port — TCP wrapped in TLS (reference: tls.c).
    Query options: ?verify=0 disables certificate verification
    (the reference's tls 'verify' AVOption, default off like ffmpeg)."""
    import ssl
    u = urlparse(url)
    if not u.hostname or not u.port:
        raise InvalidData(f"tls: need host:port in {url!r}")
    verify = "verify=1" in (u.query or "")
    ctx = ssl.create_default_context()
    if not verify:
        ctx.check_hostname = False
        ctx.verify_mode = ssl.CERT_NONE
    raw = socket.create_connection((u.hostname, u.port), timeout=timeout)
    s = ctx.wrap_socket(raw, server_hostname=u.hostname)
    return _SocketFile(s)


class UdpStream:
    """udp://host:port datagram reader (reference: udp.c). For reading,
    binds the port and returns datagram payloads packet-at-a-time; a
    read(n) returns at most one datagram (like the reference's
    packetized mode)."""

    def __init__(self, url: str, timeout: float = 10.0):
        u = urlparse(url)
        if u.port is None:
            raise InvalidData(f"udp: need port in {url!r}")
        self._s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._s.settimeout(timeout)
        self._s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._s.bind((u.hostname or "0.0.0.0", u.port))
        self._pending = b""

    def read(self, n: int = -1) -> bytes:
        if self._pending:
            if n < 0:
                out, self._pending = self._pending, b""
            else:
                out, self._pending = self._pending[:n], self._pending[n:]
            return out
        try:
            data = self._s.recv(65536)
        except socket.timeout:
            return b""
        if 0 <= n < len(data):
            self._pending = data[n:]
            return data[:n]
        return data

    def close(self) -> None:
        self._s.close()


class HttpStream:
    """http/https GET body as a file-like, with redirect following and
    Range-based seek support when the server advertises it (http.c:
    http_open + http_seek)."""

    MAX_REDIRECTS = 8

    def __init__(self, url: str, timeout: float = 10.0):
        self.url = url
        self.timeout = timeout
        self._resp = None
        self._conn = None
        self._pos = 0
        self.size: Optional[int] = None
        self.accept_ranges = False
        self._open(0)

    def _open(self, offset: int) -> None:
        import http.client
        url = self.url
        for _ in range(self.MAX_REDIRECTS):
            u = urlparse(url)
            cls = http.client.HTTPSConnection if u.scheme == "https" \
                else http.client.HTTPConnection
            conn = cls(u.hostname, u.port, timeout=self.timeout)
            path = u.path or "/"
            if u.query:
                path += "?" + u.query
            headers = {"User-Agent": "fftpu/0.1", "Accept": "*/*"}
            if offset:
                headers["Range"] = f"bytes={offset}-"
            conn.request("GET", path, headers=headers)
            resp = conn.getresponse()
            if resp.status in (301, 302, 303, 307, 308):
                loc = resp.getheader("Location")
                resp.read()
                conn.close()
                if not loc:
                    raise InvalidData("http: redirect without Location")
                from urllib.parse import urljoin
                url = urljoin(url, loc)
                continue
            if resp.status not in (200, 206):
                conn.close()
                raise InvalidData(f"http: status {resp.status} for {url}")
            if offset and resp.status == 200:
                # Server ignored the Range request and is sending the whole
                # body from byte 0 (http.c treats this as a full-resource
                # response): consume up to `offset` so reads line up.
                skip = offset
                while skip > 0:
                    chunk = resp.read(min(skip, 1 << 16))
                    if not chunk:
                        conn.close()
                        raise InvalidData(
                            "http: body ended before requested offset")
                    skip -= len(chunk)
            self._conn, self._resp = conn, resp
            self._pos = offset
            self.accept_ranges = (resp.status == 206 or
                                  resp.getheader("Accept-Ranges") == "bytes")
            cl = resp.getheader("Content-Length")
            if cl is not None and self.size is None:
                # 206: length of the remainder; 200: the full resource.
                self.size = int(cl) + (offset if resp.status == 206 else 0)
            cr = resp.getheader("Content-Range")
            if cr and "/" in cr:
                total = cr.rsplit("/", 1)[1]
                if total.isdigit():
                    self.size = int(total)
            return
        raise InvalidData("http: too many redirects")

    def read(self, n: int = -1) -> bytes:
        data = self._resp.read(n if n is not None and n >= 0 else None)
        self._pos += len(data)
        return data

    def tell(self) -> int:
        return self._pos

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            pos += self._pos
        elif whence == 2:
            if self.size is None:
                raise io.UnsupportedOperation("http: unknown size")
            pos += self.size
        if pos == self._pos:
            return pos
        if not self.accept_ranges:
            raise io.UnsupportedOperation("http: server has no range support")
        self._resp.close()
        self._conn.close()
        self._open(pos)
        return pos

    def close(self) -> None:
        try:
            if self._resp is not None:
                self._resp.close()
        finally:
            if self._conn is not None:
                self._conn.close()


class DataStream(io.BytesIO):
    """RFC 2397 data: URI (libavformat/data_uri.c analog)."""

    def __init__(self, url: str):
        body = url[5:]                     # strip "data:"
        if "," not in body:
            raise ProtocolNotFound("data: missing ','")
        meta, payload = body.split(",", 1)
        if meta.endswith(";base64"):
            import base64
            raw = base64.b64decode(payload)
        else:
            import urllib.parse
            raw = urllib.parse.unquote_to_bytes(payload)
        super().__init__(raw)


class FtpStream:
    """ftp:// reader (libavformat/ftp.c analog) over stdlib ftplib:
    full-file RETR into a spooled buffer with seek support."""

    def __init__(self, url: str):
        import ftplib
        import urllib.parse
        u = urllib.parse.urlparse(url)
        ftp = ftplib.FTP()
        ftp.connect(u.hostname, u.port or 21, timeout=10)
        ftp.login(u.username or "anonymous", u.password or "-")
        buf = io.BytesIO()
        ftp.retrbinary(f"RETR {u.path}", buf.write)
        ftp.quit()
        buf.seek(0)
        self._buf = buf

    def read(self, n=-1):
        return self._buf.read(n)

    def seek(self, pos, whence=0):
        return self._buf.seek(pos, whence)

    def tell(self):
        return self._buf.tell()

    def close(self):
        self._buf.close()


class GopherStream:
    """gopher:// reader (libavformat/gopher.c analog): one selector
    request over TCP, response streamed."""

    def __init__(self, url: str):
        import socket
        import urllib.parse
        u = urllib.parse.urlparse(url)
        s = socket.create_connection((u.hostname, u.port or 70),
                                     timeout=10)
        sel = u.path or "/"
        if len(sel) >= 2 and sel[0] == "/":
            sel = sel[2:]                  # strip type char like the ref
        s.sendall(sel.encode() + b"\r\n")
        self._f = _SocketFile(s)

    def read(self, n=-1):
        return self._f.read(n)

    def close(self):
        self._f.close()


class IcecastStream:
    """icecast:// writer (libavformat/icecast.c analog): a long-lived
    HTTP PUT with Ice-* headers; write() streams the body."""

    def __init__(self, url: str, content_type="audio/mpeg",
                 name="", legacy=False):
        import base64
        import socket
        import urllib.parse
        u = urllib.parse.urlparse(url)
        self._sock = socket.create_connection(
            (u.hostname, u.port or 8000), timeout=10)
        mount = u.path or "/stream"
        auth = base64.b64encode(
            f"{u.username or 'source'}:{u.password or ''}"
            .encode()).decode()
        hdr = (f"PUT {mount} HTTP/1.1\r\n"
               f"Host: {u.hostname}\r\n"
               f"Authorization: Basic {auth}\r\n"
               f"Content-Type: {content_type}\r\n"
               f"Ice-Name: {name}\r\n"
               "Ice-Public: 0\r\n"
               "Transfer-Encoding: chunked\r\n\r\n")
        self._sock.sendall(hdr.encode())

    def write(self, data: bytes):
        self._sock.sendall(b"%x\r\n" % len(data) + data + b"\r\n")
        return len(data)

    def close(self):
        try:
            self._sock.sendall(b"0\r\n\r\n")
        finally:
            self._sock.close()


class TeeWriteStream:
    """tee: write fan-out (libavformat/teeproto.c analog):
    tee:out1.bin|out2.bin."""

    def __init__(self, url: str):
        targets = url[4:].split("|")
        self._outs = []
        for t in targets:
            w = open_url_write(t)
            self._outs.append(w if w is not None else open(t, "wb"))

    def write(self, data: bytes):
        for o in self._outs:
            o.write(data)
        return len(data)

    def close(self):
        for o in self._outs:
            o.close()


def open_url(url: str):
    """Resolve a protocol URL to a file-like (ffurl_open analog). Returns
    None for protocols avio handles natively (file/pipe/fd/memory)."""
    if url.startswith("data:"):
        return DataStream(url)
    scheme = url.split("://", 1)[0] if "://" in url else ""
    if scheme in ("http", "https"):
        return HttpStream(url)
    if scheme == "tcp":
        return open_tcp(url)
    if scheme == "tls":
        return open_tls(url)
    if scheme == "udp":
        return UdpStream(url)
    if scheme == "rtmp":
        from .rtmp import RtmpReadStream
        return RtmpReadStream(url)
    if scheme == "ftp":
        return FtpStream(url)
    if scheme == "gopher":
        return GopherStream(url)
    if scheme:
        raise ProtocolNotFound(f"protocol {scheme!r} not supported")
    return None


def open_url_write(url: str):
    """Writable protocol endpoint (ffurl_open WRITE analog); None for
    protocols avio handles natively."""
    scheme = url.split("://", 1)[0] if "://" in url else ""
    if scheme == "rtmp":
        from .rtmp import RtmpWriteStream
        return RtmpWriteStream(url)
    if scheme == "icecast":
        return IcecastStream(url)
    if url.startswith("tee:"):
        return TeeWriteStream(url)
    return None


def protocol_names():
    return ["file", "pipe", "fd", "memory", "http", "https", "tcp",
            "tls", "udp", "rtmp", "concat", "subfile", "cache",
            "async", "data", "ftp", "gopher", "icecast", "tee"]


# --------------------------------------------------------------------------
# nested protocols: concat: / subfile, / cache: / async:
# (reference: libavformat/concat.c, subfile.c, cache.c, async.c)

def _open_inner(url: str):
    """Open a nested target as a raw file-like."""
    nested = open_nested(url)
    if nested is not None:
        return nested
    if "://" in url:
        f = open_url(url)
        if f is None:
            raise ProtocolNotFound(url)
        return f
    if url.startswith("file:"):
        url = url[5:]
    return open(url, "rb")


class ConcatStream:
    """concat:url1|url2|... — sequential byte concatenation."""

    def __init__(self, spec: str):
        self._urls = [u for u in spec.split("|") if u]
        if not self._urls:
            raise InvalidData("concat: empty list")
        self._files = [_open_inner(u) for u in self._urls]
        self._idx = 0
        sizes = []
        for f in self._files:
            try:
                pos = f.tell()
                f.seek(0, 2)
                sizes.append(f.tell())
                f.seek(pos)
            except (OSError, AttributeError):
                sizes = None
                break
        self.size = sum(sizes) if sizes else None
        self._sizes = sizes
        self._pos = 0

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while self._idx < len(self._files) and (n < 0 or len(out) < n):
            want = -1 if n < 0 else n - len(out)
            chunk = self._files[self._idx].read(want)
            if not chunk:
                self._idx += 1
                continue
            out += chunk
        self._pos += len(out)
        return bytes(out)

    def seek(self, pos: int, whence: int = 0) -> int:
        if self._sizes is None:
            raise OSError("concat: not seekable")
        if whence == 1:
            pos += self._pos
        elif whence == 2:
            pos += self.size
        rem = pos
        for i, sz in enumerate(self._sizes):
            if rem <= sz or i == len(self._sizes) - 1:
                self._idx = i
                self._files[i].seek(min(rem, sz))
                for f in self._files[i + 1:]:
                    f.seek(0)
                break
            rem -= sz
        self._pos = pos
        return pos

    def tell(self) -> int:
        return self._pos

    def close(self) -> None:
        for f in self._files:
            try:
                f.close()
            except OSError:
                pass


class SubfileStream:
    """subfile,,start,N,end,M,,:url — byte window over a seekable
    input (subfile.c option syntax; end=0 means to-EOF)."""

    def __init__(self, spec: str):
        if not spec.startswith("subfile,"):
            raise InvalidData("subfile: bad url")
        opts_part, _, target = spec[len("subfile,"):].partition(",:")
        toks = [t for t in opts_part.replace(",,", ",").split(",") if t]
        kv = dict(zip(toks[0::2], [int(x) for x in toks[1::2]]))
        self._start = kv.get("start", 0)
        self._end = kv.get("end", 0)
        self._f = _open_inner(target)
        if self._end == 0:
            self._f.seek(0, 2)
            self._end = self._f.tell()
        self.size = self._end - self._start
        self._f.seek(self._start)
        self._pos = 0

    def read(self, n: int = -1) -> bytes:
        left = self.size - self._pos
        if left <= 0:
            return b""
        want = left if n < 0 else min(n, left)
        data = self._f.read(want)
        self._pos += len(data)
        return data

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            pos += self._pos
        elif whence == 2:
            pos += self.size
        pos = max(0, min(pos, self.size))
        self._f.seek(self._start + pos)
        self._pos = pos
        return pos

    def tell(self) -> int:
        return self._pos

    def close(self) -> None:
        self._f.close()


class CacheStream:
    """cache:url — backward seeks served from an in-memory cache of
    everything read so far (cache.c semantics, memory-backed)."""

    def __init__(self, spec: str):
        self._f = _open_inner(spec)
        self._cache = bytearray()
        self._pos = 0
        self.size = getattr(self._f, "size", None)

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        if self._pos < len(self._cache):
            take = len(self._cache) - self._pos if n < 0 else n
            out += self._cache[self._pos:self._pos + take]
            self._pos += len(out)
        while n < 0 or len(out) < n:
            want = -1 if n < 0 else n - len(out)
            chunk = self._f.read(want)
            if not chunk:
                break
            self._cache += chunk
            self._pos += len(chunk)
            out += chunk
            if n < 0:
                break
        return bytes(out)

    def seek(self, pos: int, whence: int = 0) -> int:
        if whence == 1:
            pos += self._pos
        elif whence == 2:
            if self.size is None:
                # drain to EOF into the cache
                while True:
                    c = self._f.read(1 << 20)
                    if not c:
                        break
                    self._cache += c
                self.size = len(self._cache)
            pos += self.size
        if pos > len(self._cache):              # forward: pull through
            self._pos = len(self._cache)
            self.read(pos - len(self._cache))
        self._pos = min(pos, len(self._cache))
        return self._pos

    def tell(self) -> int:
        return self._pos

    def close(self) -> None:
        self._f.close()


class AsyncStream:
    """async:url — background-thread read-ahead (async.c): the reader
    thread fills a bounded buffer so demux never blocks on the wire."""

    BUF_MAX = 8 << 20

    def __init__(self, spec: str):
        import threading
        self._f = _open_inner(spec)
        self.size = getattr(self._f, "size", None)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._buf = bytearray()
        self._eof = False
        self._err: Optional[BaseException] = None
        self._closed = False
        self._t = threading.Thread(target=self._fill, daemon=True,
                                   name="async-read")
        self._t.start()

    def _fill(self) -> None:
        try:
            while True:
                with self._cond:
                    while (len(self._buf) >= self.BUF_MAX
                           and not self._closed):
                        self._cond.wait(0.05)
                    if self._closed:
                        return
                chunk = self._f.read(1 << 16)
                with self._cond:
                    if not chunk:
                        self._eof = True
                        self._cond.notify_all()
                        return
                    self._buf += chunk
                    self._cond.notify_all()
        except (OSError, EOFError) as e:
            with self._cond:
                self._err = e
                self._eof = True
                self._cond.notify_all()

    def read(self, n: int = -1) -> bytes:
        # Drain in <= BUF_MAX slices: the fill thread parks once the buffer
        # is full, so waiting for len(buf) >= n with n > BUF_MAX livelocks.
        out = bytearray()
        with self._cond:
            while True:
                want = self.BUF_MAX if n < 0 else n - len(out)
                while (not self._eof and len(self._buf) < want
                       and len(self._buf) < self.BUF_MAX):
                    self._cond.wait(0.05)
                if self._err is not None and not self._buf and not out:
                    raise InvalidData(f"async: {self._err}")
                take = len(self._buf) if n < 0 else min(want, len(self._buf))
                out += self._buf[:take]
                del self._buf[:take]
                self._cond.notify_all()
                if self._eof and not self._buf:
                    break
                if n >= 0 and len(out) >= n:
                    break
            return bytes(out)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        self._t.join(timeout=5)
        self._f.close()


def open_nested(url: str):
    if url.startswith("concat:"):
        return ConcatStream(url[len("concat:"):])
    if url.startswith("subfile,"):
        return SubfileStream(url)
    if url.startswith("cache:"):
        return CacheStream(url[len("cache:"):])
    if url.startswith("async:"):
        return AsyncStream(url[len("async:"):])
    return None
