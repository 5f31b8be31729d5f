"""The port's segment and streaming formats (io/formats/concat_seg.py,
tee_fifo.py, dashenc.py, rtp.py and rtpenc.py) against the reference's,
on the CPU and over loopback.

- Each module is the reference's code: its top-level statements equal
  the reference's as syntax trees.
- concat reads a playlist of the reference muxers' files to the
  reference's packets; segment, tee and fifo write the reference's
  files, byte for byte, and fail as it does; fifo recovers, gives up and
  drops packets as the reference does, and its writer thread has ended
  within a few seconds of every test.
- dash writes the reference's MPD, init and media segments, byte for
  byte.
- rtp writes the reference's RTP packets, byte for byte, and its SDP.
- SDP sessions over loopback UDP (RTP of H.264, AAC, MPEG audio, MPEG
  video, L16 and an MPEG-TS): the port's demuxer gives the reference
  demuxer's packets on the same datagrams, from either package's muxer.
- RTSP over loopback TCP: the port's PLAY server to the port's PLAY
  client, the port's RECORD client to the port's listening demuxer, and
  the reference's PLAY server and RECORD client to the port's demuxer,
  each delivering the packets that were written.

Sockets: every port is found by binding port 0; every demuxer waits at
most 2 s (listen_timeout, idle_timeout) and every muxer 2 s (timeout);
every thread is joined with a timeout, and a test fails rather than
hangs.
"""

import socket
import struct
import threading
import time

import pytest

from ffmpeg_tpu.core.packet import Packet as RefPacket
from ffmpeg_tpu.io import mux as ref_mux
from ffmpeg_tpu.io import open_input as ref_open_input
from ffmpeg_tpu.io import open_output as ref_open_output
from ffmpeg_tpu.io.formats import rtpenc as ref_rtpenc
from ffmpeg_tpu.io.stream import CodecParameters as RefPar
from ffmpeg_tpu.io.stream import MediaType as RefType
from ffmpeg_tpu.utils.error import EndOfStream as RefEndOfStream
from ffmpeg_tpu.utils.error import InvalidData as RefInvalidData
from ffmpeg_tpu.utils.rational import Rational as RefRational
from ffmpeg_tpu_torch.io import mux, open_input, open_output
from ffmpeg_tpu_torch.io.formats import rtpenc
from ffmpeg_tpu_torch.utils.error import EndOfStream, InvalidData

from torch_io_util import (DATA, SOURCES, assert_same_demux, demuxed,
                           differing, mux_with, pcm_source, plain, to_port)

MODULES = [f"io/formats/{m}.py" for m in (
    "concat_seg", "tee_fifo", "dashenc", "rtp", "rtpenc")]
WAIT = 2.0          # every socket wait, in seconds
JOIN = 10.0         # every thread join


@pytest.mark.parametrize("rel", MODULES)
def test_module_is_the_reference_code(rel):
    assert differing(rel) == set()


def test_rtpenc_registers_the_reference_muxers():
    assert rtpenc.RtpMuxer.name == "rtp" and rtpenc.RtspMuxer.name == "rtsp"
    assert mux._MUXERS["rtp"] is rtpenc.RtpMuxer
    assert set(ref_rtpenc._PAYS) == set(rtpenc._PAYS)


# --- concat and segment ------------------------------------------------------

def _mux_url(side, fmt, url, streams, pkts):
    """Write the packets through one package's muxer at `url`; the error's
    class name, or None."""
    opener, conv = ((open_output, to_port) if side == "port"
                    else (ref_open_output, lambda x: x))
    try:
        m = opener(url, format=fmt)
        for par, tb in streams:
            m.add_stream(conv(par), time_base=conv(tb))
        for p in pkts:
            m.write_packet(conv(p))
        m.write_trailer()
        m.close()
    except Exception as e:  # noqa: BLE001 — the error is the result
        return type(e).__name__
    return None


def test_concat_reads_a_playlist_as_the_reference(tmp_path):
    """Three Matroska parts of H.264 + AAC from the reference's muxer, a
    playlist with a comment, quotes and a subdirectory: the parts'
    packets in turn, each part's timestamps after the last one's."""
    streams, pkts = SOURCES["av"]()
    (tmp_path / "ref" / "sub").mkdir(parents=True)
    for name in ("p0.mkv", "p1.mkv", "sub/p2.mkv"):
        assert _mux_url("ref", "matroska", str(tmp_path / "ref" / name),
                        streams, pkts) is None
    (tmp_path / "list.ffconcat").write_text(
        "ffconcat version 1.0\n# parts\nfile 'ref/p0.mkv'\n"
        "file ref/p1.mkv\n\nfile \"ref/sub/p2.mkv\"\n")
    assert_same_demux(str(tmp_path / "list.ffconcat"), n_min=3 * len(pkts))
    (tmp_path / "empty.ffconcat").write_text("ffconcat version 1.0\n")
    errors = [type(_raises(o, str(tmp_path / "empty.ffconcat"))).__name__
              for o in (ref_open_input, open_input)]
    assert errors == ["InvalidData", "InvalidData"]


def _raises(fn, *a, **kw):
    try:
        fn(*a, **kw)
    except Exception as e:  # noqa: BLE001 — the error is the result
        return e
    raise AssertionError(f"{fn} did not raise")


# (source, segment_format, url, segment_time)
SEGMENTS = [
    ("av", "mpegts", "seg%03d.ts", 0.2),
    ("av", "matroska", "seg%d.mkv", 0.1),
    ("rawvideo", "matroska", "part", 0.04),
    ("mjpeg", "mov", "s-%02d.mov", 0.01),
    ("h264", "mpegts", "h%d.ts", 0.04),
]


@pytest.mark.parametrize("case", SEGMENTS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_segment_writes_the_reference_files(tmp_path, case):
    src, fmt, url, secs = case
    streams, pkts = SOURCES[src]()
    got = {side: mux_with(tmp_path, side, "segment", url, streams, pkts,
                          segment_format=fmt, segment_time=secs)
           for side in ("ref", "port")}
    assert got["port"] == got["ref"]
    assert isinstance(got["ref"], dict) and len(got["ref"]) > 1
    assert all(got["ref"].values())


# --- tee and fifo ------------------------------------------------------------

def test_tee_writes_the_reference_slaves(tmp_path):
    """MJPEG + PCM to four slaves: the video to AVI and to MPEG-TS, the
    audio to WAV, and an AVI in a missing directory that onfail=ignore
    drops."""
    streams, pkts = SOURCES["mjpeg_pcm"]()
    got = {}
    for side in ("ref", "port"):
        d = tmp_path / side
        d.mkdir()
        url = (f"[f=avi:select=v]{d}/v.avi|[f=wav:select=a]{d}/a.wav|"
               f"[f=mpegts:select=v]{d}/x.ts|"
               f"[f=avi:onfail=ignore]{d}/no/x.avi")
        got[side] = (_mux_url(side, "tee", url, streams, pkts),
                     {f.name: f.read_bytes() for f in d.iterdir()})
    assert got["port"] == got["ref"]
    assert got["ref"][0] is None
    assert set(got["ref"][1]) == {"v.avi", "a.wav", "x.ts"}
    assert all(got["ref"][1].values())


def test_tee_refuses_as_the_reference(tmp_path):
    """A slave in a missing directory aborts by default; a slave that
    selects nothing, or a list of slaves that all fail, is refused."""
    streams, pkts = SOURCES["mjpeg"]()
    for url in ("[f=avi]{d}/no/x.avi", "[f=avi:select=a]{d}/x.avi",
                "[f=avi:onfail=ignore]{d}/no/x.avi"):
        errors = []
        for side, opener, conv in (("ref", ref_open_output, lambda x: x),
                                   ("port", open_output, to_port)):
            m = opener(url.format(d=tmp_path / side), format="tee")
            for par, tb in streams:
                m.add_stream(conv(par), time_base=conv(tb))
            e = _raises(m.write_header)
            errors.append((type(e).__name__, str(e).replace(
                str(tmp_path / side), "D")))
        assert errors[1] == errors[0]


def _fifo_run(tmp_path, side, streams, pkts, **opts):
    """Packets through one package's fifo muxer, timed; the muxer, the
    error it raised (or None) and its files."""
    d = tmp_path / side
    d.mkdir(exist_ok=True)
    opener, conv = ((open_output, to_port) if side == "port"
                    else (ref_open_output, lambda x: x))
    t = time.monotonic()
    m = opener(str(d / "out.avi"), format="fifo", **opts)
    err = None
    try:
        for par, tb in streams:
            m.add_stream(conv(par), time_base=conv(tb))
        for p in pkts:
            m.write_packet(conv(p))
            if opts.get("attempt_recovery"):
                time.sleep(0.002)   # let the thread meet each failure
        m.write_trailer()
    except Exception as e:  # noqa: BLE001 — the error is the result
        err = e
    m._thread.join(JOIN)
    assert not m._thread.is_alive(), "the fifo's thread did not end"
    assert time.monotonic() - t < 10.0
    return m, err, {f.name: f.read_bytes() for f in d.iterdir()}


def test_fifo_writes_the_reference_file(tmp_path):
    streams, pkts = SOURCES["mjpeg_pcm"]()
    got = {s: _fifo_run(tmp_path, s, streams, pkts, fifo_format="avi")
           for s in ("ref", "port")}
    assert got["ref"][1] is None and got["port"][1] is None
    assert got["port"][2] == got["ref"][2]
    direct = mux_with(tmp_path, "direct", "avi", "out.avi", streams, pkts)
    assert got["ref"][2] == direct


class _Flaky:
    """The state of a sink whose first `fails` packet writes fail."""

    def __init__(self, fails: int):
        self.fails, self.written, self.headers = fails, [], 0


def _flaky_muxer(base, state: _Flaky):
    """A muxer class of either package's Muxer over `state`."""
    class Flaky(base):
        name = "_flaky_test"
        interleave = False

        def _write_header(self):
            state.headers += 1

        def _write_packet(self, pkt):
            if state.fails > 0:
                state.fails -= 1
                raise (RefInvalidData if base is ref_mux.Muxer
                       else InvalidData)("flaky sink down")
            state.written.append(bytes(pkt.data))
    return Flaky


@pytest.mark.parametrize("fails,opts", [
    (3, {"attempt_recovery": True, "recovery_wait_time": 0.01,
         "max_recovery_attempts": 10}),
    (100, {"attempt_recovery": True, "recovery_wait_time": 0.005,
           "max_recovery_attempts": 2}),
    (2, {}),
    (3, {"attempt_recovery": True, "recovery_wait_time": 0.01,
         "restart_with_keyframe": True}),
], ids=["recovers", "gives-up", "no-recovery", "restart-with-keyframe"])
def test_fifo_recovers_as_the_reference(tmp_path, monkeypatch, fails, opts):
    streams, pkts = SOURCES["h264"]()
    out = {}
    for side, registry, base in (("ref", ref_mux._MUXERS, ref_mux.Muxer),
                                 ("port", mux._MUXERS, mux.Muxer)):
        state = _Flaky(fails)
        monkeypatch.setitem(registry, "_flaky_test",
                            _flaky_muxer(base, state))
        m, err, _files = _fifo_run(tmp_path, side, streams, pkts,
                                   fifo_format="_flaky_test", **opts)
        out[side] = (type(err).__name__ if err else None, state.written,
                     state.headers, m._recoveries)
    assert out["port"] == out["ref"]
    if fails == 3:
        assert out["ref"][0] is None and out["ref"][3] == 3


def test_fifo_drops_on_overflow_without_deadlock(tmp_path, monkeypatch):
    """A two-packet queue that drops on overflow: every packet is written
    or counted as dropped, and the trailer returns."""
    streams, pkts = SOURCES["rawvideo"]()
    state = _Flaky(0)
    monkeypatch.setitem(mux._MUXERS, "_flaky_test",
                        _flaky_muxer(mux.Muxer, state))
    m, err, _ = _fifo_run(tmp_path, "port", streams, pkts * 20,
                          fifo_format="_flaky_test", queue_size=2,
                          drop_pkts_on_overflow=True)
    assert err is None
    assert len(state.written) + m._dropped == 60


# --- DASH --------------------------------------------------------------------

@pytest.mark.parametrize("src,secs", [("av", 0.2), ("h264", 0.04),
                                      ("aac", 0.1), ("mjpeg", 0.04)])
def test_dash_writes_the_reference_files(tmp_path, src, secs):
    streams, pkts = SOURCES[src]()
    got = {side: mux_with(tmp_path, side, "dash", "o.mpd", streams, pkts,
                          seg_duration=secs) for side in ("ref", "port")}
    assert got["port"] == got["ref"]
    assert "o.mpd" in got["ref"] and len(got["ref"]) >= 3


# --- RTP packets and SDP -----------------------------------------------------

class _Datagrams:
    """A writer that keeps each write, as a UDP writer sends each as one
    datagram."""

    def __init__(self):
        self.out = []

    def write(self, data):
        self.out.append(bytes(data))

    def flush(self):
        pass


def _mpeg2_source(tmp_path):
    from ffmpeg_tpu_torch import testing as fx
    from ffmpeg_tpu_torch.codecs import CodecContext, EncoderParameters
    enc = CodecContext.open_encoder(EncoderParameters("mpeg2video", 48, 32),
                                    {"qscale": 6}, device="cpu")
    data = b""
    for f in fx.mpeg2_clip(3, 48, 32):
        enc.send_frame(f)
        data += enc.receive_packet().data
    (tmp_path / "c.m2v").write_bytes(data)
    return demuxed(tmp_path / "c.m2v")


def _rtp_source(tmp_path, name):
    import numpy as np
    if name == "mpeg2":
        return _mpeg2_source(tmp_path)
    if name == "pcm_s16be":
        return pcm_source("pcm_s16be", "s16", ">i2", 2)
    if name in ("mp3", "mp2"):
        z = np.load(DATA / "port" / "audio_streams.npz")
        key = "mp3_reservoir" if name == "mp3" else "mp2_stereo"
        p = tmp_path / f"a.{name}"
        p.write_bytes(z[f"{key}_data"].tobytes())
        return demuxed(p, n=30)
    streams, pkts = SOURCES[name]()
    return streams[:1], [p for p in pkts if p.stream_index == 0]


def _rtp_datagrams(side, streams, pkts):
    """One package's RTP muxer on the stream: its datagrams and SDP."""
    conv = to_port if side == "port" else (lambda x: x)
    opener = open_output if side == "port" else ref_open_output
    w = _Datagrams()
    m = opener(w, format="rtp")
    for par, tb in streams:
        m.add_stream(conv(par), time_base=conv(tb))
    for p in pkts:
        m.write_packet(conv(p))
    m.write_trailer()
    return w.out, m.sdp("127.0.0.1", 5004)


RTP_CODECS = ["h264", "aac", "mp3", "mp2", "mpeg2", "pcm_s16be"]
# the codecs whose SDP sessions the reference's demuxer reads; for AAC
# and L16 it raises (rtp.py:155, :241 pass CodecParameters a `channels`
# argument, which is a read-only property there), and so does the port
SDP_CODECS = ["h264", "mp3", "mp2", "mpeg2"]


@pytest.mark.parametrize("name", RTP_CODECS)
def test_rtp_packets_equal_the_reference(tmp_path, name):
    streams, pkts = _rtp_source(tmp_path, name)
    ref = _rtp_datagrams("ref", streams, pkts)
    port = _rtp_datagrams("port", streams, pkts)
    assert port == ref
    assert len(ref[0]) >= len(pkts) and "m=" in ref[1]


def test_rtp_refuses_as_the_reference(tmp_path):
    """Two streams, or a codec with no packetizer."""
    for streams, pkts in (SOURCES["av"](), SOURCES["vp9"]()):
        errors = []
        for side in ("ref", "port"):
            e = _raises(_rtp_datagrams, side, streams, pkts)
            errors.append((type(e).__name__, str(e)))
        assert errors[1] == errors[0] and errors[0][0] in (
            "InvalidData", "NotSupported")


def _free_port(kind=socket.SOCK_DGRAM) -> int:
    s = socket.socket(socket.AF_INET, kind)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _udp_bound(port: int) -> bool:
    """Whether a UDP socket is bound to `port` (Linux's socket table)."""
    for table in ("/proc/net/udp", "/proc/net/udp6"):
        try:
            lines = open(table).read().splitlines()[1:]
        except OSError:
            continue
        if any(int(ln.split()[1].split(":")[1], 16) == port for ln in lines):
            return True
    return False


def _send(datagrams, port, wait_bound=False):
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    if wait_bound:
        deadline = time.monotonic() + WAIT
        while not _udp_bound(port):
            assert time.monotonic() < deadline, "the demuxer never bound"
            time.sleep(0.005)
    for d in datagrams:
        s.sendto(d, ("127.0.0.1", port))
        time.sleep(0.0005)
    s.close()


def _drain(d) -> list:
    out = []
    while True:
        try:
            out.append(d.read_packet())
        except (EndOfStream, RefEndOfStream):
            return out


def _sdp_session(tmp_path, opener, sdp: str, datagrams) -> tuple:
    """Open the SDP (its sockets bound before this returns), send the
    datagrams to its port, read until the session is idle."""
    port = int(sdp.split("m=")[1].split()[1])
    p = tmp_path / f"s{port}.sdp"
    p.write_text(sdp)
    d = opener(str(p), listen_timeout=WAIT, idle_timeout=0.3)
    try:
        _send(datagrams, port)
        pkts = _drain(d)
    finally:
        for s in getattr(d, "_socks", []):
            s.close()
    return plain([st.codecpar for st in d.streams]), plain(pkts)


@pytest.mark.parametrize("name", SDP_CODECS)
def test_sdp_session_over_loopback(tmp_path, name):
    """The port's RTP muxer's datagrams and SDP, sent to the port's SDP
    demuxer and to the reference's on loopback: the same packets, whose
    payloads are the packets written; the reference muxer's datagrams to
    the port's demuxer likewise."""
    streams, pkts = _rtp_source(tmp_path, name)
    grams, sdp = _rtp_datagrams("port", streams, pkts)
    ref_grams, ref_sdp = _rtp_datagrams("ref", streams, pkts)
    runs = []
    for opener, g, text in ((open_input, grams, sdp),
                            (ref_open_input, grams, sdp),
                            (open_input, ref_grams, ref_sdp)):
        port = _free_port()
        runs.append(_sdp_session(tmp_path, opener, text.replace(
            "5004", str(port)), g))
    assert runs[0] == runs[1] == runs[2]
    got = [p[1]["data"] for p in runs[0][1]]
    if name in ("h264",):
        assert len(got) == len(pkts)
    else:
        assert b"".join(got) == b"".join(bytes(p.data) for p in pkts)


@pytest.mark.parametrize("name", ["aac", "pcm_s16be"])
def test_sdp_aac_and_l16_fail_as_the_reference(tmp_path, name):
    streams, pkts = _rtp_source(tmp_path, name)
    _grams, sdp = _rtp_datagrams("port", streams, pkts)
    errors = []
    for opener in (ref_open_input, open_input):
        port = _free_port()
        p = tmp_path / f"s{port}.sdp"
        p.write_text(sdp.replace("5004", str(port)))
        e = _raises(opener, str(p), listen_timeout=WAIT, idle_timeout=0.3)
        errors.append((type(e).__name__, str(e)))
    assert errors[1] == errors[0] and "channels" in errors[0][1]


def test_sdp_mpegts_session_over_loopback(tmp_path):
    """An MPEG-TS over RTP (payload type 33): the demuxer collects the
    transport stream until the session is idle and demuxes it."""
    streams, pkts = SOURCES["av"]()
    ts = mux_with(tmp_path, "port", "mpegts", "o.ts", streams, pkts)["o.ts"]
    grams = [struct.pack(">BBHII", 0x80, 33, i, 3600 * i, 0x1234)
             + ts[k:k + 7 * 188]
             for i, k in enumerate(range(0, len(ts), 7 * 188))]
    runs = []
    for opener in (open_input, ref_open_input):
        port = _free_port()
        p = tmp_path / f"t{port}.sdp"
        p.write_text("v=0\r\no=- 0 0 IN IP4 127.0.0.1\r\ns=No Name\r\n"
                     "c=IN IP4 127.0.0.1\r\nt=0 0\r\n"
                     f"m=video {port} RTP/AVP 33\r\n")
        sender = threading.Thread(target=_send, args=(grams, port, True),
                                  daemon=True)
        sender.start()
        d = opener(str(p), listen_timeout=WAIT, idle_timeout=0.3)
        sender.join(JOIN)
        assert not sender.is_alive()
        runs.append((plain([st.codecpar for st in d.streams]),
                     plain(_drain(d))))
    assert runs[0] == runs[1]
    assert len(runs[0][1]) == len(pkts)


# --- RTSP --------------------------------------------------------------------

def _retry(fn, refused=("ConnectionRefusedError",)):
    """Call fn until the server it connects to listens (at most WAIT s)."""
    deadline = time.monotonic() + WAIT
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — retried or re-raised
            text = f"{type(e).__name__}: {e}"
            if not any(r in text for r in refused) or \
                    time.monotonic() > deadline:
                raise
            time.sleep(0.01)


def _thread(fn, out: dict):
    def run():
        try:
            out["result"] = fn()
        except Exception as e:  # noqa: BLE001 — reported by the test
            out["error"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


def _join(t, out):
    t.join(JOIN)
    assert not t.is_alive(), "a loopback thread did not end"
    if "error" in out:
        raise out["error"]
    return out.get("result")


def _rtsp_source():
    """H.264 and MPEG audio, two interleaved channels."""
    import numpy as np
    vs, vp = SOURCES["h264"]()
    z = np.load(DATA / "port" / "audio_streams.npz")
    data = z["mp2_stereo_data"].tobytes()
    par = RefPar(codec_type=RefType.AUDIO, codec_id="mp3")
    tb = RefRational(1, 90000)
    from ffmpeg_tpu.io.parsers import split_mpeg_audio
    frames = split_mpeg_audio(data)[0][:12]
    ap = [RefPacket(data=f, pts=2160 * i, dts=2160 * i, stream_index=1,
                    time_base=tb) for i, f in enumerate(frames)]
    for p in vp:
        p.stream_index = 0
    return vs + [(par, tb)], vp, ap


def _write_rtsp(opener, conv, url, streams, pkts, **opts):
    m = opener(url, format="rtsp", timeout=WAIT, **opts)
    for par, tb in streams:
        m.add_stream(conv(par), time_base=conv(tb))
    if not opts.get("listen"):
        _retry(m.write_header)
    for p in pkts:
        m.write_packet(conv(p))
    m.write_trailer()
    m.close()


def _read_rtsp(opener, url, **opts):
    d = opener(url, listen_timeout=WAIT, **opts)
    pkts = _drain(d)
    return [st.codecpar.codec_id for st in d.streams], pkts


@pytest.mark.parametrize("server", ["port", "ref"])
def test_rtsp_play_to_the_ports_client(server):
    """A PLAY server (RtspMuxer with listen) of either package streams
    H.264 and MPEG audio over TCP-interleaved RTP to the port's PLAY
    client: each stream's payloads as written."""
    streams, vp, ap = _rtsp_source()
    url = f"rtsp://127.0.0.1:{_free_port(socket.SOCK_STREAM)}/live"
    opener, conv = ((open_output, to_port) if server == "port"
                    else (ref_open_output, lambda x: x))
    out = {}
    t = _thread(lambda: _write_rtsp(opener, conv, url, streams,
                                    sorted(vp + ap, key=_time), listen=True),
                out)
    codecs, pkts = _retry(lambda: _read_rtsp(open_input, url),
                          ("ConnectionRefusedError",))
    _join(t, out)
    assert codecs == ["h264", "mp3"]
    _assert_payloads(pkts, vp, ap)


def _time(p):
    return (p.pts * p.time_base.num / p.time_base.den, p.stream_index)


def _assert_payloads(pkts, vp, ap):
    """Each stream's depacketized payloads: the MPEG audio frames as
    written; the H.264 access units' NAL units as written."""
    got_a = [bytes(p.data) for p in pkts if p.stream_index == 1]
    assert got_a == [bytes(p.data) for p in ap]
    got_v = [rtpenc._split_annexb(bytes(p.data)) for p in pkts
             if p.stream_index == 0]
    want_v = [rtpenc._split_annexb(bytes(p.data)) for p in vp]
    assert got_v == want_v and want_v


@pytest.mark.parametrize("client", ["port", "ref"])
def test_rtsp_record_to_the_ports_listener(client):
    """A RECORD client (RtspMuxer) of either package publishes to the
    port's demuxer with rtsp_flags=listen: each stream's payloads as
    written."""
    streams, vp, ap = _rtsp_source()
    url = f"rtsp://127.0.0.1:{_free_port(socket.SOCK_STREAM)}/pub"
    opener, conv = ((open_output, to_port) if client == "port"
                    else (ref_open_output, lambda x: x))
    out = {}
    t = _thread(lambda: _read_rtsp(open_input, url, rtsp_flags="listen"),
                out)
    _write_rtsp(opener, conv, url, streams, sorted(vp + ap, key=_time))
    codecs, pkts = _join(t, out)
    assert codecs == ["h264", "mp3"]
    _assert_payloads(pkts, vp, ap)


def test_rtsp_client_without_a_server_fails_as_the_reference():
    url = f"rtsp://127.0.0.1:{_free_port(socket.SOCK_STREAM)}/x"
    errors = []
    for opener in (ref_open_input, open_input):
        e = _raises(opener, url, listen_timeout=WAIT)
        errors.append((type(e).__name__, str(e)))
    assert errors[1] == errors[0] and "ConnectionRefused" in errors[0][1]
