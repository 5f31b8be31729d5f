"""tee + fifo muxers (reference: libavformat/tee.c, fifo.c).

tee fans every packet out to N slave muxers, each with its own format
and stream selection, continuing on slave failure when onfail=ignore.

fifo decouples the pipeline from a flaky sink: packets go through a
bounded queue into a writer thread, and write failures trigger the
attempt_recovery/max_recovery_attempts/recovery_wait_time retry loop
(fifo.c:52-61) — the failure-recovery subsystem of SURVEY §5.

The port's copy of ffmpeg_tpu/io/formats/tee_fifo.py, held equal to it by
tests/test_torch_io_streaming.py.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import List, Optional

from ...core.packet import Packet, PKT_FLAG_KEY
from ...utils.error import FFTPUError, InvalidData
from ..mux import Muxer, open_output, register_muxer
from ..stream import MediaType


def _parse_slave(spec: str):
    """'[f=mpegts:select=v:onfail=ignore]url' -> (opts, url)."""
    opts = {}
    if spec.startswith("["):
        end = spec.index("]")
        for kv in spec[1:end].split(":"):
            if not kv:
                continue
            k, _, v = kv.partition("=")
            opts[k.strip()] = v.strip()
        spec = spec[end + 1:]
    return opts, spec


def _match_select(select: Optional[str], st) -> bool:
    if not select:
        return True
    for part in select.split(","):
        part = part.strip()
        typ, _, idx = part.partition(":")
        want = {"v": MediaType.VIDEO, "a": MediaType.AUDIO,
                "s": MediaType.SUBTITLE}.get(typ)
        if want is None:
            if part.isdigit() and st.index == int(part):
                return True
            continue
        if st.codecpar.codec_type != want:
            continue
        if not idx or st.index == int(idx):
            return True
    return False


class _Slave:
    def __init__(self, opts: dict, url: str, streams):
        self.onfail = opts.get("onfail", "abort")
        self.failed = False
        self.url = url
        select = opts.get("select")
        self.index_map = {}
        self.mux = open_output(url, format=opts.get("f"))
        for st in streams:
            if _match_select(select, st):
                self.index_map[st.index] = len(self.index_map)
                self.mux.add_stream(st.codecpar, time_base=st.time_base)
        if not self.index_map:
            raise InvalidData(f"tee: slave {url!r} selects no streams")


@register_muxer
class TeeMuxer(Muxer):
    """Fan-out muxer: url is 'slave1|slave2|...' (tee.c syntax)."""

    name = "tee"
    flags_no_file = True
    interleave = False
    use_fifo = False

    def _write_header(self) -> None:
        self._slaves: List[_Slave] = []
        for spec in self.url.split("|"):
            opts, url = _parse_slave(spec.strip())
            try:
                self._slaves.append(_Slave(opts, url, self.streams))
            except (FFTPUError, OSError) as e:
                if opts.get("onfail", "abort") == "ignore":
                    self.warning(f"tee: slave {url!r} failed to open: {e}")
                else:
                    raise
        if not self._slaves:
            raise InvalidData("tee: no usable slaves")
        for s in self._slaves:
            s.mux.write_header()

    def _write_packet(self, pkt: Packet) -> None:
        for s in self._slaves:
            if s.failed or pkt.stream_index not in s.index_map:
                continue
            sp = Packet(data=pkt.data, pts=pkt.pts, dts=pkt.dts,
                        duration=pkt.duration, flags=pkt.flags,
                        stream_index=s.index_map[pkt.stream_index],
                        time_base=pkt.time_base,
                        side_data=dict(pkt.side_data))
            try:
                s.mux.write_packet(sp)
            except (FFTPUError, OSError) as e:
                if s.onfail == "ignore":
                    self.warning(f"tee: slave {s.url!r} failed: {e}")
                    s.failed = True
                    try:
                        s.mux.close()
                    except (FFTPUError, OSError):
                        pass
                else:
                    raise

    def _write_trailer(self) -> None:
        for s in self._slaves:
            if not s.failed:
                s.mux.write_trailer()
                s.mux.close()


@register_muxer
class FifoMuxer(Muxer):
    """Background-thread muxer with bounded queue + failure recovery
    (fifo.c): the pipeline never blocks on a slow/flaky sink."""

    name = "fifo"
    flags_no_file = True
    interleave = False

    fifo_format: Optional[str] = None
    queue_size = 60
    drop_pkts_on_overflow = False
    attempt_recovery = False
    max_recovery_attempts = 0          # 0 = unlimited
    recovery_wait_time = 5.0
    restart_with_keyframe = False

    def _write_header(self) -> None:
        self._q: "queue.Queue" = queue.Queue(maxsize=int(self.queue_size))
        self._err: Optional[BaseException] = None
        self._recoveries = 0
        self._dropped = 0
        self._inner: Optional[Muxer] = None
        self._open_inner()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="fifo-mux")
        self._thread.start()

    def _open_inner(self) -> None:
        self._inner = open_output(self.url, format=self.fifo_format)
        for st in self.streams:
            self._inner.add_stream(st.codecpar, time_base=st.time_base)
        self._inner.write_header()

    def _run(self) -> None:
        waiting_key = False
        while True:
            pkt = self._q.get()
            if pkt is None:
                return
            if waiting_key:
                if self.restart_with_keyframe and \
                        not (pkt.flags & PKT_FLAG_KEY):
                    continue
                waiting_key = False
            while True:
                try:
                    if self._inner is None:
                        raise InvalidData("fifo: output not open")
                    self._inner.write_packet(pkt)
                    break
                except (FFTPUError, OSError) as e:
                    if not self.attempt_recovery:
                        self._err = e
                        return
                    self._recoveries += 1
                    if self.max_recovery_attempts and \
                            self._recoveries > int(self.max_recovery_attempts):
                        self._err = e
                        return
                    self.warning(
                        f"fifo: output failed ({e}); recovery attempt "
                        f"{self._recoveries}")
                    time.sleep(float(self.recovery_wait_time))
                    if self._inner is not None:
                        try:
                            self._inner.close()
                        except (FFTPUError, OSError):
                            pass
                        self._inner = None
                    try:
                        self._open_inner()
                    except (FFTPUError, OSError) as e2:
                        self.warning(f"fifo: recovery failed: {e2}")
                        self._inner = None
                        continue            # next attempt re-raises above
                    if self.restart_with_keyframe and \
                            not (pkt.flags & PKT_FLAG_KEY):
                        waiting_key = True
                        break               # drop pkt, wait for a keyframe

    def _write_packet(self, pkt: Packet) -> None:
        if self._err is not None:
            raise InvalidData(f"fifo: output thread failed: {self._err}")
        if self.drop_pkts_on_overflow:
            try:
                self._q.put_nowait(pkt)
            except queue.Full:
                self._dropped += 1
        else:
            self._q.put(pkt)

    def _write_trailer(self) -> None:
        self._q.put(None)
        self._thread.join(timeout=60.0)
        if self._err is not None:
            raise InvalidData(f"fifo: output thread failed: {self._err}")
        if self._inner is not None:
            self._inner.write_trailer()
            self._inner.close()
        if self._dropped:
            self.warning(f"fifo: dropped {self._dropped} packets on overflow")
