"""Opus decoder (counterpart of ffmpeg_tpu/codecs/opus/__init__.py;
RFC 6716; reference: libavcodec/opus/dec.c, parse.c).  All three modes:
CELT (configs 16-31), SILK (0-11, NB/MB/WB speech at 8/12/16 kHz
resampled to 48 kHz with a reference-exact polyphase bank), and hybrid
(12-15, SILK WB + CELT bands 17+ with the celt_delay alignment fifo),
including inter-mode switching with resampler flush.

The TOC parse, SILK, its resampler and the mode switches are the
reference's host code.  The CELT layer's IMDCT runs on the decoder's
device, one call per CELT frame (celt.py).  `stats`, when a list, gets
each CELT frame's split; SILK frames make no device call."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ...core.frame import Frame
from ...core.packet import Packet
from ...io.stream import MediaType
from ...utils.error import InvalidData, NotSupported
from ...utils.rational import Rational
from .. import audio_tx
from ..codec import Codec, register_decoder
from . import tables_gen as T
from .celt import CeltDecoder
from .rc import RangeCoder


def parse_packet(data: bytes):
    """→ (config, stereo, [frame bytes]) (opus/parse.c
    ff_opus_parse_packet)."""
    if not data:
        raise InvalidData("opus: empty packet")
    toc = data[0]
    code = toc & 3
    stereo = (toc >> 2) & 1
    config = toc >> 3
    buf = data[1:]
    frames = []
    if code == 0:
        frames = [buf]
    elif code == 1:
        if len(buf) & 1:
            raise InvalidData("opus: bad code-1 packet")
        half = len(buf) // 2
        frames = [buf[:half], buf[half:]]
    elif code == 2:
        ln, used = _frame_len(buf)
        frames = [buf[used:used + ln], buf[used + ln:]]
    else:                                 # code 3
        if not buf:
            raise InvalidData("opus: bad code-3 packet")
        hdr = buf[0]
        count = hdr & 0x3F
        vbr = (hdr >> 7) & 1
        pad = (hdr >> 6) & 1
        pos = 1
        padding = 0
        if pad:
            while True:
                p = buf[pos]
                pos += 1
                padding += p if p < 255 else 254
                if p < 255:
                    break
        if not count:
            raise InvalidData("opus: zero frames")
        end = len(buf) - padding
        if vbr:
            sizes = []
            for _ in range(count - 1):
                ln, used = _frame_len(buf[pos:])
                sizes.append(ln)
                pos += used
            rest = end - pos - sum(sizes)
            sizes.append(rest)
        else:
            per = (end - pos) // count
            sizes = [per] * count
        for ln in sizes:
            if ln < 0 or pos + ln > end:
                raise InvalidData("opus: bad frame size")
            frames.append(buf[pos:pos + ln])
            pos += ln
    return config, stereo, frames


def _frame_len(buf: bytes):
    if not buf:
        raise InvalidData("opus: truncated length")
    v = buf[0]
    if v < 252:
        return v, 1
    if len(buf) < 2:
        raise InvalidData("opus: truncated length")
    return buf[1] * 4 + v, 2


@register_decoder
class OpusDecoder(Codec):
    codec_id = "opus"
    codec_type = MediaType.AUDIO

    def __init__(self, par, options=None, *,
                 device: torch.device | str = "cuda"):
        super().__init__(par, options)
        self.device = audio_tx.open_device(device)
        self.stats: Optional[list] = None
        ed = par.extradata or b""
        self.channels = par.ch_layout.nb_channels if par.ch_layout \
            else 2
        self.pre_skip = 0
        if len(ed) >= 19 and ed[:8] == b"OpusHead":
            self.channels = ed[9]
            self.pre_skip = int.from_bytes(ed[10:12], "little")
            if ed[18] != 0:
                raise NotSupported("opus: multistream mapping")
        if self.channels > 2:
            raise NotSupported("opus: >2 channels")
        self.sample_rate = 48000
        self.celt = CeltDecoder(self.channels, self.device)
        self.silk = None
        self.silk_resampler = None
        self._silk_delayed = 0
        self._celt_fifo = None
        self._last_mode = None
        self._to_skip = self.pre_skip

    def _silk_layer(self, rc, config: int, stereo: int, hybrid: bool):
        """SILK LP layer of one frame → (channels, samples) at 48 kHz
        (opus/dec.c opus_decode_frame SILK path; hybrid clamps to
        WB)."""
        from .silk import SilkDecoder
        from .silk_resample import SilkResampler
        bandwidth = 2 if hybrid else config // 4
        silk_rate = 8000 + 4000 * bandwidth
        duration_ms = ((10, 20)[config & 1] if hybrid
                       else (10, 20, 40, 60)[config & 3])
        frame_duration = int(T.FRAME_DURATION[config])
        if self.silk is None:
            self.silk = SilkDecoder(self.channels)
        pc = {8000: 6, 12000: 4, 16000: 3}[silk_rate]
        pre = None
        if self.silk_resampler is not None and \
                self.silk_resampler.pc != pc:
            # sample-rate change: flush the resampler first
            # (opus_decode_subpacket flush_needed)
            pre = self.silk_resampler.flush(self._silk_delayed)
            self._silk_delayed = 0
            self.silk_resampler = None
        if self.silk_resampler is None:
            self.silk_resampler = SilkResampler(silk_rate,
                                                self.channels)
        nsamp = (silk_rate // 1000) * duration_ms
        output = [np.zeros(nsamp, np.float32)
                  for _ in range(self.channels)]
        self.silk.decode_superframe(rc, output, bandwidth,
                                    stereo + 1, duration_ms)
        outs = self.silk_resampler.convert(output, frame_duration)
        self._silk_delayed += frame_duration - len(outs[0])
        sil = np.stack(outs)
        if pre is not None and len(pre[0]):
            sil = np.concatenate([np.stack(pre), sil], axis=1)
        return sil

    def _decode_hybrid(self, fr: bytes, config: int, stereo: int):
        """hybrid frame: SILK WB + CELT bands 17+, summed with the
        celt_delay alignment fifo (opus/dec.c)."""
        frame_duration = int(T.FRAME_DURATION[config])
        bandwidth = 3 + (config - 12) // 2     # SWB / FB
        rc = RangeCoder(fr)
        sil = self._silk_layer(rc, config, stereo, hybrid=True)
        samples = sil.shape[1]
        if rc.tell() + 37 <= 8 * len(fr):
            if rc.dec_log(12):
                raise NotSupported("opus: hybrid redundancy")
        celt_out = self.celt.decode(rc, stereo + 1, frame_duration,
                                    17, int(T.BAND_END[bandwidth]))
        celt_out = np.asarray(celt_out)
        out = sil.copy()
        pos = 0
        if self._celt_fifo is not None and self._celt_fifo.shape[1]:
            nd = self._celt_fifo.shape[1]
            out[:, :nd] += self._celt_fifo
            pos = nd
        usable = samples - pos
        out[:, pos:pos + usable] += celt_out[:, :usable]
        self._celt_fifo = celt_out[:, usable:].copy()
        return out

    def _switch_mode(self, mode: str):
        """inter-mode state flushes (opus_decode_frame/subpacket)."""
        pre = None
        if mode == "celt" and self.silk_resampler is not None:
            pre = self.silk_resampler.flush(self._silk_delayed)
            self._silk_delayed = 0
            self.silk_resampler = None
            self._celt_fifo = None
        if mode == "celt" and self.silk is not None:
            self.silk.flush()
        if mode == "silk" and self._last_mode in ("celt", "hybrid"):
            self.celt = CeltDecoder(self.channels, self.device)
            self._celt_fifo = None
        self._last_mode = mode
        return pre

    def decode(self, pkt: Optional[Packet]) -> List[Frame]:
        if pkt is None or not pkt.data:
            # EOF: flush remaining resampler delay
            if self.silk_resampler is not None and self._silk_delayed:
                pre = self.silk_resampler.flush(self._silk_delayed)
                self._silk_delayed = 0
                self.silk_resampler = None
                if len(pre[0]):
                    return [Frame.audio(np.stack(pre),
                                        self.sample_rate, "fltp",
                                        pts=None,
                                        time_base=Rational(
                                            1, self.sample_rate))]
            return []
        config, stereo, frames = parse_packet(pkt.data)
        mode = ("silk" if config < 12 else
                "hybrid" if config < 16 else "celt")
        pre = self._switch_mode(mode)
        self.celt.stats = self.stats
        if mode != "celt":
            dec = (self._decode_hybrid if mode == "hybrid"
                   else lambda fr, c, st: self._silk_layer(
                       RangeCoder(fr), c, st, hybrid=False))
            outs = [dec(fr, config, stereo) for fr in frames if fr]
            pcm = np.concatenate(outs, axis=1) if outs else None
            if pcm is None or pcm.shape[1] == 0:
                return []
            f = Frame.audio(pcm.astype(np.float32),
                            self.sample_rate, "fltp", pts=pkt.pts,
                            time_base=pkt.time_base
                            or Rational(1, self.sample_rate))
            return [f]
        duration = int(T.FRAME_DURATION[config])
        bandwidth = (config - 16) >> 2
        if bandwidth:
            bandwidth += 1                # CELT skips mediumband
        end_band = int(T.BAND_END[bandwidth])
        outs = [] if pre is None or not len(pre[0]) else             [np.stack(pre)]
        for fr in frames:
            if not fr:
                continue
            rc = RangeCoder(fr)
            out = self.celt.decode(rc, stereo + 1, duration, 0,
                                   end_band)
            outs.append(out)
        if not outs:
            return []
        pcm = np.concatenate(outs, axis=1)
        if self._to_skip:
            n = min(self._to_skip, pcm.shape[1])
            pcm = pcm[:, n:]
            self._to_skip -= n
            if pcm.shape[1] == 0:
                return []
        f = Frame.audio(pcm.astype(np.float32), self.sample_rate,
                        "fltp", pts=pkt.pts,
                        time_base=pkt.time_base
                        or Rational(1, self.sample_rate))
        return [f]

    def flush_state(self):
        self.celt = CeltDecoder(self.channels, self.device)
        self.silk = None
        self.silk_resampler = None
        self._silk_delayed = 0
        self._celt_fifo = None
        self._last_mode = None
        self._to_skip = self.pre_skip
