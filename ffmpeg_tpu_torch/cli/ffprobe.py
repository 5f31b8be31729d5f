"""fftpu-probe — media inspector (analog of fftools/ffprobe.c) with the
pluggable textformat writers (default/json/csv/flat/ini/compact).

The port's copy of ffmpeg_tpu/cli/ffprobe.py, held equal to it by
tests/test_torch_cli.py.  `main(argv, device)` opens the -show_frames
decoders on `device`, the card unless the caller names another.
"""

from __future__ import annotations

import sys
from typing import List, Optional

import torch

from ..io import open_input
from ..io.stream import MediaType
from ..utils.error import FFTPUError
from ..utils.rational import NOPTS
from .textformat import get_writer


def _stream_dict(st) -> dict:
    p = st.codecpar
    d = {
        "index": st.index,
        "codec_name": p.codec_id,
        "codec_type": p.codec_type,
    }
    if p.codec_type == MediaType.VIDEO:
        d.update(width=p.width, height=p.height,
                 pix_fmt=p.pix_fmt or "unknown",
                 sample_aspect_ratio=f"{p.sample_aspect_ratio.num}:{p.sample_aspect_ratio.den}",
                 avg_frame_rate=f"{st.avg_frame_rate.num}/{st.avg_frame_rate.den}")
    elif p.codec_type == MediaType.AUDIO:
        d.update(sample_rate=p.sample_rate, channels=p.channels,
                 channel_layout=p.ch_layout.describe() if p.ch_layout else "unknown")
    d["time_base"] = f"{st.time_base.num}/{st.time_base.den}"
    if st.duration != NOPTS:
        d["duration_ts"] = st.duration
        if st.time_base.den:
            d["duration"] = f"{st.duration * st.time_base.num / st.time_base.den:.6f}"
    if st.nb_frames:
        d["nb_frames"] = st.nb_frames
    return d


def _packet_dict(pkt, st) -> dict:
    tb = st.time_base
    d = {
        "codec_type": st.codecpar.codec_type,
        "stream_index": pkt.stream_index,
        "pts": pkt.pts if pkt.pts != NOPTS else "N/A",
        "dts": pkt.dts if pkt.dts != NOPTS else "N/A",
        "duration": pkt.duration,
        "size": len(pkt.data),
        "pos": pkt.pos,
        "flags": ("K" if pkt.is_keyframe else "_") + "_",
    }
    if pkt.pts != NOPTS and tb.den:
        d["pts_time"] = f"{pkt.pts * tb.num / tb.den:.6f}"
    return d


def _frame_dict(fr, st) -> dict:
    tb = fr.time_base or st.time_base
    d = {
        "media_type": st.codecpar.codec_type,
        "stream_index": fr.stream_index
        if getattr(fr, "stream_index", None) is not None else st.index,
        "key_frame": 1 if getattr(fr, "key_frame", False) else 0,
        "pts": fr.pts if fr.pts != NOPTS else "N/A",
    }
    if fr.pts != NOPTS and tb and tb.den:
        d["pts_time"] = f"{fr.pts * tb.num / tb.den:.6f}"
    if st.codecpar.codec_type == MediaType.VIDEO:
        d.update(width=fr.width, height=fr.height, pix_fmt=fr.format)
        pt = getattr(fr, "pict_type", None)
        if pt and pt != "?":
            d["pict_type"] = pt
    else:
        d.update(sample_fmt=fr.format, nb_samples=fr.nb_samples,
                 channels=fr.channels)
    return d


def _pump(dec, pkt):
    from ..utils.error import EndOfStream, TryAgain
    dec.send_packet(pkt)
    out = []
    while True:
        try:
            out.append(dec.receive_frame())
        except (TryAgain, EndOfStream):
            break
    return out


def main(argv: Optional[List[str]] = None,
         device: torch.device | str = "cuda") -> int:
    argv = argv if argv is not None else sys.argv[1:]
    url = None
    fmt = None
    writer = "default"
    show_streams = show_format = show_packets = False
    show_frames = show_chapters = False
    select = None
    input_format = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-show_streams":
            show_streams = True
        elif a == "-show_format":
            show_format = True
        elif a == "-show_packets":
            show_packets = True
        elif a == "-show_frames":
            show_frames = True
        elif a == "-show_chapters":
            show_chapters = True
        elif a == "-select_streams":
            i += 1
            select = argv[i]
        elif a in ("-of", "-print_format", "-output_format"):
            i += 1
            writer = argv[i]
        elif a == "-f":
            i += 1
            input_format = argv[i]
        elif a in ("-v", "-loglevel"):
            i += 1
        elif a in ("-hide_banner",):
            pass
        elif a == "-i":
            i += 1
            url = argv[i]
        elif not a.startswith("-"):
            url = a
        i += 1
    if url is None:
        sys.stderr.write("usage: fftpu-probe [-show_streams|-show_format|"
                         "-show_packets|-show_frames|-show_chapters] "
                         "[-select_streams spec] "
                         "[-of json|csv|flat|ini|compact] input\n")
        return 1
    if not (show_streams or show_format or show_packets
            or show_frames or show_chapters):
        show_streams = show_format = True

    def selected(st):
        if select is None:
            return True
        if select.isdigit():
            return st.index == int(select)
        kind = {"v": MediaType.VIDEO, "a": MediaType.AUDIO,
                "s": MediaType.SUBTITLE}.get(select[0])
        if st.codecpar.codec_type != kind:
            return False
        if len(select) > 2 and select[1] == ":":
            same = [s for s in d.streams
                    if s.codecpar.codec_type == kind]
            return same.index(st) == int(select[2:])
        return True
    try:
        d = open_input(url, format=input_format)
        sections = []
        if show_packets or show_frames:
            decoders = {}
            if show_frames:
                from ..codecs import CodecContext
                for st in d.streams:
                    if selected(st):
                        try:
                            decoders[st.index] = \
                                CodecContext.open_decoder(st.codecpar,
                                                          device=device)
                        except FFTPUError:
                            pass
            for pkt in d.packets():
                st = d.streams[pkt.stream_index]
                if not selected(st):
                    continue
                if show_packets:
                    sections.append(("packet", _packet_dict(pkt, st)))
                dec = decoders.get(pkt.stream_index)
                if dec is not None:
                    for fr in _pump(dec, pkt):
                        sections.append(("frame", _frame_dict(fr, st)))
            for idx, dec in decoders.items():
                for fr in _pump(dec, None):
                    sections.append(
                        ("frame", _frame_dict(fr, d.streams[idx])))
        if show_streams:
            for st in d.streams:
                if selected(st):
                    sections.append(("stream", _stream_dict(st)))
        if show_chapters:
            for i, (cid, start, end, md) in enumerate(
                    getattr(d, "chapters", ())):
                cd = {"id": i, "time_base": "1/1000",
                      "start": start, "start_time": f"{start / 1000:.6f}",
                      "end": end, "end_time": f"{end / 1000:.6f}"}
                for k, v in md.items():
                    cd[f"tag:{k}"] = v
                sections.append(("chapter", cd))
        if show_format:
            fmt_d = {
                "filename": url,
                "nb_streams": len(d.streams),
                "format_name": d.name,
            }
            for k, v in d.metadata.items():
                fmt_d[f"tag:{k}"] = v
            if d.duration != NOPTS:
                fmt_d["duration"] = f"{d.duration / 1e6:.6f}"
            sections.append(("format", fmt_d))
        sys.stdout.write(get_writer(writer).render(sections))
        return 0
    except FFTPUError as e:
        sys.stderr.write(f"fftpu-probe: error: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
