"""fftpu — the transcoder CLI (analog of fftools/ffmpeg.c).

Option surface mirrors ffmpeg: options before -i bind to that input,
options between inputs' end and an output URL bind to that output
(per-stream :v/:a suffixes supported for the common ones). The run loop
is the host pipeline: demux → decode → filtergraph → encode → mux with
DTS interleaving.

The port's copy of ffmpeg_tpu/cli/ffmpeg.py, held equal to it by
tests/test_torch_cli.py.  `main(argv, device)` and `transcode(o, device)`
run every decoder, filter graph and encoder on one device, the card
unless the caller names another (the tests pass "cpu"); the command line
has no option for it, as the reference's has none.  Video planes stay on
that device from the decoder to the encoder: the only device-to-host
copies of a video frame are the rawvideo encoder's and those an encoder
makes itself.  The errors caught are the reference's (FFTPUError,
TryAgain, EndOfStream): a fault of the card or of a kernel's build is no
FFTPUError, so it ends the run with its traceback.  Bitstream filters
(-bsf) are host code on the packets (codecs/bsf.py).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from ..codecs import CodecContext, decoder_names, encoder_names
from ..core.frame import Frame
from ..core.packet import Packet
from ..filters import parse_graph, filter_names
from ..io import open_input, open_output, demuxer_names, muxer_names
from ..io.stream import CodecParameters, MediaType
from ..utils import log as _log
from ..utils.error import (EndOfStream, FFTPUError, InvalidData,
                           NotSupported, TryAgain)
from ..utils.rational import NOPTS, Rational, rescale_q
from ..utils.options import _parse_duration, _parse_video_size


@dataclass
class InputSpec:
    url: str = ""
    format: Optional[str] = None
    options: Dict[str, str] = field(default_factory=dict)
    seek: Optional[int] = None          # -ss (us)
    duration: Optional[int] = None      # -t (us)


@dataclass
class OutputSpec:
    url: str = ""
    format: Optional[str] = None
    vcodec: Optional[str] = None
    acodec: Optional[str] = None
    vf: Optional[str] = None
    af: Optional[str] = None
    vbsf: Optional[str] = None
    absf: Optional[str] = None
    pix_fmt: Optional[str] = None
    size: Optional[tuple] = None
    framerate: Optional[str] = None
    sample_rate: Optional[int] = None
    channels: Optional[int] = None
    sample_fmt: Optional[str] = None
    max_vframes: Optional[int] = None
    no_video: bool = False
    no_audio: bool = False
    maps: List[str] = field(default_factory=list)
    quality: Optional[float] = None
    options: Dict[str, str] = field(default_factory=dict)
    seek: Optional[int] = None
    duration: Optional[int] = None
    shortest: bool = False


@dataclass
class CliOptions:
    inputs: List[InputSpec] = field(default_factory=list)
    outputs: List[OutputSpec] = field(default_factory=list)
    overwrite: bool = False
    loglevel: Optional[str] = None
    benchmark: bool = False
    bitexact: bool = False
    progress_url: Optional[str] = None
    print_graphs_file: Optional[str] = None
    filter_complex: List[str] = field(default_factory=list)


def parse_args(argv: List[str]) -> CliOptions:
    o = CliOptions()
    cur_in = InputSpec()
    cur_out = OutputSpec()
    i = 0

    def take():
        nonlocal i
        i += 1
        if i >= len(argv):
            raise InvalidData(f"option {argv[i-1]} needs an argument")
        return argv[i]

    while i < len(argv):
        a = argv[i]
        if a == "-i":
            cur_in.url = take()
            o.inputs.append(cur_in)
            cur_in = InputSpec()
        elif a == "-f":
            v = take()
            if o.inputs and not cur_in.url and _is_output_pending(cur_in):
                cur_out.format = v
            elif not o.inputs or _before_input(cur_in):
                cur_in.format = v
                cur_out.format = v   # also remember for a following output
            else:
                cur_out.format = v
        elif a in ("-c:v", "-vcodec", "-codec:v"):
            cur_out.vcodec = take()
        elif a in ("-c:a", "-acodec", "-codec:a"):
            cur_out.acodec = take()
        elif a in ("-c", "-codec"):
            v = take()
            cur_out.vcodec = cur_out.acodec = v
        elif a in ("-filter_complex", "-lavfi"):
            o.filter_complex.append(take())
        elif a in ("-vf", "-filter:v"):
            cur_out.vf = take()
        elif a in ("-af", "-filter:a"):
            cur_out.af = take()
        elif a in ("-bsf:v", "-vbsf"):
            cur_out.vbsf = take()
        elif a in ("-bsf:a", "-absf"):
            cur_out.absf = take()
        elif a == "-bsf":
            v = take()
            cur_out.vbsf = cur_out.absf = v
        elif a == "-pix_fmt":
            cur_out.pix_fmt = take()
        elif a in ("-s", "-video_size", "-s:v"):
            v = _parse_video_size(take())
            if not o.inputs:
                cur_in.options["video_size"] = v
            else:
                cur_out.size = v
        elif a in ("-r", "-framerate"):
            v = take()
            if not o.inputs:
                cur_in.options["framerate"] = _parse_rate(v)
            else:
                cur_out.framerate = v
        elif a == "-ar":
            v = int(take())
            if not o.inputs:
                cur_in.options["sample_rate"] = v
            else:
                cur_out.sample_rate = v
        elif a == "-ac":
            v = int(take())
            if not o.inputs:
                cur_in.options["channels"] = v
            else:
                cur_out.channels = v
        elif a == "-sample_fmt":
            cur_out.sample_fmt = take()
        elif a == "-pixel_format":
            cur_in.options["pixel_format"] = take()
        elif a in ("-frames:v", "-vframes", "-frames"):
            cur_out.max_vframes = int(take())
        elif a == "-shortest":
            cur_out.shortest = True
        elif a == "-ss":
            v = _parse_duration(take())
            if not o.inputs:
                cur_in.seek = v
            else:
                cur_out.seek = v
        elif a == "-t":
            v = _parse_duration(take())
            if not o.inputs:
                cur_in.duration = v
            else:
                cur_out.duration = v
        elif a == "-an":
            cur_out.no_audio = True
        elif a == "-vn":
            cur_out.no_video = True
        elif a == "-map":
            cur_out.maps.append(take())
        elif a in ("-q:v", "-qscale:v", "-q"):
            cur_out.quality = float(take())
        elif a == "-y":
            o.overwrite = True
        elif a in ("-v", "-loglevel"):
            o.loglevel = take()
        elif a == "-benchmark":
            o.benchmark = True
        elif a == "-progress":
            o.progress_url = take()
        elif a == "-print_graphs_file":
            o.print_graphs_file = take()
        elif a == "-fflags":
            v = take()
            if "bitexact" in v:
                o.bitexact = True
        elif a in ("-hide_banner", "-nostdin", "-stats", "-nostats"):
            pass
        elif a.startswith("-") and len(a) > 1:
            # unknown option with value — store for codec/muxer
            cur_out.options[a[1:]] = take()
        else:
            cur_out.url = a
            o.outputs.append(cur_out)
            cur_out = OutputSpec(format=None)
        i += 1
    return o


def _parse_rate(v):
    if "/" in v:
        n, d = v.split("/")
        return Rational(int(n), int(d))
    return Rational.from_float(float(v))


def _before_input(spec: InputSpec) -> bool:
    return not spec.url


def _is_output_pending(spec) -> bool:
    return False


# ---------------------------------------------------------------------------

def _build_bsf_chain(spec: str, par) -> list:
    """Parse ffmpeg -bsf syntax 'name=opt=val:opt2=val,name2' into filter
    instances (fftools/ffmpeg_mux_init.c bsf setup analog)."""
    from ..codecs.bsf import get_bsf
    chain = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, argstr = part.partition("=")
        opts = {}
        if argstr:
            for kv in argstr.split(":"):
                k, _, v = kv.partition("=")
                try:
                    opts[k] = int(v)
                except ValueError:
                    opts[k] = v
        chain.append(get_bsf(name, par, **opts))
    return chain


def _apply_bsfs(ch, pkt: Packet, mux) -> None:
    if "bsfs" not in ch:
        spec = ch.get("bsf_spec")
        ch["bsfs"] = _build_bsf_chain(spec, ch["out_st"].codecpar) \
            if spec else []
    pkts = [pkt]
    for f in ch.get("bsfs") or ():
        nxt = []
        for p in pkts:
            nxt.extend(f.filter(p))
        pkts = nxt
    sq = ch.get("sq")
    for p in pkts:
        if sq is not None:
            for _, rp in sq.send(ch["sq_idx"], p):
                mux.write_packet(rp)
        else:
            mux.write_packet(p)


_VENC_DEFAULT = {"yuv4mpegpipe": "rawvideo", "rawvideo": "rawvideo",
                 "framecrc": "rawvideo", "framemd5": "rawvideo",
                 "md5": "rawvideo", "crc": "rawvideo", "null": "rawvideo",
                 "mjpeg": "mjpeg", "image2": "mjpeg", "avi": "mjpeg",
                 "gif": "gif"}
def _default_vcodec(fmt_name, mux):
    """ffmpeg guesses image2 codecs from the output extension
    (ff_guess_image2_codec analog)."""
    if fmt_name == "image2" and getattr(mux, "url", None):
        from ..io.formats.img_mjpeg import Image2Demuxer
        url = str(mux.url)
        if "." in url:
            ext = url.rsplit(".", 1)[-1].lower()
            c = Image2Demuxer._CODEC_BY_EXT.get(ext)
            if c:
                return c
    return _VENC_DEFAULT.get(fmt_name,
                             getattr(mux, "default_video_codec", None)
                             or "rawvideo")


_AENC_DEFAULT = {"wav": "pcm_s16le", "s16le": "pcm_s16le",
                 "adts": "aac",
                 "f32le": "pcm_f32le", "framecrc": "pcm_s16le",
                 "framemd5": "pcm_s16le", "md5": "pcm_s16le",
                 "crc": "pcm_s16le", "null": "pcm_s16le"}


def _select_streams(demux, out) -> list:
    """Resolve -map specs (or the default best-video+best-audio pick,
    av_find_best_stream style) to input streams for one output."""
    if out.maps:
        sel = []
        for m in out.maps:
            parts = m.split(":")
            if parts[0] != "0":
                raise NotSupported("cli: only single-input -map (0:...)")
            if len(parts) == 1:
                sel.extend(demux.streams)
                continue
            if parts[1] in ("v", "a", "s"):
                typ = {"v": MediaType.VIDEO, "a": MediaType.AUDIO,
                       "s": MediaType.SUBTITLE}[parts[1]]
                typed = [s for s in demux.streams if s.codec_type == typ]
                if len(parts) == 3:
                    sel.append(typed[int(parts[2])])
                else:
                    sel.extend(typed)
            else:
                sel.append(demux.streams[int(parts[1])])
        return sel
    sel = []
    v = next((s for s in demux.streams
              if s.codec_type == MediaType.VIDEO), None)
    a = next((s for s in demux.streams
              if s.codec_type == MediaType.AUDIO), None)
    if v is not None and not out.no_video:
        sel.append(v)
    if a is not None and not out.no_audio:
        sel.append(a)
    return sel


def _video_extra_graph(out) -> str:
    graph_txt = out.vf or "null"
    extra = []
    if out.size:
        extra.append(f"scale={out.size[0]}:{out.size[1]}")
    if out.pix_fmt:
        extra.append(f"format={out.pix_fmt}")
    if out.framerate:
        extra.append(f"fps={out.framerate}")
    if extra:
        graph_txt = graph_txt + "," + ",".join(extra) \
            if graph_txt != "null" else ",".join(extra)
    return graph_txt


def _audio_extra_graph(out, fmt_name):
    graph_txt = out.af or "anull"
    want_fmt = out.sample_fmt
    acodec = out.acodec or _AENC_DEFAULT.get(fmt_name, "pcm_s16le")
    if acodec.startswith("pcm_"):
        want_fmt = {"pcm_s16le": "s16", "pcm_s16be": "s16",
                    "pcm_f32le": "flt", "pcm_u8": "u8",
                    "pcm_s32le": "s32"}.get(acodec, want_fmt)
    af_parts = []
    if want_fmt or out.sample_rate or out.channels:
        parts = []
        if want_fmt:
            parts.append(f"sample_fmts={want_fmt}")
        if out.sample_rate:
            parts.append(f"sample_rates={out.sample_rate}")
        if out.channels:
            layouts = {1: "mono", 2: "stereo", 6: "5.1"}
            parts.append("channel_layouts="
                         f"{layouts.get(out.channels, out.channels)}")
        af_parts.append("aformat=" + ":".join(parts))
    if af_parts:
        graph_txt = (graph_txt + "," if graph_txt != "anull" else "") \
            + ",".join(af_parts)
    return graph_txt, acodec


def _build_fc_chain(label, media_type, out, mux, device) -> dict:
    """Chain fed by a -filter_complex graph output label; its graph on
    `device`."""
    from ..io.stream import CodecParameters
    fmt_name = mux.name
    is_video = media_type == MediaType.VIDEO
    ch: dict = {"type": "video" if is_video else "audio",
                "in_st": None, "fc_label": label, "out": out,
                "mux": mux, "count": 0, "done": False, "copy": False,
                "enc": None, "opts": {}}
    if is_video:
        ch["graph"] = parse_graph(_video_extra_graph(out), device=device)
        ch["enc_name"] = out.vcodec or _default_vcodec(fmt_name, mux)
        if out.quality is not None:
            ch["opts"]["quality"] = int(max(2, min(97,
                                                   100 - out.quality * 3)))
    else:
        graph_txt, acodec = _audio_extra_graph(out, fmt_name)
        ch["graph"] = parse_graph(graph_txt, device=device)
        ch["enc_name"] = acodec
    par = CodecParameters(codec_type=media_type,
                          codec_id=ch["enc_name"])
    ch["out_st"] = mux.add_stream(par, time_base=None)
    ch["bsf_spec"] = (out.vbsf if is_video else out.absf)
    return ch


def _resolve_fc_input(demux, label):
    """'0:v', '0:a:1', '0:2' (single input file) → stream."""
    parts = label.split(":")
    if parts and parts[0] == "0":
        parts = parts[1:]
    if not parts:
        raise InvalidData(f"bad filter_complex input [{label}]")
    if parts[0] in ("v", "a"):
        typ = MediaType.VIDEO if parts[0] == "v" else MediaType.AUDIO
        typed = [s for s in demux.streams if s.codec_type == typ]
        idx = int(parts[1]) if len(parts) > 1 else 0
        if idx >= len(typed):
            raise InvalidData(f"no stream for [{label}]")
        return typed[idx]
    return demux.streams[int(parts[0])]


def _build_chain(st, out, mux, device) -> dict:
    """One input-stream → output-stream chain for one output file; its
    graph on `device`."""
    fmt_name = mux.name
    is_video = st.codec_type == MediaType.VIDEO
    ch: dict = {"type": "video" if is_video else "audio", "in_st": st,
                "out": out, "mux": mux, "count": 0, "done": False}
    codec_opt = out.vcodec if is_video else out.acodec
    if codec_opt == "copy":
        ch["copy"] = True
        ost = mux.add_stream(st.codecpar, time_base=st.time_base)
    elif is_video:
        ch["copy"] = False
        ch["graph"] = parse_graph(_video_extra_graph(out), device=device)
        ch["enc_name"] = out.vcodec or _default_vcodec(fmt_name, mux)
        ch["enc"] = None             # opened lazily on first frame
        ch["opts"] = {}
        if out.quality is not None:
            # map ffmpeg qscale (2..31) to JPEG quality approx
            ch["opts"]["quality"] = int(max(2, min(97,
                                                   100 - out.quality * 3)))
        ost = mux.add_stream(st.codecpar.copy(), time_base=st.time_base)
    else:
        ch["copy"] = False
        graph_txt, acodec = _audio_extra_graph(out, fmt_name)
        ch["graph"] = parse_graph(graph_txt, device=device)
        ch["enc_name"] = acodec
        ch["enc"] = None
        ch["opts"] = {}
        ost = mux.add_stream(st.codecpar.copy(), time_base=st.time_base)
    ch["out_st"] = ost
    ch["bsf_spec"] = (out.vbsf if is_video else out.absf)
    return ch


def transcode(o: CliOptions, device: torch.device | str = "cuda") -> None:
    """Run the parsed command line: every decoder, filter graph and
    encoder on `device`."""
    if not o.inputs or not o.outputs:
        raise InvalidData("need at least one input (-i) and one output")
    inp = o.inputs[0]
    out = o.outputs[0]
    demux = open_input(inp.url, format=inp.format, **inp.options)

    # -filter_complex graphs: bind input labels to streams, collect
    # output labels with their media types
    fc_in: List[tuple] = []            # (label, graph, stream idx) —
    # a list, not a dict: several graphs may legally consume the same
    # input label (e.g. two -filter_complex both reading [0:v])
    fc_out: Dict[str, tuple] = {}      # label → (graph, media type)
    fc_graphs = []
    for txt in o.filter_complex:
        g = parse_graph(txt, device=device)
        fc_graphs.append(g)
        for lbl in g.inputs:
            st = _resolve_fc_input(demux, lbl)
            fc_in.append((lbl, g, st.index))
        for lbl, node in g.outputs.items():
            fc_out[lbl] = (g, node.filter.media_type)

    # per-output muxers + chains; decoders shared per input stream
    muxes = []
    chains: List[dict] = []
    decoders: Dict[int, CodecContext] = {}
    for ospec in o.outputs:
        mux = open_output(ospec.url, format=ospec.format)
        muxes.append(mux)
        lbl_maps = [m[1:-1] for m in ospec.maps
                    if m.startswith("[") and m.endswith("]")]
        ospec.maps = [m for m in ospec.maps if not m.startswith("[")]
        if not lbl_maps and not ospec.maps and fc_out:
            lbl_maps = list(fc_out)      # implicit mapping of fc outputs
        for lbl in lbl_maps:
            if lbl not in fc_out:
                raise InvalidData(f"unknown filter_complex output "
                                  f"[{lbl}]")
            g, mt = fc_out[lbl]
            ch = _build_fc_chain(lbl, mt, ospec, mux, device)
            ch["fc_graph"] = g
            chains.append(ch)
        if lbl_maps and not ospec.maps:
            continue
        for st in _select_streams(demux, ospec):
            if st.codec_type not in (MediaType.VIDEO, MediaType.AUDIO):
                vc = ospec.vcodec
                if vc != "copy":
                    continue
            ch = _build_chain(st, ospec, mux, device)
            if not ch["copy"] and st.index not in decoders:
                decoders[st.index] = CodecContext.open_decoder(
                    st.codecpar, device=device)
            chains.append(ch)
    for lbl, g, sidx in fc_in:
        if sidx not in decoders:
            decoders[sidx] = CodecContext.open_decoder(
                demux.streams[sidx].codecpar, device=device)

    for ch in chains:
        ch["out_idx"] = ch["out_st"].index

    # -shortest: one sync queue per output; every stream is limiting,
    # so the whole output stops at the earliest-ending stream
    # (fftools/sync_queue.c semantics; see cli/sync_queue.py)
    from .sync_queue import SyncQueue
    sqs = []
    _sq_by_mux = {}
    for ch in chains:
        if getattr(ch["out"], "shortest", False):
            mux = ch["mux"]
            if id(mux) not in _sq_by_mux:
                _sq_by_mux[id(mux)] = SyncQueue()
                sqs.append((_sq_by_mux[id(mux)], mux))
            sq = _sq_by_mux[id(mux)]
            ch["sq"] = sq
            ch["sq_idx"] = sq.add_stream(ch["out_st"].time_base)

    if o.print_graphs_file:
        _print_graphs(o.print_graphs_file, demux, chains, muxes)

    start_us = inp.seek or 0
    if start_us and demux.streams and chains:
        # fast seek to the preceding keyframe; the timestamp filter below
        # discards frames before the exact target (ffmpeg -ss semantics)
        st0 = chains[0]["in_st"]
        try:
            demux.seek(st0.index,
                       start_us * st0.time_base.den
                       // (1000000 * st0.time_base.num))
        except FFTPUError:
            pass                   # demuxer without seek: decode+discard

    def ch_limit_us(ch):
        if inp.duration is not None:
            return inp.duration
        return ch["out"].duration

    def open_encoder(ch, frame: Frame):
        par = ch["out_st"].codecpar
        if ch["type"] == "video":
            par.width = frame.width
            par.height = frame.height
            par.pix_fmt = frame.format
            par.codec_id = ch["enc_name"]
            rate = None
            if frame.time_base:
                rate = frame.time_base.inv()
            par.framerate = rate or Rational(25, 1)
            ch["out_st"].time_base = frame.time_base or Rational(1, 25)
        else:
            par.sample_rate = frame.sample_rate
            par.sample_fmt = frame.format
            par.ch_layout = frame.ch_layout
            par.codec_id = ch["enc_name"]
            ch["out_st"].time_base = Rational(1, frame.sample_rate)
        ch["enc"] = CodecContext.open_encoder(par, options=ch["opts"],
                                              device=device)

    def emit_frame(ch, frame: Optional[Frame]):
        if frame is not None and ch["enc"] is None:
            open_encoder(ch, frame)
        if ch["enc"] is None:
            return
        max_v = ch["out"].max_vframes
        if frame is not None and ch["type"] == "video":
            if max_v is not None and ch["count"] >= max_v:
                ch["done"] = True
                return
            ch["count"] += 1
        ch["enc"].send_frame(frame)
        while True:
            try:
                pkt = ch["enc"].receive_packet()
            except (TryAgain, EndOfStream):
                break
            pkt.stream_index = ch["out_idx"]
            if pkt.time_base and ch["out_st"].time_base and \
                    pkt.time_base != ch["out_st"].time_base and pkt.pts != NOPTS:
                pkt.pts = rescale_q(pkt.pts, pkt.time_base, ch["out_st"].time_base)
                pkt.dts = pkt.pts
                pkt.time_base = ch["out_st"].time_base
            _apply_bsfs(ch, pkt, ch["mux"])

    def run_frames(ch, frames):
        for f in frames:
            ch["graph"].feed(f)
            for of in ch["graph"].pull():
                emit_frame(ch, of)

    def drain_fc_chains():
        for ch in chains:
            if "fc_label" in ch:
                run_frames(ch, ch["fc_graph"].pull(ch["fc_label"]))

    # ---- main loop ------------------------------------------------------------
    progress_fh = None
    if o.progress_url:
        progress_fh = sys.stderr if o.progress_url in ("-", "pipe:1",
                                                       "pipe:2") \
            else open(o.progress_url, "w")
    npkts = 0

    def write_progress(status):
        if progress_fh is None:
            return
        vframes = max((c["count"] for c in chains
                       if c["type"] == "video"), default=0)
        progress_fh.write(f"frame={vframes}\n")
        progress_fh.write(f"progress={status}\n")
        progress_fh.flush()

    try:
        for pkt in demux.packets():
            npkts += 1
            if npkts % 50 == 0:
                write_progress("continue")
            targets = [c for c in chains
                       if c["in_st"] is not None
                       and c["in_st"].index == pkt.stream_index]
            fc_feeds = [(lbl, g) for lbl, g, sidx in fc_in
                        if sidx == pkt.stream_index]
            if not targets and not fc_feeds:
                continue
            # decode once per input stream, fan out to all chains
            frames = None
            for ch in targets:
                # -ss / -t on input timestamps
                if pkt.pts != NOPTS and pkt.time_base:
                    t_us = pkt.pts * 1000000 * pkt.time_base.num \
                        // pkt.time_base.den
                    if inp.seek is not None and t_us < start_us:
                        continue
                    lim = ch_limit_us(ch)
                    if lim is not None and t_us >= start_us + lim:
                        if ch["type"] == "video":
                            ch["done"] = True
                        continue
                if ch["copy"]:
                    outpkt = Packet(data=pkt.data, pts=pkt.pts,
                                    dts=pkt.dts, duration=pkt.duration,
                                    flags=pkt.flags,
                                    stream_index=ch["out_idx"],
                                    time_base=pkt.time_base)
                    _apply_bsfs(ch, outpkt, ch["mux"])
                    if ch["type"] == "video":
                        ch["count"] += 1
                        max_v = ch["out"].max_vframes
                        if max_v is not None and ch["count"] >= max_v:
                            ch["done"] = True
                else:
                    if frames is None:
                        dec = decoders[pkt.stream_index]
                        dec.send_packet(pkt)
                        frames = []
                        while True:
                            try:
                                frames.append(dec.receive_frame())
                            except (TryAgain, EndOfStream):
                                break
                    run_frames(ch, frames)
            if fc_feeds:
                if frames is None:
                    dec = decoders[pkt.stream_index]
                    dec.send_packet(pkt)
                    frames = []
                    while True:
                        try:
                            frames.append(dec.receive_frame())
                        except (TryAgain, EndOfStream):
                            break
                for lbl, g in fc_feeds:
                    for f in frames:
                        g.feed(f, lbl)
                drain_fc_chains()
            # stop early once every chain hit its frame/time limit
            # (chains without limits run to EOF)
            if chains and all(c["done"] for c in chains):
                break
        # drain: flush each shared decoder ONCE, then fan its tail
        # frames out to both the fc graph inputs and the directly-mapped
        # chains (a stream may feed both; B-frame reorder tails must
        # reach every consumer)
        tails: Dict[int, list] = {}

        def drain_decoder(idx):
            if idx not in tails:
                frames = []
                if idx in decoders:
                    dec = decoders[idx]
                    dec.send_packet(None)
                    while True:
                        try:
                            frames.append(dec.receive_frame())
                        except (EndOfStream, TryAgain):
                            break
                tails[idx] = frames
            return tails[idx]

        for lbl, g, sidx in fc_in:
            for f in drain_decoder(sidx):
                g.feed(f, lbl)
            g.feed_eof(lbl)
        drain_fc_chains()
        for ch in chains:
            if "fc_label" in ch:
                ch["graph"].feed_eof()
                for of in ch["graph"].pull():
                    emit_frame(ch, of)
                emit_frame(ch, None)
        for ch in chains:
            if ch["copy"] or ch["in_st"] is None:
                continue
            run_frames(ch, drain_decoder(ch["in_st"].index))
            ch["graph"].feed_eof()
            for of in ch["graph"].pull():
                emit_frame(ch, of)
            emit_frame(ch, None)   # encoder drain
        for sq, mux in sqs:
            for _, rp in sq.finish_all():
                mux.write_packet(rp)
        for mux in muxes:
            mux.write_trailer()
        write_progress("end")
    finally:
        for mux in muxes:
            mux.close()
        demux.close()


def _print_graphs(path: str, demux, chains, muxes) -> None:
    """Dump the runtime pipeline graph (fftools/graph/graphprint.c
    analog): inputs, per-stream chains (decoder/filtergraph/encoder or
    copy), outputs — as JSON."""
    import json
    g = {"inputs": [{
        "url": demux.url, "format": demux.name,
        "streams": [{"index": st.index,
                     "codec": st.codecpar.codec_id,
                     "type": str(st.codecpar.codec_type)}
                    for st in demux.streams]}],
        "chains": [], "outputs": []}
    for ch in chains:
        g["chains"].append({
            "input_stream": ch["in_st"].index,
            "mode": "copy" if ch["copy"] else "transcode",
            "filtergraph": None if ch["copy"]
            else getattr(ch.get("graph"), "description",
                         ch["out"].vf or ch["out"].af or "null"),
            "encoder": None if ch["copy"] else ch.get("enc_name"),
            "bsf": ch.get("bsf_spec"),
            "output_url": ch["mux"].url,
            "output_stream": ch["out_idx"]})
    for m in muxes:
        g["outputs"].append({"url": m.url, "format": m.name,
                             "streams": len(m.streams)})
    with open(path, "w") as f:
        json.dump(g, f, indent=2)


def _init_report(argv) -> Optional[object]:
    """FFREPORT env-var report file (fftools/cmdutils.c:516 analog):
    FFREPORT=file=<path>[:level=<lvl>] logs the command line and every
    log message to the file."""
    import os
    spec = os.environ.get("FFREPORT")
    if not spec:
        return None
    fname = None
    level = None
    if spec not in ("1", "true", "yes"):
        for part in spec.split(":"):
            k, _, v = part.partition("=")
            if k == "file":
                fname = v
            elif k == "level":
                level = v
    _log.enable_report(fname)
    _log.log(None, _log.LogLevel.INFO,
             "fftpu command line: " + " ".join(argv))
    if level:
        _log.set_level(level)
    return fname


def main(argv: Optional[List[str]] = None,
         device: torch.device | str = "cuda") -> int:
    """The fftpu-torch command: transcode on `device`, the card unless
    the caller names another."""
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: fftpu-torch [options] -i input [options] output")
        print("  (PyTorch/CUDA transcoder; ffmpeg-compatible core options)")
        print(f"demuxers: {', '.join(demuxer_names())}")
        print(f"muxers: {', '.join(muxer_names())}")
        print(f"decoders: {', '.join(decoder_names())}")
        print(f"encoders: {', '.join(encoder_names())}")
        print(f"filters: {', '.join(filter_names())}")
        return 0
    _init_report(argv)
    try:
        o = parse_args(argv)
        if o.loglevel:
            _log.set_level(o.loglevel)
        import time
        t0 = time.monotonic()
        transcode(o, device)
        if o.benchmark:
            dt = time.monotonic() - t0
            sys.stderr.write(f"bench: rtime={dt:.3f}s\n")
        return 0
    except FFTPUError as e:
        sys.stderr.write(f"fftpu: error: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
