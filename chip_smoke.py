#!/usr/bin/env python3
"""Smoke run of the PyTorch port (ffmpeg_tpu_torch) on one NVIDIA GPU.

Drives the port's paths through their user entry points at full size:

- the flagship, 1080p MJPEG decoded and scaled to 224x224 rgb24
  (MjpegTpuEntropyPipeline: prep_frame, run_batch) on the committed
  8-frame 1920x1080 fixture, batch 8, bicubic;
- the MPEG-2 encoder (CodecContext.open_encoder, send_frame,
  receive_packet) on a 1920x1080 clip made from a seed, I P P P at
  fixed qscale, motion search by K2 on every P frame;
- the host-entropy decode->scale function (build_decode_scale, entry()),
  the MJPEG decoder (CodecContext.open_decoder) into a parsed filter
  graph, and the dataloader's batched graph, on the same fixture and on
  benchrows.py's seeded clips;
- the audio frontend: the committed 20.03 s ADTS clip (48 kHz stereo
  AAC-LC) through the ADTS demuxer, CodecContext.open_decoder(...)
  .decode_frames and SwrContext(48000 stereo -> 16000 mono fltp), and
  the graph "aresample=16000,aformat=channel_layouts=mono";
- the VP9 decoder: the first 10 frames of the committed 100-frame
  1920x1080 stream through CodecContext.open_decoder("vp9") on the card,
  and through the windowed decoder Vp9TpuDecoder (models/vp9_tpu.py: the
  DPB on the card, the wavefront loop filter);
- the HEVC decoder: the committed 3-frame 1920x1080 bench stream and a
  1920x1080 stream with SAO and deblocking on through
  CodecContext.open_decoder("hevc") on the card (the CABAC parse on the
  host, recon_tpu and filter_tpu on the card, the DPB on the card);
- the H.264 decoder: a crafted 1920x1088 I P B CABAC stream with
  deblocking through CodecContext.open_decoder("h264") on the card (the
  CABAC parse on the host, recon_tpu's reconstruction and intra and
  deblock wavefronts on the card, the DPB on the card);
- the encoders' round trips at 1920x1080 on the seeded clip: the H.264
  encoder (CodecContext.open_encoder("h264"), K2 for its P frame) into
  the H.264 decoder; the MPEG-2 encoder's packets of phase 7 into the
  MPEG-1/2 decoder (open_decoder("mpeg2video")); the MJPEG encoder
  (open_encoder("mjpeg"), the flagship's options) into the flagship
  pipeline (K1);
- the intra codecs' round trips at 1920x1080 on the seeded frame lifted
  to 10-bit 4:2:2: ProRes and DNxHR HQX (open_encoder and open_decoder
  "prores" and "dnxhd"); and the MPEG-4 Part 2 and H.263 decoders
  (open_decoder("mpeg4"), ("h263")) on three committed streams of at
  most 352x288;
- the audio decoders: MPEG audio Layers I-III (open_decoder("mp3"),
  "mp2", "mp1"; the hybrid filterbank ops/mp3fb.py on the card), AC-3
  and E-AC-3 ("ac3", "eac3"; the IMDCT ops/ac3fb.py on the card) and
  HE-AAC (the AAC decoder's IMDCT on the card, SBR and PS on the host)
  on the ten committed streams of about 1 s each;
- the video filters: every filter of filters/video2-video8 and
  sources.py through parse_graph on the card at 1920x1080, in chains
  grouped by module, on seeded frames (testing.filter_clip);
- the rest of the audio: the AAC-LC encoder (open_encoder("aac"), its
  MDCT on the card) at 48 kHz stereo and 44.1 kHz mono, the Vorbis and
  Opus decoders (open_decoder("vorbis"), ("opus"): CELT, SILK, hybrid
  and a mode switch; the IMDCT on the card) on 19 committed streams, and
  one chain of each audio filter module (filters/audio2-audio6, host
  numpy) through parse_graph on the card, each ending in aresample;
- the CLI: ffmpeg_tpu_torch.cli.ffmpeg.main(argv, device) in process,
  demux -> decode -> filter graph -> encode -> mux on the card, on the
  command lines of testing.cli_commands (the 1080p MJPEG to 224x224
  rgb24, VP9 to framemd5, H.264 remuxed to Matroska and MP4 and decoded
  to framemd5, a 1080p y4m to MPEG-2 with K2 in its motion search, AAC to
  16 kHz mono float), and ffmpeg_tpu_torch.cli.ffprobe.main on the
  outputs;
- the CLI through the containers of io/formats/avi.py, mpegts.py and
  ogg.py, on the command lines of testing.cli_container_commands: the
  1080p MJPEG copied into AVI and decoded and scaled from it, the 1080p
  MPEG-2 copied into MPEG-TS and decoded from it, the AAC clip copied
  into MPEG-TS and decoded and resampled from it, and Ogg Vorbis and
  Opus files (CELT, SILK, hybrid) decoded;
- the CLI through the protocols and the host codecs, on the command lines
  of testing.cli_protocol_commands: the 1080p MJPEG read over HTTP, the
  AAC clip segmented into HLS, encrypted with AES-128 and read over
  HTTP, published to and played from an RTMP relay, and encoded to FLAC
  and back; a GIF decoded to framemd5 and scaled; DTS 5.1, TrueHD, MLP,
  ADPCM IMA and MS and FLAC streams decoded; a tagged MP3 probed;
- the CLI through the image codecs, FFV1, VP8 and WebP, on the command
  lines of testing.image_commands: a 1920x1080 picture to PNG, TIFF, BMP
  and PPM and back, a 480x270 one to QOI and back, an EXR picture to
  float planes, a 352x288 clip to FFV1 in Matroska and back, four
  committed FFV1 streams decoded, a 640x352 VP8 clip to framemd5 and to
  MPEG-2 with K2 in its motion search, a lossy WebP decoded and a
  320x180 picture to lossless WebP;
- the CLI's bitstream filters (-bsf), AV1 and VVC, on the command lines
  of testing.bsf_av1_vvc_commands: H.264 and HEVC out of MP4 into
  MPEG-TS through *_mp4toannexb, the VP9 bench stream through
  vp9_superframe_split, a seeded noise filter, setts and dts2pts; a
  crafted 1920x1080 AV1 OBU stream copied into IVF, MP4 and Matroska and
  through av1_frame_split and av1_metadata; crafted 832x480 and 416x240
  (10-bit) VVC GOPs to framemd5, the first with threads=4 and to
  MPEG-2 with K2 in its motion search; and the flagship through the host
  Pipeline (parallel/pipeline.py: host prep in one thread, the device
  stage with K1 in the next);
- the multi-device layer over mesh positions that are all the card:
  the row-sharded deblock with halo exchange on 1080p planes, the VP9
  loop filter in tile columns on the 1080p loop-filter keyframe, the
  HEVC deblock and SAO in tile columns on the 1080p SAO keyframe, and
  entry.dryrun_multichip(8);
- the general-length scan decode (ops/huffman.jpeg_scan_decode, any
  Huffman table) on the card: 2 committed 1920x1080 frames with the
  standard (Annex K) tables and the flagship's 8 frames.

Phases, one line each:

1. the device: CUDA must be available; the card's name and power limit
   as nvidia-smi reports them;
2. K1 (csrc/jpeg_huffman.cu) and K2 (csrc/sad_cost_volume.cu) built
   from the checkout's sources, one nvcc each, in parallel, timed;
   ptxas's register and shared-memory report;
3. K1 against its plain PyTorch version on the card over the whole batch,
   bit-exact int16 coefficients, and every frame against the port's C++
   host decoder (mjpeg_decode_scan, ffmpeg_tpu_torch/native.py),
   bit-exact; then K1 against its plain version on random bytes with
   every fifth lane a padding lane;
4. the pipeline against the committed output of the JAX reference:
   max |diff| <= 1, at most 1% of samples differing, PSNR >= 60 dB, and
   K1 launched by the run;
5. frames/s over 30 batches timed with CUDA events, host-to-device copy
   included; a breakdown of one batch; K1 against its plain version at
   the flagship shape, and K1 beside its bound (the bytes it must move
   over the card's memory rate) and its share of that bound;
6. K2 against its plain version on the card, bit-exact: at 1088x1920
   (B=16, R=8) on the padded luma of clip frames 1 and 0, which must
   also give the JAX reference's committed MVs and costs; on a
   1080x1910 plane (neither side a multiple of 16); on fractional
   float32 samples; on a flat plane (all ties); on B=8/R=4 and
   B=32/R=16 instances, uint8 and float32; on a 352x640 uint8 plane
   (phase 29's grid); K2 timed against its plain
   version at 1088x1920, uint8 (the encoder's samples) and float32, each
   beside its bound (its absolute differences over the card's rate for
   them) and its share of that bound;
7. the encoder on the card against the reference's committed I P P P
   encode of the clip: at least one K2 launch per P frame, MV grids
   equal on >= 99.5% of blocks, packet sizes within 0.1%, reconstruction
   PSNR within 0.02 dB per frame (bounds tightened from 99%, 1% and
   0.05 dB after the port on the CPU came within 99.95%, 0.0097% and
   0.0015 dB of the golden);
8. timing: encode ms per frame of a second encode, split into device
   kernel ms (K2 + argmin, FDCT, IDCT, by CUDA events at the frame's
   shapes) and host ms (the rest of the wall time: the per-macroblock
   loop, copies, Python); and the encode hot loop of benchrows.py
   (K2 -> mc_blocks_bounded -> fdct8x8 -> quant) in macroblocks/s at
   1088x1920, with its MC and FDCT timed alone;
9. the host-entropy decode->scale path (`build_decode_scale`, the
   function `ffmpeg_tpu_torch.entry.entry()` returns) at the fixture's
   full width: the 8 frames' first 12 coefficients per block from the
   host's C++ scan, DecodeScaleSpec.auto(1920, 1080, 224, 224) (lowres
   2) on the card against the JAX reference's committed output, with
   phase 4's bounds; frames/s over 30 batches of 8 with the coefficients'
   host-to-device copy; `entry()` at its own spec on the card within
   1 LSB of the port's CPU run;
10. the decoder and the filter graph: CodecContext.open_decoder on the
   card decodes the fixture's 8 packets into planes on the card, and
   parse_graph("scale=224:224:format=rgb24,tensornorm") fuses into one
   node; its rgb24 planes against the reference's committed output
   (phase 4's bounds), tensornorm against the port's CPU run within
   1e-6; decode ms per frame split into host scan and device transform,
   graph ms per frame, launches per frame by torch.profiler;
11. the dataloader row of benchrows.py: 16 clips x 8 frames of 256x256
   yuv420p (seed 0) as one frame with batched planes through
   "scale=224:224:format=rgb24,crop=200:200:12:12,tensornorm=mean=0.45:
   std=0.225" on the card; the first clip against the port's CPU run
   within 1 LSB of rgb24 after normalisation; clips/s with the
   host-to-device copy, launches per batch.
12. the audio frontend on the card over the whole clip (939 packets):
   the 16 kHz mono output and the first 32 decoded frames against the
   JAX reference's committed golden (max |diff| <= 1e-5, SNR >= 100 dB);
   tx.imdct at n=1024 and n=128 on the card against the port's CPU run
   on seeded coefficients, within 1e-5 of full scale, and each against
   the float64 product of the same operands; the graph
   "aresample=16000,aformat=channel_layouts=mono" on the card over the
   first 200 packets against the golden's prefix within 1e-5;
   x-realtime (clip seconds over the median wall time of 5 passes after
   a warm one), split into demux, host parse, IMDCT (device, CUDA
   events), host window/overlap-add, resample (FIR on the device, CUDA
   events, and the rest), with the bytes and times of the host-device
   copies; torch.profiler over one pass (kernels, copies, device busy
   share) and over the IMDCT and the FIR alone (their CUDA kernels).
13. the VP9 decoder through CodecContext.open_decoder("vp9") on the
   card: the first VP9_FRAMES (10) frames of
   tests/data/bench/vp9_1080p_100.ivf (1920x1080;
   C++ tile parse, reconstruction on the card, host loop filter) once,
   each frame's planes against the reference's committed sha256, failing
   at the first mismatch; frames/s over that pass, and the split of the
   keyframe and of the median inter frame into C++ parse, argument
   build, h2d, device reconstruction (CUDA events; MC, residual and
   intra levels within it), d2h and host loop filter; frames 0 and 1
   decoded on the card against the port's own CPU run, byte-exact; the
   committed 1920x1080 loop-filter stream against its golden, and the
   port's loopfilter_frame_tpu on the card against the host's
   lf.loopfilter_frame on its keyframe; torch.profiler, in a child
   process started after the pass and run beside these checks, over the
   keyframe and the first inter frame (kernels and copies, the device's
   busy share).
14. the windowed VP9 decoder, Vp9TpuDecoder(device).decode: the same
   VP9_FRAMES frames of the bench stream as one window with
   emit_planes=True (after a warm decode of frames 0-1), every frame's planes on the card and
   against the reference's sha256 after the window; full_decode_fps and
   the host_parse/build/device ms per frame that benchrows.recon_row_vp9
   reports; the checksum path (emit_planes=False) on frames 0-2 against
   the emitted planes; the loop-filter stream through the windowed
   decoder against its golden; loopfilter_wavefront on its keyframe
   against the host filter's planes of phase 13, timed; torch.profiler,
   in a child process started after the window and run beside these
   checks, over one inter frame as a window and over the wavefront on
   that keyframe (kernels, launch calls, busy share).
15. the HEVC decoder, CodecContext.open_decoder("hevc") on the card: the
   3 pictures (I P P) of tests/data/bench/hevc_1080p.hevc (1920x1080,
   deblock and SAO off), one packet each, against the reference's
   committed sha256 (tests/data/port/hevc_1080p_golden.npz), after a warm
   decode of the small crafted stream; full-decode frames/s and each
   picture's split into host parse, argument build, h2d and the device
   stages (residual, inter, intra levels, deblock, SAO; CUDA events);
   the device replay of the 3 recorded pictures with their references
   staged (recon_tpu.prepare, as benchrows.recon_row_hevc replays the
   reference's): device_recon_fps, each replay equal to its picture; the
   crafted 1920x1080 IDR + P stream with SAO and deblocking against its
   golden, and filters_tpu on its keyframe against the host filter.py,
   both timed; torch.profiler, in a child process started after the
   decode and run beside the replay and the filters, over the keyframe
   and the first P frame (kernels, launch calls, the device's busy
   share of the picture's wall time and of its device stage);
16. the H.264 decoder, CodecContext.open_decoder("h264") on the card:
   after a warm decode of the small crafted stream (against its
   golden), the 3 pictures (I P B) of tests/data/port/
   h264_1080p_cabac.h264 (1920x1088, CABAC, deblocking on) as one
   packet, each plane against the reference's committed sha256
   (tests/data/port/h264_1080p_golden.npz); full-decode frames/s and
   each picture's split into host parse, argument build (with
   deblock_params), h2d bytes and ms, and the device stages (residual,
   inter, intra wavefront, deblock wavefront; CUDA events); the
   truncated-slice stream (concealment on host copies) against its
   golden; torch.profiler, in a child process, over the I and the P
   picture (kernels, launch calls, the device's busy share).
17. the H.264 encoder, CodecContext.open_encoder("h264") on the card with
   its defaults (qp 26, gop 25, me_range 8, subpel 2), in a child process
   (h264_encode) that main() starts before phase 13, so that its host
   macroblock loop runs beside phases 13-16: the first 2
   frames of testing.mpeg2_clip at 1920x1080, I then P, both packets
   equal to the reference's committed sha256
   (tests/data/port/roundtrip_1080p_golden.npz), K2 launched once (the
   P frame's motion search); each frame's wall split into the host
   macroblock loop, the subpel refinement and the motion search's h2d,
   K2 + argmin and d2h; then both packets through
   open_decoder("h264") on the card, the cropped 1920x1080 planes equal
   to the sha256 of the reference's decode of its own packets, with
   full-decode frames/s and phase 16's per-picture split.
18. the MPEG-1/2 decoder, open_decoder("mpeg2video") on the card: phase
   7's own 1920x1080 I P P P packets, after a warm decode at 64x48,
   against the port's CPU decode of the same packets (I pictures within
   1 LSB on <= 1% of samples, every picture >= 60 dB), each frame's PSNR
   against the source within 0.1 dB of the reference decoder's PSNR on
   the reference's packets (committed); frames/s and each picture's
   split into host parse, h2d bytes and ms, device residual and MC.
19. the MJPEG encoder, open_encoder("mjpeg") on the card with the
   flagship's options (quality 88, restart_interval 1, optimal Huffman
   tables of <= 8 bits): 8 frames of the same clip; the coefficients
   within one quantiser step of the port's CPU transform on <= 1e-3 of
   positions, packet sizes within 0.1% of the reference's (committed);
   the packets through the flagship pipeline (MjpegTpuEntropyPipeline,
   K1) as one batch, each frame's 224x224 rgb24 PSNR against the source
   through the same scale within 0.05 dB of the reference's decode of
   its own packets (committed); encode frames/s split into the device
   transform and the host packing.
20. ProRes 4:2:2 10-bit at qscale 4, open_encoder("prores") and
   open_decoder("prores") on the card, on testing.intra_clip_frame at
   1920x1080: the levels against the port's transform on the CPU (within
   one step, each difference a truncation boundary that float32 cannot
   decide: testing.intra_levels_check), the packet's size within 0.1% of
   the reference's (committed; its sha256 reported), the decode's device
   stage against the same parse's device stage on the CPU (within 1 LSB
   on <= 1% of samples, >= 60 dB), each plane's PSNR against the source
   within 0.05 dB of the reference's decode of its own packet
   (committed); encode and decode frames/s, split into the device
   transform and the host packing, and into the host parse, h2d bytes
   and ms and the device transform (CUDA events).
21. the same for DNxHR HQX (CID 1271): the levels' differences are
   rounding ties; the host's quantise loop is in its packing.
22. the MPEG-4 and H.263 decoders on the card: the three streams of
   tests/data/port/mpeg4_streams.npz (176x144 MPEG-4 with B frames,
   176x144 MPEG-4 with 4MV, 352x288 H.263 at 400 kb/s) against the
   port's CPU decode (I pictures within 1 LSB on <= 1% of samples, every
   picture >= 60 dB), each frame's sha256 against the reference's
   counted; frames/s split into host parse, the IDCT on the card with
   its copies, and host MC and reconstruction.
23. the audio decoders on the card: mp3fb's packet forms and
   ac3fb.frame on seeded inputs at the decoders' shapes against their
   CPU runs (within 1e-5 of the CPU output's largest magnitude); each
   stream of tests/data/port/audio_streams.npz (E-AC-3 5.1 and AC-3
   stereo from the reference binary's encoder, crafted E-AC-3 AHT + SPX,
   crafted MP3 bit-reservoir, short-block and M/S frames, crafted MP2
   and MP1 stereo, HE-AAC with SBR and with PS on an AAC-LC core) through
   open_decoder on the card, after a warm pass, against the port's CPU
   decode of the same packets and its first packets against the
   reference's committed PCM, within testing.audio_bar (max |diff| <=
   1e-5 of full scale and >= 100 dB; SBR and PS >= 100 dB); the
   filterbank state on the card; x-realtime over the median of 5
   passes, split into host parse, h2d bytes and ms, the device
   filterbank (CUDA events) and d2h (for HE-AAC: host parse, the IMDCT
   stage, host window and SBR); device launches per packet from
   torch.profiler in a child process.
24. the video filters through parse_graph on the card at 1920x1080:
   the chains of ffmpeg_tpu_torch.testing.FILTER_CHAINS (every filter of
   filters/video2-video8 and sources.py, grouped by module; multi-input
   graphs on labelled pads, EOF on one input where the chain says so)
   over 8 frames of testing.filter_clip (4 for lut3d, the neighbourhood
   chain, the stacks, tonemap and colorspace), and the sources of FILTER_SOURCES and the audio
   sources; each chain against the port's CPU run of the same graph
   under the chain's bar (exact; within 1 LSB on <= 1% of samples; float
   planes within 1e-6 of their largest magnitude), and against the
   reference's committed golden (tests/data/port/filters_1080p_golden.npz,
   tools/gen_torch_filters_fixture.py): every plane's sha256 for the
   exact chains, frame 0's corners under the bar for the others, the
   psnr and ssim scores within 1e-9 relative; the planes on the card;
   per chain ms per frame (CUDA events over 3 warm runs, each of a new
   graph, its construction included, on planes already on the card)
   and, from torch.profiler in a child process that runs beside the CPU
   runs, kernels and copies per frame and the device's busy share; the
   phase's wall time split into making the inputs, the card runs, the
   timing, the CPU runs and the profile.
25. the rest of the audio on the card: tx.mdct at 1024 and tx.imdct at
   the slice's sizes (AAC 1024 at 1/512/65536; Vorbis 1024; CELT 120,
   240, 480 and 960 at 1/32768), at the main path's shapes on seeded
   inputs, against their CPU runs (within 1e-5 of full scale); the AAC
   encoder on testing.aac_signal at quality 2, 48 kHz stereo and
   44.1 kHz mono (testing.AAC_CHIP_CASES), its packets against the
   reference's committed sha256 and sizes, any packet that differs
   holding only decisions within float32's error of their tie
   (testing.aac_check against the reference's committed levels and
   scalefactors), the total size within 0.1%, and the port's AAC decoder
   on the card decoding the packets within 0.05 dB of the reference's
   decode SNR; encode frames/s and x-realtime over the median of 3
   passes, split into the host's windows, band loop and packing, the h2d,
   the device MDCT and the d2h; each Vorbis and Opus stream of
   tests/data/port/audio_codecs_streams.npz through open_decoder on the
   card against the port's CPU decode and its first packets against the
   reference's committed PCM (testing.audio_bar: max |diff| <= 1e-5 and
   >= 100 dB), x-realtime over the median of 3 passes split into the
   host (parse, window, overlap-add, SILK) and the device stage (h2d,
   IMDCT, d2h; CUDA events), and kernels per packet from torch.profiler
   in a child process beside the CPU decodes; each chain of
   testing.AUDIO_CHAINS on the card over 4 s of audio, its host filters
   bit-equal to the committed golden's sha256 (the same numpy and scipy
   code; the two CPUs' difference measured 0) and with its aresample on
   the card against the golden and the CPU graph (within 1e-5), in ms per
   second of audio.
26. the CLI on the card, each command of testing.cli_commands through
   main(argv, device) in a temporary directory, each with its wall time,
   frames/s (x-realtime for audio), K1 and K2 launches and device-to-host
   copies of frame planes per frame: (a) the flagship fixture to 224x224
   rgb24 byte-equal to open_decoder("mjpeg") + parse_graph on the card;
   (b) VP9's framemd5 text and (c) the H.264 stream's Matroska and MP4
   remuxes (sha256) and its first frame's framemd5 equal to the
   reference CLI's committed goldens (testing.CLI_GOLDEN); (d) a y4m of
   mpeg2_clip at 1920x1080 to MPEG-2 in Matroska, its packets byte-equal
   to open_encoder("mpeg2video") on the card with the CLI's parameters
   on the same frames, their sizes within 1% of the reference's, K2
   launched; (e) the ADTS clip to 16 kHz mono f32le within phase 12's bar
   of the frontend golden; (f) the probe of (c)'s and (d)'s files equal
   to the reference's text ((d)'s apart from the packets' sizes and
   positions).  The direct paths of (a) and (d) are timed beside them.
27. the CLI through the new containers on the card, in phase 26's
   directory and on its outputs, each command of
   testing.cli_container_commands with phase 26's figures: (g) the
   flagship fixture copied into AVI, sha256 equal to the reference CLI's
   (testing.CLI_GOLDEN), and the AVI to 224x224 rgb24 byte-equal to
   (a)'s output with (a)'s plane copies; (h) (d)'s MPEG-2 Matroska file
   copied into MPEG-TS, its packets equal to the Matroska file's in
   payload and in pts in seconds, and the TS to framemd5, each frame's
   md5 that of open_decoder("mpeg2video") on the card on the Matroska
   file's packets, with the rawvideo encoder's plane copies only; (i)
   the ADTS clip copied into MPEG-TS (sha256 equal to the reference
   CLI's) and the TS to 16 kHz mono f32le byte-equal to (e)'s output;
   (j) Ogg files of the committed Vorbis, CELT, SILK and hybrid packets
   (testing.write_cli_ogg) to f32le, within phase 25's bar of
   open_decoder on the same packets on the card, with the reference
   CLI's sample counts; (k) the probe of the AVI, the two TS files and an
   Ogg file equal to the reference's text (the MPEG-2 TS but for the
   packets' sizes and positions).  K1 and K2 launch 0 times.
28. the CLI through the protocols and the host codecs on the card, in
   phase 26's directory and on the outputs of phases 26-27, each command
   of testing.cli_protocol_commands with the same figures, against a
   loopback HTTP server of that directory and tests/data
   (testing.serve_http) and an RTMP relay (testing.rtmp_relay), each in
   a thread joined at the end: (l) the flagship fixture over HTTP to
   224x224 rgb24 byte-equal to (a)'s output with (a)'s plane copies;
   (m) (i)'s MPEG-TS copied into HLS, the playlist and segments and
   their AES-128 copy (testing.write_hls_aes, made by
   testing.hls_aes_files in a child process on the CPU that phase 1
   starts, since CBC encryption takes about 100 s) equal to the
   reference CLI's (sha256), and the encrypted playlist over HTTP to
   16 kHz mono
   f32le byte-equal to (i)'s output; (n) the TS published as FLV to the
   relay and played back from it to f32le byte-equal to (i)'s output,
   with the reference's message count; (o) the TS to 16 kHz mono FLAC
   and back to s16le, byte-equal to the TS's direct s16le (lossless),
   the file's STREAMINFO equal to the reference's; (p) a GIF of
   testing.gif_clip written by the port's encoder on the CPU, equal to
   the reference's (sha256), to framemd5 equal to the reference CLI's
   text with one upload a frame and the rawvideo encoder's plane copies
   only, and to 224x224 rgb24 byte-equal to open_decoder("gif") +
   parse_graph on the card; (q) the committed DTS 5.1, TrueHD, MLP,
   ADPCM IMA and MS WAV and FLAC streams (testing.HOST_CODECS), each
   decode's sha256 equal to the reference CLI's, and fftpu-probe
   -show_format -show_chapters of an ID3v2-tagged MP3 equal to the
   reference's text but for the path.  K1 and K2 launch 0 times.
29. the CLI through the image codecs, FFV1, VP8 and WebP on the card, in
   phase 26's directory, each command of testing.image_commands on
   testing.write_image_sources with the same figures and the uploads of
   a picture to the card (Uploads): (r) a seeded 1920x1080 rgb24
   picture to PNG, TIFF, BMP and PPM, a 480x270 rgba one to QOI, each
   file's sha256 equal to the reference CLI's and each decoded back
   byte-equal to its source, one upload a picture and the encoders' and
   the rawvideo encoder's plane copies only; (r_exr) the committed
   480x270 half-float EXR to gbrpf32le, sha256 equal to the reference
   CLI's; (s) 3 frames of mpeg2_clip at 352x288 to FFV1 in Matroska and
   the file to framemd5, both equal to the reference CLI's and the md5s
   the source's, and four committed FFV1 streams to rawvideo with the
   sha256 of the reference binary's decode; (t) the committed 640x352
   VP8 clip (a keyframe and three inter frames, loop filter on) to
   framemd5 equal to the reference CLI's, and to MPEG-2 in Matroska, its
   packets byte-equal to open_encoder("mpeg2video") on the card on the
   same decoded frames and within 1% of the reference's sizes, K2
   launched once per P frame and bit-exact against its plain version on
   each 352x640 (cur, ref) pair the encoder hands it; (u) the lossy WebP of the clip's keyframe
   to rawvideo and a seeded 320x180 rgba picture to lossless WebP, both
   sha256 equal to the reference CLI's, the WebP decoded by
   open_decoder("webp") on the card to the source's pixels (the
   reference CLI cannot write that decode: see PERF.md); (v) the probe
   of four of the outputs equal to the reference's text but for the
   paths.  K1 launches 0 times.
30. the CLI's bitstream filters, AV1 and VVC on the card, in phase 26's
   directory, each command of testing.bsf_av1_vvc_commands on
   testing.write_vvc_av1_sources with the same figures: (w) phase 26
   (c)'s MP4 through h264_mp4toannexb into MPEG-TS, the HEVC bench
   stream copied into MP4 and through hevc_mp4toannexb into MPEG-TS, the
   VP9 bench stream through vp9_superframe_split, a y4m through
   noise=amount=50:seed=7, the MP4 through setts and dts2pts to packet
   framemd5, each output's sha256 equal to the reference CLI's
   (testing.CLI_GOLDEN), and an unknown filter refused with the
   reference's error class; (x) the committed 1920x1080 AV1 OBU stream
   (30 temporal units) copied into IVF, MP4 and Matroska, each file's
   sha256 the reference CLI's and its packets read back the stream's
   units, through av1_frame_split and av1_metadata to the reference
   CLI's sha256, fftpu-probe of the IVF equal to the reference's text
   but for the path, and open_decoder("av1") on the card raising the
   reference's NotSupported; (y) the committed 832x480 VVC GOP (I P B B,
   MTT, two references in each list) to framemd5 and the 416x240 10-bit
   GOP to framemd5, equal to the reference CLI's text with one upload a
   picture, open_decoder("vvc") on the card with the reference's sha256
   and with threads=4 byte-equal to the serial decode, and the 832x480
   GOP to MPEG-2 in Matroska, its packets byte-equal to
   open_encoder("mpeg2video") on the card on the same decoded frames and
   within 1% of the reference's sizes, K2 launched once per P frame and
   bit-exact against its plain version on each (cur, ref) pair; (z) 8
   batches of the flagship fixture through parallel/pipeline.Pipeline:
   host prep_frame in one stage, run_batch and its copy back in the
   next (three pipelines in turn, so that a batch is staged while the
   one before it is on the card), each batch equal to phase 4's output,
   K1 launched once a batch and bit-exact against its plain version,
   the pipeline's wall time against the sum of its stages' busy time.
31. the multi-device layer, every mesh position the card (n x cuda:0):
   (a) parallel/halo.sharded_deblock of a seeded blocky 1088x1920 plane
   over 4 positions and of a 1080x1920 one over 3, each equal to
   deblock_plane on the whole plane; (b) codecs/vp9/lf_sharded
   .loopfilter_sharded on phase 13's 1080p loop-filter keyframe over 2
   positions (and 3 while the script stays well inside its limit), equal
   to the host filter's planes of phase 13, with its ms and its
   edge_filter calls; (c) codecs/hevc/filter_tpu.sharded_filters on
   phase 15's 1080p SAO + deblock keyframe in 4 tile columns, equal to
   filters_tpu on the card, timed beside it; (d) entry.dryrun_multichip(8)
   (its five legs each against its unsharded counterpart); (e) (a) and
   (c) over distinct cards where more than one is visible.
32. the general-length scan decode, ops/huffman.jpeg_scan_decode (PyTorch
   on the card, 16-bit table lookups, codes of any length): (a) the 2
   frames of testing.HUFFMAN_ANNEXK (1920x1080, quality 88, one MCU per
   restart interval, the encoder's default Annex K tables; made by
   tools/gen_torch_huffman_fixture.py), split by the port's C++
   mjpeg_split_segments with build_jpeg_luts per frame
   (testing.general_scan_inputs), each bit-exact against the C++ host
   decoder; build_jpeg_luts9 refusing each frame's tables, and a decode
   with the table entries of codes over 9 bits zeroed giving other
   coefficients; (b) the flagship's 8 frames, each bit-exact against
   K1's coefficients on the same frames (K1 launched once); (c) one
   frame's ms a call (CUDA events, median of 3), the steps against
   max_iter, and one call's launches on the host and kernels on the
   device (torch.profiler), with the launches a step derived from them.
33. K1's camera kernel (jpeg_scan_decode_packed_rows_kernel, the camera
   format of models/mjpeg_tpu_entropy.py: segments of whole MCU rows,
   4:2:2 or 4:2:0, any baseline table): (a) 64 RFC 2435 type-64 1080p
   frames of the benchmark's generator (portbench/inputs/rtpjpeg.py:
   4:2:2, the Annex K tables, a restart marker every MCU row) staged by
   MjpegTpuEntropyPipeline.prep_frame, decoded in one launch, bit-exact
   against the generator's coefficients and against decode_packed_plain
   on the card on the same regions; the first 8 regions with random scan
   bytes and every fourth lane padding bit-exact against the plain
   version; (b) the 2 frames of testing.HUFFMAN_ANNEXK (4:2:0, one MCU of
   6 blocks a segment, 8160 lanes a frame) through the same kernel,
   bit-exact against the plain version and the C++ host decoder; (c) the
   kernel's ms on (a)'s batch (kernel_ms, and cuda_ms with no spin), the
   plain version's, and the bound from (a)'s bytes and the generator's
   symbols; (d) run_batch on (a)'s frames: one launch of this kernel and
   none of the flagship's, the first 2 frames' rgb24 planes within the
   benchmark config's check.excess_lsb of the float64 plain reference
   (portbench/reference/mjpeg422.py).  Its launches are counted where it
   launches (ops/huffman.py ROWS_KERNEL_LAUNCHES); no earlier phase
   launches it.
Phases 9-16, 18, 20-25, 27, 28 and 31 run PyTorch only: K1 and K2 are
not on their paths, and each prints their launch counts over its run
(0).  K2's launches in the JSON line count phases 7, 17, 26 (d), 29 (t)
and 30 (y), K1's phases 4, 19, 30 (z) and 32 (b), and the camera
kernel's phase 33.  Phases 13-33 print
their wall times, and the script its own.  The CPU decodes that phases
13 and 18 hold the card's frames against run in child processes started
after phase 7 (cpu_oracle), beside the card's work.

Then a JSON line with each kernel's launches, error, time, plain time
and bound, and as the last line {"ok": true, "device": {...}}.  Any
failed phase raises and the script exits non-zero without that line.

Bounds use the card's published peaks (NVIDIA H100 SXM): 3.35 TB/s of
device memory, and for integer work the rate NVIDIA's CUDA C++
Programming Guide gives compute capability 9.0 for 32-bit integer add,
subtract, absolute difference and multiply-add, 64 results per clock per
SM: 132 SMs x 64 x 1.98 GHz = 16.73 T instructions/s.  Neither kernel
has work a tensor core does.  No PyTorch call computes either kernel's
function, so `library_ms` is null for both.  Kernel times are
`kernel_ms` (ffmpeg_tpu_torch/timing.py: the card spins while the host
queues the calls), with `cuda_ms` (no spin) printed beside them.

Usage (from the repository root, one card):

    python3 chip_smoke.py
"""

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
TIMED_BATCHES = 30
K1_SOURCE = "ffmpeg_tpu_torch/csrc/jpeg_huffman.cu"
K1_REPLACES = "ffmpeg_tpu/ops/huffman.py:446"
# the camera format has no TPU kernel: the reference decodes such streams
# with its general-length XLA loop
ROWS_REPLACES = "ffmpeg_tpu/ops/huffman.py:199"
CAMERA_FRAMES = 64               # phase 33: one b64 batch of the camera cell
K2_SOURCE = "ffmpeg_tpu_torch/csrc/sad_cost_volume.cu"
K2_REPLACES = "ffmpeg_tpu/ops/me.py:79"
ENC_W, ENC_H = 1920, 1080
# phases 13-14 decode the VP9 bench stream's first 10 of its 100 frames
# (the keyframe and 9 inter frames): cut from 30 when phases 17-19
# joined, so that the whole script stays near 700 s of its 1200 s limit
VP9_FRAMES = 10
HBM_BYTES_PER_S = 3.35e12
INT32_INSTR_PER_S = 132 * 64 * 1.98e9
# phase 7 bounds against the reference's committed encode
MV_MIN_AGREE, SIZE_REL_TOL, PSNR_TOL_DB = 0.995, 1e-3, 0.02
# phase 12 bounds: against the reference's committed golden; and the
# card's IMDCT and FIR against the port's CPU run, as a share of the CPU
# output's largest magnitude: float32 sums in another order (1.64e-7 of
# 0.11 at n=1024 over the main path's 3.8 M outputs on an H100), the
# bound tests/test_torch_tx.py holds against the reference
AUDIO_TOL, AUDIO_MIN_SNR, TX_REL = 1e-5, 100.0, 1e-5


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def bound(nbytes: float, instr: float) -> tuple[float, str]:
    """(ms, what sets it): the larger of the bytes over the memory rate
    and the integer instructions over the SMs' integer rate."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = instr / INT32_INSTR_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def k1_bound(lens, luts, out) -> tuple[float, str]:
    """K1 reads each segment's scan bytes, the lengths and the tables
    once and writes its coefficients once (the padding past each frame's
    scan in `regions` is never read).  Its operations: about 20 integer
    instructions per symbol, and this batch's symbols are at most its
    non-zero coefficients plus a DC and an end of block per block of
    each segment."""
    nbytes = int(lens.sum()) + sum(t.numel() * t.element_size()
                                   for t in (lens, luts, out))
    symbols = int((out != 0).sum()) + 12 * int((lens > 0).sum())
    return bound(nbytes, 20 * symbols)


def rows_bound(lens, tables, out, symbols: int) -> tuple[float, str]:
    """K1's camera kernel reads each segment's scan bytes, the lengths and
    the frames' tables once and writes its coefficients once; about 20
    integer instructions a symbol, the symbols counted by the generator
    that encoded the frames."""
    nbytes = int(lens.sum()) + sum(t.numel() * t.element_size()
                                   for t in (lens, tables, out))
    return bound(nbytes, 20 * symbols)


def k2_bound(cur, B: int, R: int, is_u8: bool) -> tuple[float, str]:
    """K2 reads cur and ref once and writes the volume once.  Its work
    is by*bx*B*B*(2R+1)^2 absolute differences, each accumulated: on
    uint8 one VABSDIFF4 with its accumulator does four (a quarter of an
    instruction each); on float32 input, once truncated to int32, each
    takes two instructions (difference with absolute value, add)."""
    h, w = cur.shape
    by, bx, D = h // B, w // B, 2 * R + 1
    nbytes = 2 * h * w * cur.element_size() + by * bx * D * D * 4
    diffs = by * bx * B * B * D * D
    return bound(nbytes, diffs / 4 if is_u8 else 2 * diffs)


T0 = time.monotonic()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import numpy as np
    from ffmpeg_tpu_torch import _cuda_build
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    from ffmpeg_tpu_torch.testing import (BATCH, FIXTURE, GOLDEN, H, OUT,
                                          STRIDE, W, host_decode, packed_cap)
    from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline, TpuEntropySpec)
    from ffmpeg_tpu_torch.ops import huffman, me
    from ffmpeg_tpu_torch.timing import cuda_ms, kernel_ms

    # 1. device
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"phase 1 device: {card} (torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.device_count()} visible)",
          flush=True)
    hls = _hls_aes_start()

    # 2. build K1 and K2 from the checkout's sources
    t = time.monotonic()
    log = _cuda_build.build(_cuda_build.so_path())
    _cuda_build.get()
    ptxas = "; ".join(ln.split("info    : ")[-1].strip()
                      for ln in log.splitlines() if "Used" in ln)
    print(f"phase 2 build: {K1_SOURCE}, {K2_SOURCE} -> sm_90a in "
          f"{time.monotonic() - t:.3f} s; ptxas: {ptxas}", flush=True)

    # 3. K1 against its plain version, and frame 0 against the host decoder
    pkts = split_packets(FIXTURE.read_bytes())
    if len(pkts) != BATCH:
        raise RuntimeError(f"fixture has {len(pkts)} frames, not {BATCH}")
    spec = TpuEntropySpec(W, H, OUT, OUT, batch=BATCH, stride=STRIDE,
                          packed_cap=packed_cap(pkts))
    pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=dev)
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    regions = torch.from_numpy(pipe.regions).to(dev)
    lens, luts = pipe.program.split_regions(regions)
    got = huffman.jpeg_scan_decode_packed(regions, lens, luts, pipe.hdr)
    want = huffman.decode_packed_plain(regions, lens, luts, pipe.hdr)
    torch.cuda.synchronize()
    k1_err = int((got.int() - want.int()).abs().max())
    if got.shape != (BATCH, pipe.nmcu, 6, 64) or not torch.equal(got, want):
        raise RuntimeError(f"K1 differs from its plain version: max |diff| "
                           f"{k1_err}, {int((got != want).sum())} values")
    for i, p in enumerate(pkts):
        if not np.array_equal(got[i].cpu().numpy(), host_decode(p)):
            raise RuntimeError(f"K1 frame {i} differs from the C++ host "
                               f"decoder")
    rng = np.random.default_rng(5)
    junk = regions.clone()
    junk[:, pipe.hdr:] = torch.from_numpy(rng.integers(
        0, 256, tuple(junk[:, pipe.hdr:].shape), dtype=np.uint8)).to(dev)
    jlens, jluts = pipe.program.split_regions(junk)
    jlens = jlens.clone()
    jlens[:, ::5] = 0                          # padding lanes
    jgot = huffman.jpeg_scan_decode_packed(junk, jlens, jluts, pipe.hdr)
    jwant = huffman.decode_packed_plain(junk, jlens, jluts, pipe.hdr)
    torch.cuda.synchronize()
    if not torch.equal(jgot, jwant):
        raise RuntimeError(f"K1 differs from its plain version on random "
                           f"bytes: {int((jgot != jwant).sum())} values")
    k1_err = max(k1_err, int((jgot.int() - jwant.int()).abs().max()))
    print(f"phase 3 K1: {BATCH}x{pipe.nmcu} lanes bit-exact against the "
          f"plain version (max |diff| {k1_err}); all {BATCH} frames "
          f"bit-exact against mjpeg_decode_scan; {int((got != 0).sum())} "
          f"nonzero coefficients; random bytes with every fifth lane "
          f"padding bit-exact against the plain version", flush=True)

    # 4. the main path, through the pipeline's entry points, against the
    #    JAX reference's committed output
    gold = np.load(GOLDEN)["planes"]
    huffman.KERNEL_LAUNCHES = me.KERNEL_LAUNCHES = 0
    for i, p in enumerate(pkts):
        pipe.prep_frame(p, i)
    comps = pipe.run_batch()
    torch.cuda.synchronize()
    launches = huffman.KERNEL_LAUNCHES
    out = np.stack([c.cpu().numpy() for c in comps])
    note = check_close(out, gold, "pipeline output against the JAX golden")
    print(f"phase 4 pipeline: {out.shape} uint8 vs JAX golden: {note}; K1 "
          f"launches {launches}", flush=True)
    if launches < 1:
        raise RuntimeError("K1 not launched by the pipeline")

    # 5. timing (CUDA events; the h2d copy from pinned memory included)
    batch_ms = cuda_ms(pipe.run_batch, TIMED_BATCHES)
    fps = BATCH * 1e3 / batch_ms
    h2d_ms = cuda_ms(lambda: pipe._host.to(dev, non_blocking=True), 20)
    prog_ms = cuda_ms(lambda: pipe.program(regions), 20)
    k1_ms = kernel_ms(lambda: huffman.jpeg_scan_decode_packed(
        regions, lens, luts, pipe.hdr), 20)
    k1_nospin_ms = cuda_ms(lambda: huffman.jpeg_scan_decode_packed(
        regions, lens, luts, pipe.hdr), 20)
    plain_ms = cuda_ms(lambda: huffman.decode_packed_plain(
        regions, lens, luts, pipe.hdr), 3)
    t = time.perf_counter()
    for _ in range(3):
        for i, p in enumerate(pkts):
            pipe.prep_frame(p, i)
    prep_ms = (time.perf_counter() - t) * 1e3 / (3 * BATCH)
    k1_bound_ms, k1_by = k1_bound(lens, luts, got)
    print(f"phase 5 timing [{card}]: {fps:.2f} frames/s over "
          f"{TIMED_BATCHES} batches of {BATCH} ({batch_ms:.3f} ms/batch, "
          f"h2d included); one batch: h2d {h2d_ms:.3f} ms, program "
          f"{prog_ms:.3f} ms, of which K1 {k1_ms:.4f} ms (no spin "
          f"{k1_nospin_ms:.4f} ms; plain version "
          f"{plain_ms:.3f} ms; bound {k1_bound_ms:.4f} ms by {k1_by}, "
          f"{k1_bound_ms / k1_ms:.1%} of it); host prep {prep_ms:.3f} "
          f"ms/frame (one CPU thread, not in frames/s)", flush=True)

    k2 = phase6_k2(dev)
    frames, k2_launches, mpeg2_pkts = phase7_encoder(dev)
    import tempfile
    work = tempfile.TemporaryDirectory()
    oracles = {"vp9": CpuOracle("vp9", Path(work.name)),
               "mpeg2": CpuOracle("mpeg2", Path(work.name), mpeg2_pkts)}
    phase8_timing(dev, card, frames)
    phase9_decode_scale(dev, card)
    phase10_decoder_graph(dev, card)
    phase11_dataloader(dev, card)
    phase12_audio(dev, card)
    encode = Child(f"h264_encode({str(dev)!r})", "phase 17's encode",
                   timeout=900)
    lf_key = phase13_vp9(dev, card, oracles["vp9"])
    phase14_vp9_window(dev, card, lf_key)
    hevc_key = phase15_hevc(dev, card)
    phase16_h264(dev, card)
    clip, k2_enc = phase17_h264_encode(dev, card, encode)
    phase18_mpeg2_decode(dev, card, mpeg2_pkts, oracles["mpeg2"])
    work.cleanup()
    k1_enc = phase19_mjpeg_encode(dev, card, clip)
    phase_intra(dev, card, "prores", 20)
    phase_intra(dev, card, "dnxhd", 21)
    phase22_mpeg4(dev, card)
    phase23_audio_decoders(dev, card)
    phase24_filters(dev, card)
    phase25_audio_codecs(dev, card)
    with tempfile.TemporaryDirectory() as tmp:
        rows26 = phase26_cli(dev, card, Path(tmp))
        rows27 = phase27_containers(dev, card, Path(tmp), rows26)
        phase28_protocols(dev, card, Path(tmp), rows26, rows27, hls)
        rows29 = phase29_images(dev, card, Path(tmp))
        rows30 = phase30_bsf_av1_vvc(dev, card, Path(tmp), out)
    phase31_multidevice(dev, card, lf_key, hevc_key)
    k1_general = phase32_general_scan(dev, card)
    rows = phase33_camera_k1(dev, card)
    launches += k1_enc + rows30["z"]["k1"] + k1_general
    k1_err = max(k1_err, rows30["z"]["k1_err"])
    k2_launches += (k2_enc + rows26["d"]["k2"] + rows29["t_m2v"]["k2"]
                    + rows30["y_m2v"]["k2"])
    k2["err"] = max(k2["err"], rows29["t_m2v"]["k2_err"],
                    rows30["y_m2v"]["k2_err"])
    print(f"whole script: {time.monotonic() - T0:.1f} s", flush=True)

    print(json.dumps({"kernels": [{
        "name": "jpeg_scan_decode_packed", "route": "cuda",
        "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches, "max_abs_err": k1_err,
        "ms": k1_ms, "plain_ms": plain_ms, "bound_ms": k1_bound_ms,
        "bound_by": k1_by, "library_ms": None}, {
        "name": "sad_cost_volume_strip", "route": "cuda",
        "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": k2_launches, "max_abs_err": k2["err"],
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
        "library_ms": None}, rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


def _k2_cases(golden_pair):
    """(name, cur, ref, B, R) with uint8/float32 host planes, phase 6."""
    import numpy as np
    rng = np.random.default_rng(9)

    def frac(h, w):
        cur = rng.integers(0, 256, (h, w)).astype(np.float32)
        ref = np.roll(cur, (3, -5), (0, 1)) + rng.normal(0, 2, cur.shape) - 4
        return cur, ref.astype(np.float32)

    def u8(h, w):
        return tuple(rng.integers(0, 256, (h, w)).astype(np.uint8)
                     for _ in range(2))

    flat = np.full((1088, 1920), 200, np.uint8)
    return [("1088x1920 clip luma", *golden_pair, 16, 8),
            ("1080x1910 u8", *u8(1080, 1910), 16, 8),
            ("1088x1920 fractional f32", *frac(1088, 1920), 16, 8),
            ("1088x1920 flat", flat, flat, 16, 8),
            ("1088x1920 u8 B=8 R=4", *u8(1088, 1920), 8, 4),
            ("1088x1920 f32 B=8 R=4", *frac(1088, 1920), 8, 4),
            ("544x960 u8 B=32 R=16", *u8(544, 960), 32, 16),
            ("544x960 f32 B=32 R=16", *frac(544, 960), 32, 16),
            ("352x640 u8", *u8(352, 640), 16, 8)]


def phase6_k2(dev) -> dict:
    """K2 bit-exact against its plain version on the card and against
    the reference's committed pair; K2 and plain timed at 1088x1920,
    uint8 and float32, each beside its bound."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.codecs.mpeg12_enc import _pad
    from ffmpeg_tpu_torch.ops import me
    from ffmpeg_tpu_torch.testing import ENC_FRAMES, ENCODE_GOLDEN, \
        clip_checksum, mpeg2_clip
    from ffmpeg_tpu_torch.timing import cuda_ms, kernel_ms
    g = np.load(ENCODE_GOLDEN)
    clip = mpeg2_clip(ENC_FRAMES, ENC_W, ENC_H)
    if clip_checksum(clip) != str(g["clip_sha256"]):
        raise RuntimeError("the seeded clip differs from the golden's")
    luma = [_pad(np.asarray(f.planes[0]), 1088, 1920) for f in clip[:2]]
    err, notes, f32 = 0.0, [], None
    for name, cur, ref, B, R in _k2_cases((luma[1], luma[0])):
        c, r = (torch.from_numpy(a).to(dev) for a in (cur, ref))
        got = me.sad_cost_volume_strip(c, r, B, R)
        want = me.sad_cost_volume_strip_plain(c, r, B, R)
        torch.cuda.synchronize()
        e = float((got - want).abs().max())
        err = max(err, e)
        if not torch.equal(got, want):
            raise RuntimeError(f"K2 differs from its plain version on "
                               f"{name}: max |diff| {e}")
        notes.append(f"{name} {tuple(got.shape)}")
        if name == "1088x1920 flat" and not bool(
                (me.best_mvs(got, 8) == -8).all()):
            raise RuntimeError("K2 on a flat plane: ties not at (-8, -8)")
        if name == "1088x1920 fractional f32":
            f32 = (c, r)
    c, r = (torch.from_numpy(a).to(dev) for a in (luma[1], luma[0]))
    mvs, cost = me.motion_search(c, r, 16, 8)
    if not (np.array_equal(mvs.cpu().numpy(), g["pair_mvs"])
            and np.array_equal(cost.cpu().numpy(), g["pair_costs"])):
        raise RuntimeError("K2's MVs or costs differ from the reference's "
                           "committed pair")
    ms = kernel_ms(lambda: me.sad_cost_volume_strip(c, r, 16, 8), 20)
    nospin_ms = cuda_ms(lambda: me.sad_cost_volume_strip(c, r, 16, 8), 20)
    plain_ms = cuda_ms(lambda: me.sad_cost_volume_strip_plain(c, r, 16, 8),
                       3)
    f32_ms = kernel_ms(lambda: me.sad_cost_volume_strip(*f32, 16, 8), 20)
    b_ms, b_by = k2_bound(c, 16, 8, True)
    fb_ms, fb_by = k2_bound(f32[0], 16, 8, False)
    print(f"phase 6 K2: bit-exact against the plain version on "
          f"{', '.join(notes)} (max |diff| {err}); MVs and costs equal to "
          f"the reference's on the golden pair; at 1088x1920 B=16 R=8: "
          f"uint8 {ms:.4f} ms (no spin {nospin_ms:.4f} ms; plain version "
          f"{plain_ms:.3f} ms; bound "
          f"{b_ms:.4f} ms by {b_by}, {b_ms / ms:.1%} of it), float32 "
          f"{f32_ms:.4f} ms (bound {fb_ms:.4f} ms by {fb_by}, "
          f"{fb_ms / f32_ms:.1%} of it)", flush=True)
    return {"err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by}


def _encode(dev, frames):
    """I P P P through the port's entry point; per frame: packet, wall
    seconds (the encoder waits for its device results), MV grid,
    reconstruction PSNR."""
    from ffmpeg_tpu_torch.codecs import CodecContext, EncoderParameters, \
        Rational
    from ffmpeg_tpu_torch.testing import ENC_OPTIONS, recon_psnr
    ctx = CodecContext.open_encoder(
        EncoderParameters("mpeg2video", ENC_W, ENC_H, Rational(25, 1)),
        dict(ENC_OPTIONS), device=dev)
    out = []
    for f in frames:
        t = time.perf_counter()
        ctx.send_frame(f)
        pkt = ctx.receive_packet()
        out.append({"data": pkt.data, "bytes": len(pkt.data),
                    "s": time.perf_counter() - t,
                    "mvs": ctx.codec.last_mv_grid,
                    "psnr": recon_psnr(ctx.codec._recon, f)})
    return out


def phase7_encoder(dev):
    """The encoder's path on the card against the reference's golden.
    Returns the clip, K2's launches and the packets (for phase 18)."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.ops import huffman, me
    from ffmpeg_tpu_torch.testing import ENC_FRAMES, ENCODE_GOLDEN, \
        mpeg2_clip
    g = np.load(ENCODE_GOLDEN)
    frames = mpeg2_clip(ENC_FRAMES, ENC_W, ENC_H)
    huffman.KERNEL_LAUNCHES = me.KERNEL_LAUNCHES = 0
    res = _encode(dev, frames)
    torch.cuda.synchronize()
    launches = me.KERNEL_LAUNCHES
    n_p = ENC_FRAMES - 1
    agree = [float((r["mvs"] == want).all(-1).mean())
             for r, want in zip(res[1:], g["p_mvs"])]
    rel = [r["bytes"] / int(b) - 1 for r, b in zip(res, g["packet_bytes"])]
    dpsnr = [r["psnr"] - float(p) for r, p in zip(res, g["psnr"])]
    print(f"phase 7 encoder: 1920x1080 I P P P qscale 8 through "
          f"CodecContext.open_encoder; K2 launches {launches} for {n_p} P "
          f"frames; packets {[r['bytes'] for r in res]} bytes vs golden "
          f"{g['packet_bytes'].tolist()} (rel {[f'{x:+.5%}' for x in rel]});"
          f" MV agreement {[f'{a:.4%}' for a in agree]}; PSNR "
          f"{[round(r['psnr'], 4) for r in res]} dB (diff "
          f"{[f'{d:+.5f}' for d in dpsnr]})", flush=True)
    if (launches < n_p or min(agree) < MV_MIN_AGREE
            or max(map(abs, rel)) > SIZE_REL_TOL
            or max(map(abs, dpsnr)) > PSNR_TOL_DB):
        raise RuntimeError(f"encoder outside its bounds (K2 launches >= "
                           f"{n_p}, MVs >= {MV_MIN_AGREE:.1%}, sizes within "
                           f"{SIZE_REL_TOL:.1%}, PSNR within {PSNR_TOL_DB} "
                           f"dB)")
    return frames, launches, [r["data"] for r in res]


def phase8_timing(dev, card, frames):
    """Encode ms per frame split into device kernel ms and host ms, and
    the encode hot loop of benchrows.py in macroblocks/s."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.codecs.mpeg12_enc import _blocks, _pad
    from ffmpeg_tpu_torch.ops import idct, mc, me
    from ffmpeg_tpu_torch.timing import cuda_ms
    res = _encode(dev, frames)                 # warm: second encode
    y, u, v = (np.asarray(p) for p in frames[1].planes[:3])
    planes = [_pad(y, 1088, 1920), _pad(u, 544, 960), _pad(v, 544, 960)]
    yd = torch.from_numpy(planes[0]).to(dev)
    blk = torch.from_numpy(np.concatenate(
        [_blocks(p.astype(np.int32), 8).astype(np.float32)
         for p in planes])).to(dev).reshape(-1, 8, 8)
    search_ms = cuda_ms(lambda: me.motion_search(yd, yd, 16, 8), 10)
    fdct_i_ms = cuda_ms(lambda: idct.fdct8x8(blk), 10)
    fdct_p_ms = cuda_ms(lambda: idct.fdct8x8(torch.cat([blk, blk])), 10)
    idct_ms = cuda_ms(lambda: idct.idct8x8(blk), 10)
    dev_i = fdct_i_ms + idct_ms
    dev_p = search_ms + fdct_p_ms + idct_ms
    wall_i = res[0]["s"] * 1e3
    wall_p = float(np.mean([r["s"] for r in res[1:]])) * 1e3

    H, W, B = 1088, 1920, 16
    rng = np.random.default_rng(3)
    cur = rng.integers(0, 256, (H, W)).astype(np.float32)
    ref = np.roll(cur, (3, -5), (0, 1)) + \
        rng.normal(0, 2, (H, W)).astype(np.float32)
    cd, rd = (torch.from_numpy(a).to(dev) for a in (cur, ref))

    def hot():
        mvs, cost = me.motion_search(cd, rd, B, 8)
        pred = mc.mc_blocks_bounded(rd, mvs * 4, B, max_disp=12)
        blocks = (cd - pred).reshape(H // 8, 8, W // 8, 8) \
            .permute(0, 2, 1, 3).reshape(-1, 8, 8)
        q = torch.round(idct.fdct8x8(blocks) / 16.0)
        return torch.sum(torch.abs(q)) + torch.sum(cost)

    hot_ms = cuda_ms(hot, 10)
    mbps = (H // B) * (W // B) / (hot_ms / 1e3)
    mvs4 = me.motion_search(cd, rd, B, 8)[0] * 4
    mc_ms = cuda_ms(lambda: mc.mc_blocks_bounded(rd, mvs4, B, max_disp=12),
                    10)
    fdct_ms = cuda_ms(lambda: idct.fdct8x8(cd.reshape(-1, 8, 8)), 10)
    print(f"phase 8 timing [{card}]: encode 1920x1080 qscale 8, second "
          f"run: I frame {wall_i:.1f} ms (device kernels {dev_i:.3f} ms: "
          f"FDCT {fdct_i_ms:.3f}, IDCT {idct_ms:.3f}; host "
          f"{wall_i - dev_i:.1f} ms), P frame mean {wall_p:.1f} ms (device "
          f"kernels {dev_p:.3f} ms: K2 + argmin {search_ms:.3f}, FDCT "
          f"{fdct_p_ms:.3f}, IDCT {idct_ms:.3f}; host {wall_p - dev_p:.1f} "
          f"ms); encode hot loop (K2 -> mc_blocks_bounded -> fdct8x8 -> "
          f"quant) {hot_ms:.3f} ms per 1088x1920 frame = {mbps:.0f} "
          f"macroblocks/s (MB/s), of which mc_blocks_bounded {mc_ms:.3f} "
          f"ms, fdct8x8 {fdct_ms:.3f} ms", flush=True)


def plane_diff(got, want, bits: int = 8) -> tuple:
    """|got - want| as int32 for two integer arrays, and its PSNR (dB) at
    the peak of `bits`."""
    import numpy as np
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    mse = float((d.astype(np.float64) ** 2).mean())
    return d, 10 * np.log10(((1 << bits) - 1) ** 2 / max(mse, 1e-12))


def check_close(got, want, what: str, bits: int = 8) -> str:
    """Phases 4, 9, 10, 18 and 20-22: integer planes within 1 LSB of
    `want`, on at most 1% of samples, at >= 60 dB PSNR at the peak of
    `bits`; raises outside, else describes."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{what}: {got.shape} {got.dtype}, expected "
                           f"{want.shape} {want.dtype}")
    d, psnr = plane_diff(got, want, bits)
    frac = float((d > 0).mean())
    note = (f"max |diff| {int(d.max())}, {frac:.6%} of samples differ, "
            f"PSNR {psnr:.2f} dB")
    if d.max() > 1 or frac > 0.01 or psnr < 60:
        raise RuntimeError(f"{what} outside its tolerance (max 1 LSB, <= 1% "
                           f"differ, >= 60 dB): {note}")
    return note


def check_pictures(got, want, dev, what: str) -> tuple[float, list]:
    """Phases 18 and 22: 8-bit frames decoded on the card against the CPU
    decode of the same packets: planes on `dev`, I pictures under
    check_close's bar, every picture >= 60 dB; raises outside, else
    (the worst PSNR, max |diff| per picture)."""
    worst, dmax = float("inf"), []
    for f, w in zip(got, want):
        if any(p.device != dev for p in f.planes):
            raise RuntimeError(f"{what}: decoded planes not on the card")
        m = 0
        for a, b in zip(f.planes, w.planes):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            if f.pict_type == "I":
                check_close(a, b, f"{what}: I picture against the CPU "
                            f"decode")
            d, psnr = plane_diff(a, b)
            worst, m = min(worst, psnr), max(m, int(d.max()))
        dmax.append(m)
    if worst < 60:
        raise RuntimeError(f"{what}: a picture at {worst:.2f} dB of the CPU "
                           f"decode")
    return worst, dmax


def zero_counts() -> None:
    from ffmpeg_tpu_torch.ops import huffman, me
    huffman.KERNEL_LAUNCHES = me.KERNEL_LAUNCHES = 0


def read_counts() -> str:
    """K1's and K2's launch counts since zero_counts(): neither kernel is
    on the paths of phases 9-11, which run PyTorch only."""
    from ffmpeg_tpu_torch.ops import huffman, me
    return f"K1/K2 launches {huffman.KERNEL_LAUNCHES}/{me.KERNEL_LAUNCHES}"


def profile_device(fn, warm: bool = True,
                   cpu: bool = True) -> tuple[list, int]:
    """torch.profiler over one call of fn(), after a warm one unless
    `warm` is false: ([(name, us)] of the device's kernels and copies,
    the host's kernel-launch API calls).  cpu=False leaves the host's
    operator events out of the trace (a VP9 keyframe queues some 10^5
    kernels, and each operator event costs the trace's post-processing
    time); the launch calls are counted where the trace has the CUDA
    runtime's events.  The trace is read from the profiler's own event
    records: prof.events() would first build a Python object and a tree
    for each of them, some 30-40 s for a VP9 keyframe's 6e5 events, for
    the same names and durations."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * cpu
                 + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    device, api = [], 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((e.name(), e.duration_ns() / 1e3))
        elif e.name().startswith(("cudaLaunchKernel", "cuLaunchKernel")):
            api += 1
    return device, api


def count_launches(fn, call_ms: float) -> str:
    """Device kernels and copies of one warm call of fn(), counted by
    torch.profiler, with the host's kernel-launch API calls beside them,
    and the device's busy time in that call (the sum of the kernels' and
    copies' durations) as a share of `call_ms`, the call's time by CUDA
    events in a loop, and the three longest kinds of device work."""
    return summarize_launches(*profile_device(fn), call_ms)


def summarize_launches(device: list, api: int, call_ms: float) -> str:
    """count_launches' description of a profile_device() result."""
    kernels = sum(1 for name, _ in device
                  if not name.startswith(("Memcpy", "Memset")))
    copies = len(device) - kernels
    busy_us = sum(us for _, us in device)
    by_name: dict = {}
    for name, us in device:
        by_name[name[:48]] = by_name.get(name[:48], 0.0) + us
    if kernels == 0 and api == 0:
        return "launches not measured (the profiler saw no CUDA activity)"
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
    calls = (f"{api} launch calls on the host" if api else
             "the host's launch calls not in the trace")
    return (f"{kernels} kernels + {copies} copies on the device, {calls}; "
            f"device busy {busy_us / 1e3:.3f} ms "
            f"({busy_us / 1e3 / call_ms:.1%} of {call_ms:.3f} ms), longest: "
            + ", ".join(f"{n} {us / 1e3:.3f} ms" for n, us in top))


def median_ms(fn, reps: int = 3) -> float:
    """Median host-clock ms of fn() over reps calls."""
    import statistics
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ts)


class Child:
    """`chip_smoke.<call>` in a child process on the card, started now and
    read later, so that it runs beside the main process's work (the
    torch.profiler sessions, which lose records in a process that has
    traced before, and the host-bound H.264 encode).  result() waits for
    it (`timeout` s at most) and returns the JSON object on its last line
    of output; at exit the child is killed if it still runs."""

    def __init__(self, call: str, what: str, timeout: float = 600):
        import atexit
        self.what, self.timeout = what, timeout
        self.proc = subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; chip_smoke.{call}"],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        atexit.register(self.stop)

    def stop(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate()

    def result(self) -> dict:
        try:
            out, err = self.proc.communicate(timeout=self.timeout)
        except subprocess.TimeoutExpired:
            self.stop()
            raise
        if self.proc.returncode != 0:
            raise RuntimeError(f"{self.what} exited {self.proc.returncode}: "
                               f"{err[-3000:]}")
        return json.loads(out.strip().splitlines()[-1])


def phase9_decode_scale(dev, card) -> None:
    """The entry() twin at full width: the fixture's coefficients at
    DecodeScaleSpec.auto(1920, 1080, 224, 224) through build_decode_scale
    on the card, against the reference's committed golden; then entry()
    at its own spec on the card against the port's CPU run."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch import entry
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    from ffmpeg_tpu_torch.models.mjpeg_pipeline import (
        DecodeScaleSpec, build_decode_scale, pack_coeffs)
    from ffmpeg_tpu_torch.testing import (BATCH, DECODE_SCALE_GOLDEN,
                                          FIXTURE, H, OUT, W, scan_coeffs)
    from ffmpeg_tpu_torch.timing import cuda_ms
    pkts = split_packets(FIXTURE.read_bytes())
    spec = DecodeScaleSpec.auto(W, H, OUT, OUT)
    per = [scan_coeffs(p, spec.ncoeff) for p in pkts]
    scan_ms = median_ms(lambda: [scan_coeffs(p, spec.ncoeff)
                                 for p in pkts]) / len(pkts)
    wire = [torch.from_numpy(pack_coeffs(np.stack([f[i] for f in per])))
            .pin_memory() for i in range(3)]
    qy, qc = (torch.from_numpy(per[0][i]).to(dev) for i in (3, 4))
    fn = build_decode_scale(spec)

    def step():
        return fn(*[w.to(dev, non_blocking=True) for w in wire], qy, qc)

    zero_counts()
    out = step()
    torch.cuda.synchronize()
    counts = read_counts()
    if not all(o.is_cuda for o in out):
        raise RuntimeError("build_decode_scale's planes are not on the card")
    got = np.stack([o.cpu().numpy() for o in out])
    note = check_close(got, np.load(DECODE_SCALE_GOLDEN)["decode_scale"],
                       "build_decode_scale against the JAX golden")
    batch_ms = cuda_ms(step, TIMED_BATCHES)
    on_dev = [w.to(dev) for w in wire]
    dev_ms = cuda_ms(lambda: fn(*on_dev, qy, qc), TIMED_BATCHES)
    h2d_ms = cuda_ms(lambda: [w.to(dev, non_blocking=True) for w in wire],
                     TIMED_BATCHES)
    launches = count_launches(step, batch_ms)

    efn, eargs = entry.entry()
    cfn, cargs = entry.entry(device="cpu")
    if not all(a.is_cuda for a in eargs):
        raise RuntimeError("entry()'s arguments are not on the card")
    ed = max(int((a.cpu().int() - b.int()).abs().max())
             for a, b in zip(efn(*eargs), cfn(*cargs)))
    if ed > 1:
        raise RuntimeError(f"entry() on the card differs from the CPU run "
                           f"by {ed} LSB")
    print(f"phase 9 decode_scale [{card}]: {BATCH} fixture frames at "
          f"lowres {spec.lowres}, {spec.ncoeff} coefficients per block; host "
          f"scan (mjpeg_decode_scan, one thread, median of 3) "
          f"{scan_ms:.3f} ms/frame; "
          f"{tuple(got.shape)} uint8 on the card vs JAX golden: {note}; "
          f"{counts}; {BATCH * 1e3 / batch_ms:.2f} frames/s over "
          f"{TIMED_BATCHES} batches of {BATCH} ({batch_ms:.3f} ms/batch, "
          f"h2d of {sum(w.numel() for w in wire)} coefficient bytes "
          f"included; h2d alone {h2d_ms:.3f} ms, without the h2d "
          f"{dev_ms:.3f} ms); one batch: {launches}; entry() 256x192 -> "
          f"128x128 batch 2 on the card within {ed} LSB of its CPU run",
          flush=True)


def phase10_decoder_graph(dev, card) -> None:
    """CodecContext.open_decoder on the card decodes the fixture; a parsed
    graph scales its frames to 224x224 rgb24 and normalises them, against
    the reference's committed golden and the port's CPU tensornorm."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.codecs.mjpeg import scan_decode
    from ffmpeg_tpu_torch.core.packet import Packet
    from ffmpeg_tpu_torch.filters import parse_graph
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    from ffmpeg_tpu_torch.io.stream import CodecParameters, MediaType
    from ffmpeg_tpu_torch.testing import (DECODE_SCALE_GOLDEN, FIXTURE,
                                          GRAPH_FRAMES, GRAPH_TEXT, H, W)
    from ffmpeg_tpu_torch.timing import cuda_ms
    pkts = split_packets(FIXTURE.read_bytes())
    par = CodecParameters(codec_type=MediaType.VIDEO, codec_id="mjpeg")
    text = GRAPH_TEXT + ",tensornorm"
    zero_counts()
    ctx = CodecContext.open_decoder(par, device=dev)
    frames = ctx.decode_all([Packet(data=p, pts=i)
                             for i, p in enumerate(pkts)])
    g = parse_graph(text, device=dev)
    out = g.run(frames)
    torch.cuda.synchronize()
    counts = read_counts()
    shapes = [tuple(p.shape) for p in frames[0].planes]
    if (len(frames) != len(pkts) or shapes != [(H, W), (H // 2, W // 2),
                                               (H // 2, W // 2)]
            or not all(p.is_cuda for f in frames for p in f.planes)):
        raise RuntimeError(f"decoder gave {len(frames)} frames of {shapes}, "
                           f"or planes off the card")
    if [n.filter.name for n in g.nodes] != ["scale+tensornorm"]:
        raise RuntimeError(f"graph nodes {[n.filter.name for n in g.nodes]}")
    if len(out) != len(pkts) or not all(
            p.is_cuda and p.dtype == torch.float32 and p.shape == (224, 224)
            for f in out for p in f.planes):
        raise RuntimeError("graph output not 224x224 float32 on the card")
    rgb = parse_graph(GRAPH_TEXT, device=dev).run(frames[:GRAPH_FRAMES])
    got = np.stack([np.stack([p.cpu().numpy() for p in f.planes])
                    for f in rgb], axis=1)
    note = check_close(got, np.load(DECODE_SCALE_GOLDEN)["graph"],
                       "decoder -> scale graph against the JAX golden")
    norm = parse_graph("tensornorm", device="cpu").run(
        [f.numpy() for f in rgb])
    nd = max(float((a.cpu() - b).abs().max())
             for f, n in zip(out, norm) for a, b in zip(f.planes, n.planes))
    if nd > 1e-6:
        raise RuntimeError(f"tensornorm on the card differs from the CPU "
                           f"run by {nd}")

    dec = ctx.codec
    scans = [scan_decode(p) for p in pkts]
    scan_ms = median_ms(lambda: [scan_decode(p) for p in pkts]) / len(pkts)
    recon_ms = cuda_ms(lambda: [dec.reconstruct(s) for s in scans],
                       5) / len(pkts)

    def decode():
        ctx.flush()
        ctx.decode_all([Packet(data=p) for p in pkts])
        torch.cuda.synchronize()
    wall_ms = median_ms(decode) / len(pkts)
    graph_ms = cuda_ms(lambda: g.run(frames), 5) / len(pkts)
    launches = count_launches(lambda: g.run(frames[:1]), graph_ms)
    print(f"phase 10 decoder->graph [{card}]: {len(frames)} frames {shapes} "
          f"uint8 on the card; graph '{text}' fused into one node "
          f"'{g.nodes[0].filter.name}'; rgb24 frames 0-{GRAPH_FRAMES - 1} "
          f"vs JAX golden: {note}; tensornorm within {nd:.3g} of the CPU "
          f"run; {counts}; decode {wall_ms:.3f} ms/frame wall, median of 3 "
          f"(host scan {scan_ms:.3f} ms, device transform {recon_ms:.3f} ms with the "
          f"coefficients' h2d), graph {graph_ms:.3f} ms/frame; one frame "
          f"through the graph: {launches}", flush=True)


def phase11_dataloader(dev, card) -> None:
    """benchrows.dataloader_row's batch, 16 clips x 8 frames of 256x256
    yuv420p made from seed 0, as one frame with batched planes through
    the parsed graph on the card; the first clip against the port's CPU
    run of the same graph."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.core.frame import Frame
    from ffmpeg_tpu_torch.filters import parse_graph
    from ffmpeg_tpu_torch.timing import cuda_ms
    B, T, S = 16, 8, 256
    text = ("scale=224:224:format=rgb24,crop=200:200:12:12,"
            "tensornorm=mean=0.45:std=0.225")
    rng = np.random.default_rng(0)
    planes = [rng.integers(0, 256, (B * T, S, S), np.uint8),
              rng.integers(0, 256, (B * T, S // 2, S // 2), np.uint8),
              rng.integers(0, 256, (B * T, S // 2, S // 2), np.uint8)]
    pinned = [torch.from_numpy(p).pin_memory() for p in planes]
    g = parse_graph(text, device=dev)

    def step():
        return g.run([Frame.video(S, S, "yuv420p", planes=[
            p.to(dev, non_blocking=True) for p in pinned])])[0]

    zero_counts()
    out = step()
    torch.cuda.synchronize()
    counts = read_counts()
    if [n.filter.name for n in g.nodes] != ["scale+crop+tensornorm"] or \
            not all(p.is_cuda and p.shape == (B * T, 200, 200)
                    for p in out.planes):
        raise RuntimeError(f"dataloader graph: nodes "
                           f"{[n.filter.name for n in g.nodes]}, planes "
                           f"{[tuple(p.shape) for p in out.planes]}")
    want = parse_graph(text, device="cpu").run([Frame.video(
        S, S, "yuv420p", planes=[p[:T] for p in planes])])[0]
    d = max(float((a[:T].cpu() - b).abs().max())
            for a, b in zip(out.planes, want.planes))
    tol = 1 / (255 * 0.225) + 1e-5
    if d > tol:
        raise RuntimeError(f"dataloader's first clip differs from the CPU "
                           f"run by {d} (> {tol:.6f})")
    ms = cuda_ms(step, TIMED_BATCHES)
    h2d_ms = cuda_ms(lambda: [p.to(dev, non_blocking=True) for p in pinned],
                     TIMED_BATCHES)
    print(f"phase 11 dataloader [{card}]: {B} clips x {T} frames {S}x{S} "
          f"yuv420p through '{text}' (one node "
          f"'{g.nodes[0].filter.name}'), planes {tuple(out.planes[0].shape)} "
          f"float32 on the card; first clip within {d:.3g} of the CPU run "
          f"(<= {tol:.6f}); {counts}; {B * 1e3 / ms:.2f} clips/s over "
          f"{TIMED_BATCHES} batches ({ms:.3f} ms/batch, h2d included; h2d "
          f"alone {h2d_ms:.3f} ms); one batch: {count_launches(step, ms)}",
          flush=True)


def _close_audio(got, want, what: str, tol, min_snr: float) -> str:
    """Phases 12 and 23: float32 samples within `tol` (None: no bound) of
    `want`, times its largest magnitude where that exceeds full scale 1,
    at >= `min_snr` dB; raises outside, else describes."""
    import numpy as np
    from ffmpeg_tpu_torch.testing import snr_db
    if got.shape != want.shape or got.dtype != np.float32:
        raise RuntimeError(f"{what}: {got.shape} {got.dtype}, expected "
                           f"{want.shape} float32")
    if tol is not None:
        tol *= max(1.0, float(np.abs(want).max()))
    err, snr = float(np.abs(got - want).max()), snr_db(got, want)
    note = f"{what} {got.shape} max |diff| {err:.3g}, SNR {snr:.2f} dB"
    if (tol is not None and err > tol) or snr < min_snr:
        raise RuntimeError(f"{note}: outside max |diff| <= {tol}, SNR >= "
                           f"{min_snr} dB")
    return note


def _kernels(device: list) -> str:
    """The kernels (not copies) of a profile_device() list, with times."""
    ks = [(n, us) for n, us in device
          if not n.startswith(("Memcpy", "Memset"))]
    return ", ".join(f"{n[:60]} {us / 1e3:.4f} ms" for n, us in ks)


def _audio_device_stages(dev, par, pkts, pcm):
    """The main path's two device stages at its shapes, on `dev`: the
    IMDCT of every long channel of `pkts` and the FIR of the first
    convert of `pcm` (the decoded clip) to 16 kHz mono.  Returns
    (imdct(), fir(), their host inputs and the resampler)."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.codecs.aac import EIGHT_SHORT, LONG_SCALE
    from ffmpeg_tpu_torch.ops import tx
    from ffmpeg_tpu_torch.resample import swresample
    dec = CodecContext.open_decoder(par, device=dev).codec
    chans = [ch for _, outs, _sbr in dec.parse_packets(pkts)
             for _, ch in outs]
    spec = np.stack([ch.coeffs.astype(np.float32) for ch in chans
                     if ch.ics.window_sequence != EIGHT_SHORT])
    spec_d = torch.from_numpy(spec).to(dev)
    swr = swresample.SwrContext(par.sample_rate, "stereo", "fltp", 16000,
                                "mono", "fltp", device=dev)
    mono = (swr.matrix @ pcm.astype(np.float64)).astype(np.float32)
    r = swr.resampler
    b0, buf = r._buf_start, np.concatenate([r._buf, mono], axis=1)
    r.process(mono)
    ipos, ph = r._positions(0, r._out_count)
    fir_host = [buf, (ipos - r.center - b0).astype(np.int32),
                ph.astype(np.int32)]
    fir_args = [torch.from_numpy(a).to(dev) for a in fir_host]
    return (lambda: tx.imdct(spec_d, 1024, LONG_SCALE),
            lambda: swresample._fir_kernel(*fir_args, r.bank, r.taps),
            {"spec": spec, "n_short": len(chans) - len(spec),
             "fir_host": fir_host, "resampler": r})


def audio_profile(pass_ms: float, device: str = "cuda:0") -> None:
    """Phase 12's torch.profiler sessions, which phase12_audio runs in a
    process of its own: in a whole run of this script (torch 2.11 on an
    H100) the sessions after phases 9-11's lost their last one or two
    kernel records (15 launches gave 14 kernels, the FIR's 9 gave 7, the
    IMDCT's one gave none), while the same sessions as the first of a
    process kept every one.  Prints one JSON line: one pass's launches
    (count_launches against `pass_ms`), then the IMDCT's and the FIR's
    kernels."""
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.io.adts import read_adts
    from ffmpeg_tpu_torch.testing import AAC_CLIP, audio_frontend
    dev = torch.device(device)
    data = AAC_CLIP.read_bytes()

    def one_pass():
        return audio_frontend(*read_adts(data), dev)
    frames, _ = one_pass()
    pcm = np.concatenate([f.audio_data for f in frames], axis=1)
    imdct, fir, _ = _audio_device_stages(dev, *read_adts(data), pcm)

    def kernels(fn):
        # a session after the process's first may lose its kernel
        # records (on an H100, once, every one of the IMDCT's or the
        # FIR's), so one that saw none is run again, three times at most
        for _ in range(3):
            seen = _kernels(profile_device(fn)[0])
            if seen:
                return seen
        return ""
    print(json.dumps({"pass": count_launches(one_pass, pass_ms),
                      "imdct": kernels(imdct), "fir": kernels(fir)}),
          flush=True)


def phase12_audio(dev, card) -> None:
    """The audio frontend at full size on the card: the committed clip
    through the ADTS demuxer, decode_frames and SwrContext against the
    reference's committed golden; tx.imdct against the port's CPU run;
    the audio graph over the reference row's 200 packets; x-realtime and
    its split; torch.profiler over one pass, the IMDCT and the FIR."""
    import statistics
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.codecs.aac import LONG_SCALE, SHORT_SCALE
    from ffmpeg_tpu_torch.filters import parse_graph
    from ffmpeg_tpu_torch.io.adts import read_adts
    from ffmpeg_tpu_torch.ops import tx
    from ffmpeg_tpu_torch.resample import swresample
    from ffmpeg_tpu_torch.testing import (AAC_CLIP, AUDIO_GOLDEN,
                                          AUDIO_GRAPH_PACKETS,
                                          AUDIO_GRAPH_TEXT, audio_frontend,
                                          graph_prefix)
    from ffmpeg_tpu_torch.timing import cuda_ms
    data = AAC_CLIP.read_bytes()

    def one_pass():
        return audio_frontend(*read_adts(data), dev)

    # the main path, checked
    zero_counts()
    frames, out = one_pass()
    torch.cuda.synchronize()
    counts = read_counts()
    par, pkts = read_adts(data)
    clip_s = len(pkts) * 1024 / par.sample_rate
    if len(frames) != len(pkts) or not all(
            isinstance(p, np.ndarray) and p.dtype == np.float32
            for f in frames for p in f.planes):
        raise RuntimeError(f"decode_frames gave {len(frames)} frames for "
                           f"{len(pkts)} packets, or planes not float32")
    gold = np.load(AUDIO_GOLDEN)
    pcm = np.concatenate([f.audio_data for f in frames], axis=1)
    notes = [_close_audio(out, gold["resampled"], "16 kHz mono output",
                          AUDIO_TOL, AUDIO_MIN_SNR),
             _close_audio(pcm[:, :gold["decoded"].shape[1]], gold["decoded"],
                          "first 32 decoded frames", AUDIO_TOL,
                          AUDIO_MIN_SNR)]

    # tx.imdct on the card against the port's CPU run; each also against
    # the float64 product of the same float32 operands
    rng = np.random.default_rng(12)
    tx_notes = []
    for n, scale, rows in ((1024, LONG_SCALE, 2 * len(pkts)),
                           (128, SHORT_SCALE, 8 * 64)):
        c = (rng.standard_normal((rows, n)) * 2 ** 15).astype(np.float32)
        want = tx.imdct(torch.from_numpy(c), n, scale).numpy()
        got = tx.imdct(torch.from_numpy(c).to(dev), n, scale)
        if got.device != dev:
            raise RuntimeError(f"tx.imdct of a tensor on {dev} gave one on "
                               f"{got.device}")
        got = got.cpu().numpy()
        m_t = np.float32(tx._mdct_matrix(n) * scale).astype(np.float64)
        exact = c.astype(np.float64) @ m_t
        full = float(np.abs(want).max())
        err = float(np.abs(got - want).max())
        if err > TX_REL * full:
            raise RuntimeError(f"tx.imdct n={n} on the card differs from "
                               f"the CPU run by {err:.3g} (> {TX_REL} of "
                               f"full scale {full:.3g})")
        tx_notes.append(
            f"n={n} ({rows}, {n}) within {err:.3g} of the CPU run, full "
            f"scale {full:.3g} ({err / full:.3g} of it); against float64 "
            f"the card {float(np.abs(got - exact).max()) / full:.3g}, the "
            f"CPU {float(np.abs(want - exact).max()) / full:.3g}")

    # the graph over the reference row's cut
    g = parse_graph(AUDIO_GRAPH_TEXT, device=dev)
    gout = g.run(frames[:AUDIO_GRAPH_PACKETS])
    if [nd.filter.name for nd in g.nodes] != ["aresample", "aformat"] or \
            g.nodes[0].filter._ctx.resampler.bank.device != dev:
        raise RuntimeError("the audio graph's resampler is not on the card")
    k = graph_prefix(AUDIO_GRAPH_PACKETS)
    gcat = np.concatenate([f.audio_data for f in gout], axis=1)
    if gcat.shape[1] < k or not all(f.sample_rate == 16000 for f in gout):
        raise RuntimeError(f"the audio graph gave {gcat.shape} at "
                           f"{gout[0].sample_rate} Hz")
    gnote = _close_audio(gcat[:, :k], gold["resampled"][:, :k],
                         f"first {k} outputs", AUDIO_TOL, AUDIO_MIN_SNR)
    print(f"phase 12 audio check [{card}]: {len(pkts)} ADTS packets "
          f"({clip_s:.3f} s, 48 kHz stereo AAC-LC) through decode_frames and "
          f"SwrContext(48000 stereo -> 16000 mono fltp) on the card vs JAX "
          f"golden: {'; '.join(notes)}; {counts}; tx.imdct on the card vs "
          f"the port's CPU run: {', '.join(tx_notes)}; graph "
          f"'{AUDIO_GRAPH_TEXT}' on the card over {AUDIO_GRAPH_PACKETS} "
          f"packets vs golden: {gnote}", flush=True)

    # x-realtime: median wall time of 5 passes after a warm one
    walls = []
    for _ in range(5):
        t = time.perf_counter()
        one_pass()
        walls.append(time.perf_counter() - t)
    pass_s = statistics.median(walls)

    def split():
        t = [time.perf_counter()]
        p, ps = read_adts(data)
        t.append(time.perf_counter())
        dec = CodecContext.open_decoder(p, device=dev).codec
        parsed = dec.parse_packets(ps)
        t.append(time.perf_counter())
        dec.batched_imdct(parsed)
        t.append(time.perf_counter())
        fr = dec.overlap_add(parsed)
        t.append(time.perf_counter())
        x = np.concatenate([f.audio_data for f in fr], axis=1)
        swr = swresample.SwrContext(p.sample_rate, "stereo", "fltp", 16000,
                                    "mono", "fltp", device=dev)
        np.concatenate([swr.convert(x), swr.flush()], axis=1)
        t.append(time.perf_counter())
        return np.diff(t) * 1e3
    demux_ms, parse_ms, imdct_stage_ms, ola_ms, swr_ms = \
        np.median([split() for _ in range(3)], axis=0)

    # the device stages at the main path's shapes
    imdct, fir, st = _audio_device_stages(dev, par, pkts, pcm)
    spec, r, host = st["spec"], st["resampler"], st["fir_host"]
    imdct_ms = cuda_ms(imdct, 20)
    imdct_h2d_ms = cuda_ms(lambda: torch.from_numpy(spec).to(dev), 10)
    y = imdct()
    imdct_d2h_ms = cuda_ms(lambda: y.cpu(), 10)
    fo = fir()
    want = swresample._fir_kernel(*[torch.from_numpy(a) for a in host],
                                  r.bank.cpu(), r.taps)
    fir_err = float((fo.cpu() - want).abs().max())
    if fir_err > TX_REL * float(want.abs().max()):
        raise RuntimeError(f"the FIR on the card differs from its CPU run by "
                           f"{fir_err:.3g}")
    fir_ms = cuda_ms(fir, 20)
    fir_h2d_ms = cuda_ms(lambda: [torch.from_numpy(a).to(dev)
                                  for a in host], 10)
    fir_d2h_ms = cuda_ms(lambda: fo.cpu(), 10)
    fir_h2d_b = sum(a.nbytes for a in host)
    print(f"phase 12 audio timing [{card}]: {clip_s / pass_s:.2f}x realtime "
          f"({clip_s:.3f} s of audio in a median {pass_s * 1e3:.1f} ms per "
          f"pass, wall, passes {[round(w * 1e3, 1) for w in walls]} ms); "
          f"split (median of 3 passes, ms): demux {demux_ms:.2f}, host parse "
          f"{parse_ms:.1f}, IMDCT stage {imdct_stage_ms:.2f} (h2d "
          f"{spec.nbytes} B {imdct_h2d_ms:.3f} ms, device {imdct_ms:.4f} ms "
          f"for ({len(spec)}, 1024) -> ({len(spec)}, 2048) float32, "
          f"{st['n_short']} short-window channels, d2h {y.numel() * 4} B "
          f"{imdct_d2h_ms:.3f} ms), host window/overlap-add {ola_ms:.1f}, "
          f"resample {swr_ms:.1f} (FIR device {fir_ms:.4f} ms for "
          f"{fo.shape[1]} outputs x {r.taps} taps, within {fir_err:.3g} of "
          f"its CPU run; h2d {fir_h2d_b} B {fir_h2d_ms:.3f} ms; d2h "
          f"{fo.numel() * 4} B {fir_d2h_ms:.3f} ms; the rest, host rematrix "
          f"in float64 and Python, "
          f"{swr_ms - fir_ms - fir_h2d_ms - fir_d2h_ms:.1f})", flush=True)

    # torch.profiler, in a process of its own: one pass, then the IMDCT
    # and the FIR alone
    prof = Child(f"audio_profile({pass_s * 1e3!r}, {str(dev)!r})",
                 "phase 12's profile").result()
    if "not measured" not in prof["pass"] and not (prof["imdct"]
                                                   and prof["fir"]):
        raise RuntimeError("the profiler saw no CUDA kernel of the IMDCT or "
                           "the FIR")
    print(f"phase 12 audio profile [{card}]: one pass: {prof['pass']}; "
          f"IMDCT kernels: {prof['imdct'] or 'not measured'}; FIR kernels: "
          f"{prof['fir'] or 'not measured'}", flush=True)


def _vp9_split(st: dict) -> str:
    """One frame's split from VP9Core.stats."""
    d = st["device"]
    dev_ms = d["mc"] + d["residual"] + d["intra"]
    return (f"{st['total']:.2f} ms: C++ parse {st['parse']:.2f}, argument "
            f"build {st['build']:.2f}, h2d {st['h2d']:.3f} "
            f"({st['h2d_bytes'] / 1e6:.2f} MB), device "
            f"reconstruction {dev_ms:.2f} (MC {d['mc']:.3f}, residual "
            f"{d['residual']:.3f}, intra levels {d['intra']:.2f}; the "
            f"host queued it in {st['queue']:.2f}), d2h {d['d2h']:.3f} "
            f"(the host's wait and copy {st['d2h']:.2f}), host loop filter "
            f"{st['lf']:.2f}")


def vp9_profile(kf_ms: float, inter_ms: float, device: str = "cuda:0"):
    """Phase 13's torch.profiler sessions, run in a process of their own
    (see audio_profile): a warm decode of frames 0-1, then a fresh
    decoder's keyframe and first inter frame, each profiled alone.
    Prints one JSON line of count_launches' descriptions against the
    frames' wall times in the main pass."""
    sys.path.insert(0, str(REPO))
    import torch
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    from ffmpeg_tpu_torch.testing import VP9_BENCH, vp9_decode
    dev = torch.device(device)
    par, _tb, pkts = read_ivf(VP9_BENCH.read_bytes())
    vp9_decode(pkts[:2], dev)
    dec = CodecContext.open_decoder(par, device=dev)

    def one(p):
        def fn():
            dec.send_packet(p)
            dec.receive_frame()
        return fn
    out = {}
    for name, p, ms in (("keyframe", pkts[0], kf_ms),
                        ("inter", pkts[1], inter_ms)):
        out[name] = summarize_launches(
            *profile_device(one(p), warm=False, cpu=False), ms)
    print(json.dumps(out), flush=True)


def phase13_vp9(dev, card, oracle) -> dict:
    """The VP9 decoder at full width on the card: the bench stream's
    first VP9_FRAMES frames against the reference's hashes, timed and
    split; frames 0-1 against the port's CPU run; the loop-filter
    stream against its
    golden and loopfilter_frame_tpu against the host filter; launches
    by torch.profiler in a child process.  `oracle` is the CpuOracle of
    frames 0-1.  Returns the loop-filter
    stream's keyframe for phase 14: its FrameState, pre-filter planes,
    the host filter's planes and times."""
    import statistics
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.codecs.vp9.lf_tpu import loopfilter_frame_tpu
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    from ffmpeg_tpu_torch.testing import (VP9_BENCH, VP9_GOLDEN, VP9_LF,
                                          VP9_LF_GOLDEN, plane_sha256,
                                          vp9_decode)
    from ffmpeg_tpu_torch.utils.error import TryAgain
    t_phase = time.monotonic()
    par, _tb, pkts = read_ivf(VP9_BENCH.read_bytes())
    gold = np.load(VP9_GOLDEN)["hashes"]
    if len(pkts) != 100 or (par.width, par.height) != (1920, 1080):
        raise RuntimeError(f"bench stream: {len(pkts)} packets at "
                           f"{par.width}x{par.height}")
    card_frames = vp9_decode(pkts[:2], dev)       # warm: not in the pass

    # the main path: the first VP9_FRAMES frames once, each checked
    dec = CodecContext.open_decoder(par, device=dev)
    core = dec.codec.core
    core.stats = []
    zero_counts()
    walls = []
    for i, p in enumerate(pkts[:VP9_FRAMES]):
        t = time.perf_counter()
        dec.send_packet(p)
        f = dec.receive_frame()
        walls.append((time.perf_counter() - t) * 1e3)
        try:
            dec.receive_frame()
            raise RuntimeError(f"packet {i} gave more than one frame")
        except TryAgain:
            pass
        if any(pl.device != dev for pl in f.planes):
            raise RuntimeError(f"frame {i}'s planes are not on the card")
        got = [plane_sha256(pl) for pl in f.planes]
        if got != list(gold[i]):
            bad = [n for n, g, w in zip("yuv", got, gold[i]) if g != w]
            raise RuntimeError(f"frame {i} differs from the reference's "
                               f"hashes in {bad}")
    torch.cuda.synchronize()
    counts = read_counts()
    stats = core.stats
    nf = VP9_FRAMES
    if len(stats) != nf or not stats[0]["keyframe"] or any(
            s["keyframe"] for s in stats[1:]):
        raise RuntimeError(f"expected one keyframe then {nf - 1} inter "
                           f"frames")
    fps = len(walls) * 1e3 / sum(walls)
    inter = sorted(range(1, nf), key=lambda k: stats[k]["total"])
    med = inter[len(inter) // 2]
    dev_inter = [sum(stats[k]["device"][n] for n in ("mc", "residual",
                                                     "intra"))
                 for k in range(1, nf)]
    print(f"phase 13 vp9 decode [{card}]: the first {nf} frames of 1920x1080 "
          f"through open_decoder('vp9') on the card, every frame's y/u/v "
          f"equal to the reference's sha256; {counts}; {fps:.3f} frames/s "
          f"({sum(walls):.1f} ms for the pass, wall, after a warm decode "
          f"of frames 0-1; the keyframe {walls[0]:.1f} ms, inter frames "
          f"median {statistics.median(walls[1:]):.2f} ms, min "
          f"{min(walls[1:]):.2f}, max {max(walls[1:]):.2f}); keyframe "
          f"({stats[0]['levels']} intra levels) "
          f"{_vp9_split(stats[0])}; median inter frame (frame {med}, "
          f"{stats[med]['levels']} levels) "
          f"{_vp9_split(stats[med])}; "
          f"device reconstruction of the {nf - 1} inter frames: median "
          f"{statistics.median(dev_inter):.2f} ms, sum "
          f"{sum(dev_inter):.1f} ms", flush=True)
    prof = Child(f"vp9_profile({walls[0]!r}, {walls[1]!r}, {str(dev)!r})",
                 "phase 13's profile")

    # frames 0 and 1 on the card (the warm decode's) against the port's
    # CPU run (in a child process since phase 7)
    cpu = oracle.planes()
    if len(cpu) != 2:
        raise RuntimeError(f"the CPU run gave {len(cpu)} frames, not 2")
    for i, (a, b) in enumerate(zip(cpu, card_frames)):
        for pl, (x, y) in enumerate(zip(a, b.planes)):
            if not np.array_equal(x, y.cpu().numpy()):
                raise RuntimeError(f"frame {i} plane {pl}: the card differs "
                                   f"from the CPU run")

    # the loop-filter stream, and loopfilter_frame_tpu on its keyframe
    lpar, _ltb, lpkts = read_ivf(VP9_LF.read_bytes())
    lgold = np.load(VP9_LF_GOLDEN)["lf"]
    t = time.perf_counter()
    lframes = vp9_decode(lpkts, dev)
    lf_wall = (time.perf_counter() - t) * 1e3
    if len(lframes) != len(lgold):
        raise RuntimeError(f"lf stream: {len(lframes)} frames")
    for i, f in enumerate(lframes):
        if [plane_sha256(pl) for pl in f.planes] != list(lgold[i]):
            raise RuntimeError(f"lf stream frame {i} differs from its "
                               f"golden")
    key = vp9_lf_keyframe(dev, lpkts[0].data)
    h, fs, host, host_ms = key["h"], key["fs"], key["host"], key["host_ms"]
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = loopfilter_frame_tpu(fs, dev)
    torch.cuda.synchronize()
    tpu_ms = (time.perf_counter() - t) * 1e3
    for name, a, b, o in zip("yuv", host, (fs.y, fs.u, fs.v), out):
        if not (np.array_equal(a, b) and o.device.type == dev.type):
            raise RuntimeError(f"loopfilter_frame_tpu on the card differs "
                               f"from lf.loopfilter_frame ({name})")
    print(f"phase 13 vp9 checks [{card}]: frames 0-1 on the card "
          f"byte-exact against the port's CPU run; loop-filter stream "
          f"({len(lpkts)} frames 1920x1080, filter_level "
          f"{h.filter_level} then 48) equal to its golden in "
          f"{lf_wall:.1f} ms, wall; loopfilter_frame_tpu on the card "
          f"equal to lf.loopfilter_frame on its keyframe (level "
          f"{h.filter_level}, sharpness {h.sharpness}): {tpu_ms:.1f} ms on "
          f"the card against {host_ms:.1f} ms on the host", flush=True)

    prof = prof.result()
    print(f"phase 13 vp9 profile [{card}]: keyframe: {prof['keyframe']}; "
          f"inter frame 1: {prof['inter']}", flush=True)
    print(f"phase 13 wall time: {time.monotonic() - t_phase:.1f} s "
          f"(of it {oracle.waited:.1f} s waiting for the CPU decode's "
          f"child)", flush=True)
    return dict(key, tpu_ms=tpu_ms)


def vp9_lf_keyframe(dev, data: bytes) -> dict:
    """The loop-filter stream's keyframe `data` as phases 13 and 31 take
    it: parsed, reconstructed on the card, its pre-filter planes, and
    the host filter's planes with their ms."""
    import copy
    from ffmpeg_tpu_torch.codecs.vp9 import VP9Core, lf, recon_tpu
    cap = VP9Core(native=True, device=dev)
    cap.capture = []
    cap.decode_frame(data)
    h, fs, rec = cap.capture[0]
    recon_tpu.reconstruct(fs, rec, dev)
    host = copy.copy(fs)
    host.y, host.u, host.v = fs.y.copy(), fs.u.copy(), fs.v.copy()
    pre = (fs.y.copy(), fs.u.copy(), fs.v.copy())
    t = time.perf_counter()
    lf.loopfilter_frame(host)
    host_ms = (time.perf_counter() - t) * 1e3
    return {"h": h, "fs": fs, "pre": pre, "host": (host.y, host.u, host.v),
            "host_ms": host_ms}


def _wave_args(fs):
    """loopfilter_wavefront's arguments after the planes for a
    FrameState, with the 4px edge limits of its MI dims."""
    from ffmpeg_tpu_torch.codecs.vp9.lf_tpu import frame_lf_args
    maps, lvl8, lim, mblim, dims = frame_lf_args(fs)
    return (*maps, lvl8, lim, mblim, fs.sb_rows, fs.sb_cols, dims)


def vp9_window_profile(device: str = "cuda:0"):
    """Phase 14's torch.profiler sessions, in a process of their own (see
    audio_profile): one inter frame of the windowed decoder (a decoder
    that has decoded frames 0-2 of the bench stream decodes frame 3 as a
    window of one; frame 2's wall time is the call's time), and
    loopfilter_wavefront on the loop-filter stream's keyframe (an
    unprofiled call's wall time is the call's time).  Prints one JSON
    line of summarize_launches' descriptions."""
    sys.path.insert(0, str(REPO))
    import torch
    from ffmpeg_tpu_torch.codecs.vp9 import VP9Core, recon_tpu
    from ffmpeg_tpu_torch.codecs.vp9.lf_wave import loopfilter_wavefront
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    from ffmpeg_tpu_torch.models.vp9_tpu import Vp9TpuDecoder
    from ffmpeg_tpu_torch.testing import VP9_BENCH, VP9_LF
    dev = torch.device(device)
    _par, _tb, pkts = read_ivf(VP9_BENCH.read_bytes())
    data = [p.data for p in pkts]
    dec = Vp9TpuDecoder(device=dev)
    dec.decode(data[:2])
    t = time.perf_counter()
    dec.decode(data[2:3])
    inter_ms = (time.perf_counter() - t) * 1e3
    out = {"inter": summarize_launches(*profile_device(
        lambda: dec.decode(data[3:4]), warm=False, cpu=False), inter_ms)}
    _lpar, _ltb, lpkts = read_ivf(VP9_LF.read_bytes())
    cap = VP9Core(native=True, device=dev)
    cap.capture = []
    cap.decode_frame(lpkts[0].data)
    _h, fs, rec = cap.capture[0]
    planes = recon_tpu.reconstruct(fs, rec, dev)
    args = _wave_args(fs)

    def wave():
        return loopfilter_wavefront(*planes, *args)
    wave()
    torch.cuda.synchronize()
    t = time.perf_counter()
    wave()
    torch.cuda.synchronize()
    wave_ms = (time.perf_counter() - t) * 1e3
    out["wavefront"] = summarize_launches(*profile_device(
        wave, warm=False, cpu=False), wave_ms)
    print(json.dumps(out), flush=True)


def phase14_vp9_window(dev, card, lf_key) -> None:
    """The windowed VP9 decoder (models/vp9_tpu.py) at full width on the
    card: the bench stream's first VP9_FRAMES frames against the
    reference's hashes,
    timed with the reference row's split; the checksum path; the
    loop-filter stream against its golden; loopfilter_wavefront against
    the host filter on that stream's keyframe (phase 13's); launches by
    torch.profiler in a child process."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.codecs.vp9.lf_wave import loopfilter_wavefront
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    from ffmpeg_tpu_torch.models.vp9_tpu import Vp9TpuDecoder, checksum
    from ffmpeg_tpu_torch.testing import (VP9_BENCH, VP9_GOLDEN, VP9_LF,
                                          VP9_LF_GOLDEN, plane_sha256)
    t_phase = time.monotonic()
    _par, _tb, pkts = read_ivf(VP9_BENCH.read_bytes())
    data = [p.data for p in pkts]
    gold = np.load(VP9_GOLDEN)["hashes"]
    Vp9TpuDecoder(device=dev).decode(data[:2])      # warm: not in the pass

    # the main path: one window of the first VP9_FRAMES frames
    dec = Vp9TpuDecoder(device=dev)
    st = {}
    zero_counts()
    t = time.perf_counter()
    frames = dec.decode(data[:VP9_FRAMES], emit_planes=True, stats=st)
    wall = time.perf_counter() - t
    counts = read_counts()
    if len(frames) != VP9_FRAMES or st["frames"] != VP9_FRAMES:
        raise RuntimeError(f"the window gave {len(frames)} frames")
    for i, f in enumerate(frames):
        if any(pl.device != dev for pl in f):
            raise RuntimeError(f"frame {i}'s planes are not on the card")
        got = [plane_sha256(pl) for pl in f]
        if got != list(gold[i]):
            bad = [n for n, g, w in zip("yuv", got, gold[i]) if g != w]
            raise RuntimeError(f"window frame {i} differs from the "
                               f"reference's hashes in {bad}")
    n = st["frames"]
    print(f"phase 14 vp9 window [{card}]: the first {VP9_FRAMES} frames of "
          f"1920x1080 through "
          f"Vp9TpuDecoder(device).decode(emit_planes=True) as one window, "
          f"the DPB on the card, every frame's y/u/v equal to the "
          f"reference's sha256 (checked after the window); {counts}; "
          f"full_decode_fps {n / wall:.3f} ({wall * 1e3:.1f} ms for the "
          f"window, wall, after a warm decode of frames 0-1); "
          f"host_parse_ms_per_frame {st['parse_s'] / n * 1e3:.2f}, "
          f"build_ms_per_frame {st['build_s'] / n * 1e3:.2f}, "
          f"device_ms_per_frame {st['device_s'] / n * 1e3:.2f} (the "
          f"host's launches included)", flush=True)
    prof = Child(f"vp9_window_profile({str(dev)!r})", "phase 14's profile")

    # the checksum path on frames 0-2
    sums = Vp9TpuDecoder(device=dev).decode(data[:3])
    want = [int(checksum(y, u)) for y, u, _v in frames[:3]]
    if [int(c) for c in sums] != want:
        raise RuntimeError(f"checksum path {[int(c) for c in sums]} != "
                           f"{want} from the emitted planes")

    # the loop-filter stream through the windowed decoder
    _lpar, _ltb, lpkts = read_ivf(VP9_LF.read_bytes())
    lgold = np.load(VP9_LF_GOLDEN)["lf"]
    lst = {}
    t = time.perf_counter()
    lframes = Vp9TpuDecoder(device=dev).decode([p.data for p in lpkts],
                                               emit_planes=True, stats=lst)
    lf_wall = (time.perf_counter() - t) * 1e3
    if len(lframes) != len(lgold):
        raise RuntimeError(f"lf stream: {len(lframes)} frames")
    for i, f in enumerate(lframes):
        if [plane_sha256(pl) for pl in f] != list(lgold[i]):
            raise RuntimeError(f"lf stream frame {i} differs from its "
                               f"golden (windowed decoder)")

    # the wavefront alone on the loop-filter stream's keyframe
    fs = lf_key["fs"]
    planes = [torch.from_numpy(p).to(dev) for p in lf_key["pre"]]
    args = _wave_args(fs)
    loopfilter_wavefront(*planes, *args)            # warm
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = loopfilter_wavefront(*planes, *args)
    torch.cuda.synchronize()
    wave_ms = (time.perf_counter() - t) * 1e3
    for name, o, a in zip("yuv", out, lf_key["host"]):
        if not (o.device == dev
                and np.array_equal(o.cpu().numpy().astype(np.uint8), a)):
            raise RuntimeError(f"loopfilter_wavefront on the card differs "
                               f"from lf.loopfilter_frame ({name})")
    print(f"phase 14 vp9 window checks [{card}]: the checksum path "
          f"(emit_planes=False) on frames 0-2 equal to the emitted planes' "
          f"checksums; the loop-filter stream ({len(lpkts)} frames "
          f"1920x1080) through the windowed decoder equal to its golden "
          f"in {lf_wall:.1f} ms, wall (parse "
          f"{lst['parse_s'] * 1e3:.1f}, build {lst['build_s'] * 1e3:.1f}, "
          f"device {lst['device_s'] * 1e3:.1f}); loopfilter_wavefront on "
          f"the card equal to lf.loopfilter_frame on its keyframe (level "
          f"{fs.h.filter_level}, sharpness {fs.h.sharpness}): "
          f"{wave_ms:.1f} ms, wall, against the host filter's "
          f"{lf_key['host_ms']:.1f} ms and loopfilter_frame_tpu's "
          f"{lf_key['tpu_ms']:.1f} ms (phase 13)", flush=True)

    prof = prof.result()
    print(f"phase 14 vp9 window profile [{card}]: inter frame 3 as a window "
          f"of one: {prof['inter']}; loopfilter_wavefront on the "
          f"loop-filter keyframe: {prof['wavefront']}", flush=True)
    print(f"phase 14 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)

def _hevc_split(st: dict) -> str:
    """One picture's split from HevcDecoder.stats."""
    h, d = st["host"], st["device"]
    return (f"host parse {h['parse']:.1f} ms, argument build "
            f"{h['build']:.2f}, h2d {h['h2d']:.3f} "
            f"({st['h2d_bytes'] / 1e6:.2f} MB), device "
            f"{sum(d.values()):.2f} (residual {d['residual']:.3f}, inter "
            f"{d['inter']:.3f}, intra levels {d['intra']:.2f}, deblock "
            f"{d['deblock']:.3f}, SAO {d['sao']:.3f}; the host queued it in "
            f"{h['queue']:.2f} and waited {h['wait']:.2f})")


def _hevc_frame_ms(st: dict) -> float:
    """A picture's wall time on the device path: its host stages (the
    parse, the build, the copies, the launches) and the wait for the
    device."""
    return sum(st["host"].values())


def hevc_profile(walls: list, device_ms: list, device: str = "cuda:0"):
    """Phase 15's torch.profiler sessions, in a process of their own (see
    audio_profile): after a warm decode of the small crafted stream, a
    fresh decoder's bench keyframe and first P frame, each profiled
    alone, the host's CABAC parse included.  Prints one JSON line of
    summarize_launches' descriptions against the pictures' wall times
    in the main pass (`walls`), with the device's busy time as a share
    of each picture's device stage there (`device_ms`)."""
    sys.path.insert(0, str(REPO))
    import torch
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.core.packet import Packet
    from ffmpeg_tpu_torch.io.stream import CodecParameters
    from ffmpeg_tpu_torch.testing import (HEVC_BENCH, HEVC_SMALL,
                                          hevc_decode, hevc_pictures)
    dev = torch.device(device)
    hevc_decode(HEVC_SMALL.read_bytes(), dev)
    pics = hevc_pictures(HEVC_BENCH.read_bytes())
    dec = CodecContext.open_decoder(CodecParameters(codec_id="hevc"),
                                    device=dev).codec
    out = {}
    for name, p, ms, dms in zip(("keyframe", "p"), pics, walls, device_ms):
        device, api = profile_device(lambda p=p: dec.decode(Packet(data=p)),
                                     warm=False, cpu=False)
        busy = sum(us for _, us in device) / 1e3
        out[name] = (f"{summarize_launches(device, api, ms)}; busy "
                     f"{busy / dms:.1%} of its device stage ({dms:.2f} ms)")
    print(json.dumps(out), flush=True)


def _hevc_open(dev):
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.io.stream import CodecParameters
    ctx = CodecContext.open_decoder(CodecParameters(codec_id="hevc"),
                                    device=dev)
    ctx.codec.stats, ctx.codec.capture = [], []
    return ctx


def _hevc_check(frames, gold, dev, what):
    from ffmpeg_tpu_torch.testing import plane_sha256
    if len(frames) != len(gold):
        raise RuntimeError(f"{what}: {len(frames)} frames, not {len(gold)}")
    for i, f in enumerate(frames):
        if (f.width, f.height) != (1920, 1080) or any(
                pl.device != dev for pl in f.planes):
            where = [str(p.device) for p in f.planes]
            raise RuntimeError(f"{what} frame {i}: {f.width}x{f.height}, "
                               f"planes on {where}")
        got = [plane_sha256(pl) for pl in f.planes]
        if got != list(gold[i]):
            bad = [n for n, g, w in zip("yuv", got, gold[i]) if g != w]
            raise RuntimeError(f"{what} frame {i} differs from the "
                               f"reference's hashes in {bad}")


def phase15_hevc(dev, card) -> dict:
    """The HEVC decoder at full width on the card: the 3-frame bench
    stream through open_decoder("hevc") against the reference's hashes,
    timed with each picture's split into host parse and device; the
    device replay of its 3 recorded pictures (benchrows.recon_row_hevc's
    device_recon_fps); the crafted SAO + deblock stream against its
    golden, and filters_tpu on its keyframe against the host filter.py,
    timed; launches by torch.profiler in a child process.  Returns that
    keyframe for phase 31: its FrameDec, its pre-filter planes on the
    card, filters_tpu's planes and time."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.codecs.hevc import filter as host_filter
    from ffmpeg_tpu_torch.codecs.hevc import recon_tpu
    from ffmpeg_tpu_torch.core.packet import Packet
    from ffmpeg_tpu_torch.testing import (HEVC_BENCH, HEVC_GOLDEN, HEVC_SAO,
                                          HEVC_SMALL, hevc_decode,
                                          hevc_pictures)
    from ffmpeg_tpu_torch.timing import cuda_ms
    t_phase = time.monotonic()
    gold = np.load(HEVC_GOLDEN)
    hevc_decode(HEVC_SMALL.read_bytes(), dev)      # warm: not in the pass

    # the main path: the bench stream's 3 pictures, one packet each
    pics = hevc_pictures(HEVC_BENCH.read_bytes())
    ctx = _hevc_open(dev)
    zero_counts()
    t = time.perf_counter()
    frames = ctx.decode_all([Packet(data=p, pts=i)
                             for i, p in enumerate(pics)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    _hevc_check(frames, gold["bench"], dev, "bench stream")
    stats = ctx.codec.stats
    if [s["slice_type"] for s in stats] != [2, 1, 1]:
        raise RuntimeError(f"expected I P P, got slice types "
                           f"{[s['slice_type'] for s in stats]}")
    parse = [s["host"]["parse"] for s in stats]
    devms = [sum(s["device"].values()) for s in stats]
    print(f"phase 15 hevc decode [{card}]: 3 pictures of 1920x1080 "
          f"through open_decoder('hevc') on the card (CABAC parse on the "
          f"host, reconstruction and filters on the card, the DPB on the "
          f"card), every picture's y/u/v equal to the reference's sha256; "
          f"{counts}; full decode {3 / wall:.3f} frames/s ({wall * 1e3:.1f} "
          f"ms, wall, after a warm decode of the small crafted stream): "
          f"host parse {sum(parse) / 3:.1f} ms/frame, device "
          f"{sum(devms) / 3:.1f} ms/frame; keyframe "
          f"({stats[0]['levels']} intra levels) {_hevc_split(stats[0])}; P "
          f"frame 1 ({stats[1]['levels']} levels) {_hevc_split(stats[1])}; "
          f"P frame 2 ({stats[2]['levels']} levels) "
          f"{_hevc_split(stats[2])}", flush=True)
    walls = [_hevc_frame_ms(st) for st in stats[:2]]
    prof = Child(f"hevc_profile({walls!r}, {devms[:2]!r}, {str(dev)!r})",
                 "phase 15's profile")

    # the device replay of the recorded pictures, references staged
    # (benchrows.recon_row_hevc): the DPB's tensors are on the card
    prepared = [recon_tpu.prepare(d, r, dev) for d, r in ctx.codec.capture]

    def replay():
        return [fn(a) for fn, a in prepared]
    for i, planes in enumerate(replay()):
        # deblock and SAO are off in this stream: the reconstruction is
        # the picture
        if not all(torch.equal(p.to(torch.uint8), q)
                   for p, q in zip(planes, frames[i].planes)):
            raise RuntimeError(f"replay of picture {i} differs from the "
                               f"decoded picture")
    replay_ms = cuda_ms(replay, 2)
    print(f"phase 15 hevc replay [{card}]: device_recon_fps "
          f"{3e3 / replay_ms:.3f} ({replay_ms:.1f} ms per replay of the 3 "
          f"recorded pictures, CUDA events, mean of 2 after a warm one; "
          f"equal to the decoded pictures)", flush=True)

    # the crafted SAO + deblock stream, and filters_tpu on its keyframe
    sctx = _hevc_open(dev)
    t = time.perf_counter()
    spics = hevc_pictures(HEVC_SAO.read_bytes())
    sframes = sctx.decode_all([Packet(data=p, pts=i)
                               for i, p in enumerate(spics)])
    torch.cuda.synchronize()
    swall = (time.perf_counter() - t) * 1e3
    _hevc_check(sframes, gold["sao_deblock"], dev, "SAO + deblock stream")
    sst = sctx.codec.stats
    key = hevc_sao_keyframe(dev, *sctx.codec.capture[0])
    dec0, pre, out, filt_ms = (key[k] for k in ("dec", "pre", "out",
                                                "filt_ms"))
    dec0.y[:], dec0.u[:], dec0.v[:] = (p.cpu().numpy() for p in pre)
    t = time.perf_counter()
    host_filter.deblock_frame(dec0)
    host_filter.sao_frame(dec0)
    host_ms = (time.perf_counter() - t) * 1e3
    for name, o, a, f in zip("yuv", out, (dec0.y, dec0.u, dec0.v),
                             sframes[0].planes):
        if not (np.array_equal(o.cpu().numpy(), a) and torch.equal(o, f)):
            raise RuntimeError(f"filters_tpu on the card differs from the "
                               f"host filter.py ({name})")
    print(f"phase 15 hevc filters [{card}]: the crafted SAO + deblock "
          f"stream (IDR + P, 1920x1080) equal to its golden in "
          f"{swall:.1f} ms, wall (keyframe {_hevc_split(sst[0])}; P frame "
          f"{_hevc_split(sst[1])}); filters_tpu on the card equal to the "
          f"host deblock_frame + sao_frame on its keyframe: {filt_ms:.3f} "
          f"ms (CUDA events, mean of 3) against {host_ms:.1f} ms on the "
          f"host", flush=True)

    prof = prof.result()
    print(f"phase 15 hevc profile [{card}]: keyframe: {prof['keyframe']}; "
          f"P frame 1: {prof['p']}", flush=True)
    print(f"phase 15 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)
    return key


def hevc_sao_keyframe(dev, dec, rec) -> dict:
    """The SAO + deblock stream's keyframe as phases 15 and 31 take it,
    from the decoder's capture (dec, rec): its FrameDec, its pre-filter
    planes reconstructed on the card, filters_tpu's planes and ms (CUDA
    events, mean of 3)."""
    from ffmpeg_tpu_torch.codecs.hevc import filter_tpu, recon_tpu
    from ffmpeg_tpu_torch.timing import cuda_ms
    pre = recon_tpu.reconstruct(dec, rec, dev)
    filt_ms = cuda_ms(lambda: filter_tpu.filters_tpu(dec, *pre), 3)
    return {"dec": dec, "pre": pre, "out": filter_tpu.filters_tpu(dec, *pre),
            "filt_ms": filt_ms}


def _h264_split(st: dict) -> str:
    """One picture's split from H264Decoder.stats."""
    h, d = st["host"], st["device"]
    return (f"host parse {h['parse']:.1f} ms, argument build "
            f"{h['build']:.2f} + deblock_params "
            f"{h.get('deblock_build', 0.0):.2f}, "
            f"h2d {h['h2d']:.3f} ({st['h2d_bytes'] / 1e6:.2f} MB), device "
            f"{sum(d.values()):.2f} (residual {d['residual']:.3f}, inter "
            f"{d['inter']:.3f}, intra wavefront {d['intra']:.2f} over "
            f"{st['intra_steps']} steps, deblock wavefront "
            f"{d.get('deblock', 0.0):.2f} over {st['deblock_steps']} steps; "
            f"the host queued it in {h['queue']:.2f} and waited "
            f"{h['wait']:.2f})")


def h264_profile(walls: list, device_ms: list, device: str = "cuda:0"):
    """Phase 16's torch.profiler sessions, in a process of their own (see
    audio_profile): after a warm decode of the small crafted stream, a
    fresh decoder's 1080p I picture and P picture, each one packet and
    profiled alone, the host's CABAC parse included.  Prints one JSON
    line of summarize_launches' descriptions against the pictures' wall
    times in the main pass (`walls`), with the device's busy time as a
    share of each picture's device stage there (`device_ms`)."""
    sys.path.insert(0, str(REPO))
    import torch
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.core.packet import Packet
    from ffmpeg_tpu_torch.io.stream import CodecParameters
    from ffmpeg_tpu_torch.testing import (H264_CABAC, H264_SMALL,
                                          h264_decode, h264_pictures)
    dev = torch.device(device)
    h264_decode(H264_SMALL.read_bytes(), dev)
    pics = h264_pictures(H264_CABAC.read_bytes())
    dec = CodecContext.open_decoder(CodecParameters(codec_id="h264"),
                                    device=dev).codec
    out = {}
    for name, p, ms, dms in zip(("i", "p"), pics, walls, device_ms):
        device, api = profile_device(lambda p=p: dec.decode(Packet(data=p)),
                                     warm=False, cpu=False)
        busy = sum(us for _, us in device) / 1e3
        out[name] = (f"{summarize_launches(device, api, ms)}; busy "
                     f"{busy / dms:.1%} of its device stage ({dms:.2f} ms)")
    print(json.dumps(out), flush=True)


def _h264_check(frames, gold, dev, what, size):
    """Every frame's planes on `dev`, `size`, and equal to the golden's
    sha256; raises at the first mismatch."""
    from ffmpeg_tpu_torch.testing import plane_sha256
    if len(frames) != len(gold):
        raise RuntimeError(f"{what}: {len(frames)} frames, not {len(gold)}")
    for i, f in enumerate(frames):
        if (f.width, f.height) != size or any(
                pl.device != dev for pl in f.planes):
            where = [str(p.device) for p in f.planes]
            raise RuntimeError(f"{what} frame {i}: {f.width}x{f.height}, "
                               f"planes on {where}")
        for n, pl, want in zip("yuv", f.planes, gold[i]):
            if plane_sha256(pl) != want:
                raise RuntimeError(f"{what} frame {i} plane {n} differs "
                                   f"from the reference's hash")


def phase16_h264(dev, card) -> None:
    """The H.264 decoder at full width on the card: the crafted 1920x1088
    I P B CABAC stream (deblocking on) as one packet through
    open_decoder("h264") against the reference's hashes, timed with
    each picture's split into host parse, argument build, h2d and the
    device stages; the truncated-slice stream (concealment) against its
    golden; launches by torch.profiler in a child process."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.testing import (H264_CABAC, H264_GOLDEN,
                                          H264_SMALL, h264_decode)
    t_phase = time.monotonic()
    gold = np.load(H264_GOLDEN)
    zero_counts()
    _h264_check(h264_decode(H264_SMALL.read_bytes(), dev), gold["small"],
                dev, "small crafted stream", (64, 48))   # warm

    # the main path: the 3 pictures of the 1080p stream, one packet
    stats = []
    t = time.perf_counter()
    frames = h264_decode(H264_CABAC.read_bytes(), dev, None, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    _h264_check(frames, gold["cabac_1080p"], dev, "1080p CABAC stream",
                (1920, 1088))
    if [s["slice_type"] for s in stats] != [2, 0, 1]:
        raise RuntimeError(f"expected I P B, got slice types "
                           f"{[s['slice_type'] for s in stats]}")
    parse = [s["host"]["parse"] for s in stats]
    devms = [sum(s["device"].values()) for s in stats]
    print(f"phase 16 h264 decode [{card}]: 3 pictures of 1920x1088 (no "
          f"cropping in the crafted stream) through open_decoder('h264') "
          f"on the card (CABAC parse on the host, reconstruction and the "
          f"intra and deblock wavefronts on the card, the DPB on the "
          f"card), every picture's y/u/v equal to the reference's sha256; "
          f"full decode {3 / wall:.3f} frames/s ({wall * 1e3:.1f} ms, wall, "
          f"after a warm decode of the small crafted stream): host parse "
          f"{sum(parse) / 3:.1f} ms/frame, device {sum(devms) / 3:.1f} "
          f"ms/frame; I picture {_h264_split(stats[0])}; P picture "
          f"{_h264_split(stats[1])}; B picture {_h264_split(stats[2])}",
          flush=True)

    # the truncated-slice stream: concealment on host copies
    tstats = []
    t = time.perf_counter()
    tframes = h264_decode(gold["truncated_stream"].tobytes(), dev, None,
                          tstats)
    torch.cuda.synchronize()
    twall = (time.perf_counter() - t) * 1e3
    _h264_check(tframes, gold["truncated"], dev, "truncated-slice stream",
                (64, 48))
    dmg = [s for s in tstats if s["damaged"]]
    if len(dmg) != 1 or "conceal_d2h_bytes" not in dmg[0]:
        raise RuntimeError(f"expected one concealed picture, got "
                           f"{[s['damaged'] for s in tstats]}")
    print(f"phase 16 h264 concealment [{card}]: the truncated-slice stream "
          f"(an I_16x16 IDR and a P picture cut to 60%, 64x48) equal to the "
          f"reference's default decode in {twall:.1f} ms, wall; the damaged "
          f"picture's planes and reference went to the host "
          f"({dmg[0]['conceal_d2h_bytes']} B) and back "
          f"({dmg[0]['conceal_h2d_bytes']} B) around conceal_missing",
          flush=True)

    walls = [sum(st["host"].values()) for st in stats[:2]]
    prof = Child(f"h264_profile({walls!r}, {devms[:2]!r}, {str(dev)!r})",
                 "phase 16's profile").result()
    print(f"phase 16 h264 profile [{card}]: I picture: {prof['i']}; P "
          f"picture: {prof['p']}; {read_counts()} over the phase",
          flush=True)
    print(f"phase 16 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)



def _enc_split(st: dict) -> str:
    """One frame's split from H264Encoder.stats."""
    if st["type"] == "I":
        return (f"{st['wall']:.1f} ms (host macroblock loop "
                f"{st['mb_loop']:.1f})")
    return (f"{st['wall']:.1f} ms (host macroblock loop {st['mb_loop']:.1f}, "
            f"subpel refinement {st['subpel']:.1f}; motion search h2d "
            f"{st['h2d']:.3f}, K2 + argmin {st['search']:.3f}, d2h "
            f"{st['d2h']:.3f})")


def h264_encode(device: str = "cuda:0") -> None:
    """Phase 17's encode, in a process of its own that main() starts
    before phase 13 (Child), so that the host macroblock loop runs beside
    phases 13-16: the clip's first H264_ENC_FRAMES frames through
    open_encoder("h264") with its defaults on `device`, K2's launches
    counted from 0.  Prints one JSON line: the packets (hex), the
    encode's seconds, each frame's stats and K2's launches."""
    sys.path.insert(0, str(REPO))
    import torch
    from ffmpeg_tpu_torch.codecs import CodecContext, EncoderParameters
    from ffmpeg_tpu_torch.ops import me
    from ffmpeg_tpu_torch.testing import (H264_ENC_FRAMES, RT_FRAMES,
                                          mpeg2_clip)
    dev = torch.device(device)
    clip = mpeg2_clip(RT_FRAMES, ENC_W, ENC_H)
    # the process's first CUDA work (its context, K2's library, the
    # first launches of K2 and of the argmin's kernels), outside the
    # frames' split
    plane = torch.zeros((ENC_H + 8, ENC_W), dtype=torch.uint8, device=dev)
    me.motion_search(plane, plane, block=16, search=8)[0].cpu()
    zero_counts()
    ctx = CodecContext.open_encoder(EncoderParameters("h264", ENC_W, ENC_H),
                                    device=dev)
    ctx.codec.stats = []
    pkts = []
    t = time.perf_counter()
    for f in clip[:H264_ENC_FRAMES]:
        ctx.send_frame(f)
        pkts.append(ctx.receive_packet().data)
    secs = time.perf_counter() - t
    print(json.dumps({"packets": [p.hex() for p in pkts], "seconds": secs,
                      "stats": ctx.codec.stats, "k2": me.KERNEL_LAUNCHES},
                     default=float), flush=True)


def phase17_h264_encode(dev, card, encode: Child):
    """The H.264 encoder at 1920x1080 on the card: the clip's first 2
    frames (I, P) through open_encoder("h264") with its defaults, K2 once
    for the P frame, both packets equal to the reference's sha256 (the
    encode runs in `encode`, h264_encode's process, beside phases 13-16);
    then both packets through open_decoder("h264") on the card, the
    cropped 1920x1080 planes equal to the sha256 of the reference's
    decode.  Returns the 8-frame clip (for phase 19) and K2's launches."""
    import hashlib
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.ops import me
    from ffmpeg_tpu_torch.testing import (H264_ENC_FRAMES, ROUNDTRIP_GOLDEN,
                                          RT_FRAMES, clip_checksum,
                                          h264_decode, mpeg2_clip)
    t_phase = time.monotonic()
    g = np.load(ROUNDTRIP_GOLDEN)
    clip = mpeg2_clip(RT_FRAMES, ENC_W, ENC_H)
    if clip_checksum(clip) != str(g["clip_sha256"]):
        raise RuntimeError("the seeded clip differs from the golden's")

    # the main path: encode I then P (in the child), then decode both
    enc = encode.result()
    pkts = [bytes.fromhex(h) for h in enc["packets"]]
    enc_s, enc_launches, st = enc["seconds"], enc["k2"], enc["stats"]
    sha = [hashlib.sha256(p).hexdigest() for p in pkts]
    if sha != g["h264_packet_sha256"].tolist():
        raise RuntimeError(f"H.264 packets {[len(p) for p in pkts]} B differ "
                           f"from the reference's "
                           f"{g['h264_packet_bytes'].tolist()} B")
    if enc_launches != 1:
        raise RuntimeError(f"K2 launched {enc_launches} times for one P "
                           f"frame")
    print(f"phase 17 h264 encode [{card}]: 1920x1080 I P through "
          f"open_encoder('h264') on the card (qp 26, me_range 8, subpel 2) "
          f"in a process beside phases 13-16, packets "
          f"{[len(p) for p in pkts]} B equal to the reference's "
          f"sha256; K2 launches {enc_launches}; {enc_s:.1f} s, "
          f"{H264_ENC_FRAMES / enc_s:.4f} frames/s; I frame "
          f"{_enc_split(st[0])}; P frame {_enc_split(st[1])}", flush=True)

    zero_counts()
    stats = []
    data = b"".join(pkts)
    t = time.perf_counter()
    frames = h264_decode(data, dev, None, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = enc_launches + me.KERNEL_LAUNCHES
    _h264_check(frames, g["h264_plane_sha256"], dev,
                "the encoder's 1080p stream", (1920, 1080))
    print(f"phase 17 h264 decode [{card}]: the encoder's 2 packets (CAVLC, "
          f"deblocking off, SPS crop to 1080 rows) through "
          f"open_decoder('h264') on the card, every cropped 1920x1080 "
          f"plane equal to the reference's sha256; full decode "
          f"{2 / wall:.3f} frames/s ({wall * 1e3:.1f} ms, wall, no warm "
          f"decode: phase 16 ran the decoder); I picture "
          f"{_h264_split(stats[0])}; P picture {_h264_split(stats[1])}; "
          f"{read_counts()} over the decode", flush=True)
    print(f"phase 17 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)
    return clip, launches


def _mpeg2_split(st: dict) -> str:
    """One picture's split from Mpeg12Decoder.stats."""
    h, d = st["host"], st["device"]
    return (f"{st['type']}: host parse {h['parse']:.1f} ms, queue "
            f"{h['queue']:.2f}, h2d {d['h2d']:.3f} ms "
            f"({st['h2d_bytes'] / 1e6:.2f} MB), device residual "
            f"{d['residual']:.3f}, MC {d.get('mc', 0.0):.3f}")


def phase18_mpeg2_decode(dev, card, pkts, oracle) -> None:
    """The MPEG-1/2 decoder on the card: phase 7's own 1920x1080 I P P P
    packets through open_decoder("mpeg2video"), against the port's CPU
    decode of the same packets (I pictures within 1 LSB on <= 1% of
    samples, every picture >= 60 dB), and each frame's PSNR against the
    source within 0.1 dB of the reference decoder's PSNR on the
    reference's packets (committed).  The CPU decode is `oracle`'s, a
    CpuOracle started after phase 7."""
    import types
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.codecs import CodecContext, EncoderParameters
    from ffmpeg_tpu_torch.core.packet import Packet
    from ffmpeg_tpu_torch.io.stream import CodecParameters
    from ffmpeg_tpu_torch.testing import (ENC_FRAMES, ROUNDTRIP_GOLDEN,
                                          mpeg2_clip, recon_psnr)
    t_phase = time.monotonic()
    g = np.load(ROUNDTRIP_GOLDEN)
    src = mpeg2_clip(ENC_FRAMES, ENC_W, ENC_H)

    def decode(device, stats=None):
        dec = CodecContext.open_decoder(
            CodecParameters(codec_id="mpeg2video"), device=device)
        dec.codec.stats = stats
        return dec.decode_all([Packet(data=p, pts=i)
                               for i, p in enumerate(pkts)])

    small = CodecContext.open_encoder(EncoderParameters("mpeg2video", 64,
                                                        48),
                                      {"qscale": 6}, device="cpu")
    warm = []
    for f in mpeg2_clip(2, 64, 48):
        small.send_frame(f)
        warm.append(Packet(data=small.receive_packet().data))
    CodecContext.open_decoder(CodecParameters(codec_id="mpeg2video"),
                              device=dev).decode_all(warm)

    zero_counts()
    stats = []
    t = time.perf_counter()
    got = decode(dev, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = read_counts()
    want = [types.SimpleNamespace(planes=[torch.from_numpy(p) for p in f])
            for f in oracle.planes()]
    if [f.pict_type for f in got] != ["I", "P", "P", "P"]:
        raise RuntimeError(f"expected I P P P, got "
                           f"{[f.pict_type for f in got]}")
    worst, dmax = check_pictures(got, want, dev, "mpeg2 decode")
    notes = [f"{f.pict_type} {m}" for f, m in zip(got, dmax)]
    psnr = [recon_psnr([p.cpu().numpy() for p in f.planes], s)
            for f, s in zip(got, src)]
    dpsnr = [a - float(b) for a, b in zip(psnr, g["mpeg2_psnr"])]
    if max(map(abs, dpsnr)) > 0.1:
        raise RuntimeError(f"PSNR {psnr} differs from the reference's "
                           f"{g['mpeg2_psnr'].tolist()} by more than 0.1 dB")
    parse = sum(s["host"]["parse"] for s in stats)
    print(f"phase 18 mpeg2 decode [{card}]: phase 7's 1920x1080 I P P P "
          f"packets through open_decoder('mpeg2video') on the card (host "
          f"parse, IDCT and MC on the card, the reference pictures on the "
          f"card); against the CPU decode: max |diff| per picture "
          f"{', '.join(notes)}, worst PSNR {worst:.2f} dB; PSNR against "
          f"the source {[round(x, 4) for x in psnr]} dB, the reference's "
          f"{[round(float(x), 4) for x in g['mpeg2_psnr']]} (diff "
          f"{[f'{x:+.4f}' for x in dpsnr]}); {4 / wall:.3f} frames/s "
          f"({wall * 1e3:.1f} ms, wall, after a warm decode at 64x48; host "
          f"parse {parse / 4:.1f} ms/frame); "
          + "; ".join(_mpeg2_split(s) for s in stats)
          + f"; {counts}", flush=True)
    print(f"phase 18 wall time: {time.monotonic() - t_phase:.1f} s "
          f"(of it {oracle.waited:.1f} s waiting for the CPU decode's "
          f"child)", flush=True)


def phase19_mjpeg_encode(dev, card, clip) -> int:
    """The MJPEG encoder on the card: 8 frames of the 1920x1080 clip
    through open_encoder("mjpeg") with the flagship's options; the
    coefficients within one quantiser step of the port's CPU transform on
    <= 1e-3 of positions; packet sizes within 0.1% of the reference's;
    the packets through the flagship pipeline (K1) as one batch, each
    frame's 224x224 rgb24 PSNR against the source's scale within 0.05 dB
    of the reference's decode of its own packets.  Returns K1's
    launches."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.codecs import CodecContext, EncoderParameters
    from ffmpeg_tpu_torch.ops import huffman
    from ffmpeg_tpu_torch.testing import (MJPEG_ENC_OPTIONS,
                                          ROUNDTRIP_GOLDEN,
                                          mjpeg_pipeline_rgb,
                                          mjpeg_target_rgb, rgb_psnr)
    t_phase = time.monotonic()
    g = np.load(ROUNDTRIP_GOLDEN)
    par = EncoderParameters("mjpeg", ENC_W, ENC_H)
    ctx = CodecContext.open_encoder(par, dict(MJPEG_ENC_OPTIONS),
                                    device=dev)
    ctx.codec.transform(clip[0])                 # warm

    zero_counts()
    ctx.codec.stats = []
    pkts = []
    t = time.perf_counter()
    for f in clip:
        ctx.send_frame(f)
        pkts.append(ctx.receive_packet().data)
    enc_s = time.perf_counter() - t
    rgb = mjpeg_pipeline_rgb(pkts, dev)
    torch.cuda.synchronize()
    launches = huffman.KERNEL_LAUNCHES
    counts = read_counts()
    if launches < 1:
        raise RuntimeError("K1 not launched by the pipeline")

    sizes = [len(p) for p in pkts]
    rel = [a / int(b) - 1 for a, b in zip(sizes, g["mjpeg_packet_bytes"])]
    if max(map(abs, rel)) > 1e-3:
        raise RuntimeError(f"MJPEG packets {sizes} B not within 0.1% of "
                           f"the reference's "
                           f"{g['mjpeg_packet_bytes'].tolist()}")
    cpu = CodecContext.open_encoder(par, dict(MJPEG_ENC_OPTIONS),
                                    device="cpu").codec
    worst = 0.0
    for f in clip:
        for a, b in zip(ctx.codec.transform(f)[0], cpu.transform(f)[0]):
            d = np.abs(a.astype(np.int64) - b)
            worst = max(worst, float((d > 0).mean()))
            if d.max() > 1 or (d > 0).mean() > 1e-3:
                raise RuntimeError(f"coefficients: max |diff| {d.max()} on "
                                   f"{(d > 0).mean():.4%} of positions")
    psnr = rgb_psnr(rgb, mjpeg_target_rgb(clip, dev))
    dpsnr = [a - float(b) for a, b in zip(psnr, g["mjpeg_psnr"])]
    if max(map(abs, dpsnr)) > 0.05:
        raise RuntimeError(f"PSNR {psnr} not within 0.05 dB of the "
                           f"reference's {g['mjpeg_psnr'].tolist()}")
    st = ctx.codec.stats
    tr = sum(s["transform"] for s in st) / len(st)
    pk = sum(s["pack"] for s in st) / len(st)
    print(f"phase 19 mjpeg encode [{card}]: {len(clip)} frames of 1920x1080 "
          f"through open_encoder('mjpeg') on the card (quality 88, "
          f"restart_interval 1, optimal tables <= 8 bits): "
          f"{len(clip) / enc_s:.3f} frames/s ({enc_s * 1e3 / len(clip):.1f} ms/frame: device "
          f"transform with its copies {tr:.2f}, host packing {pk:.1f}); "
          f"packets {sizes} B (rel to the reference "
          f"{[f'{x:+.5%}' for x in rel]}); coefficients within one step of "
          f"the CPU transform, at most {worst:.6%} of positions differing; "
          f"decoded by the flagship pipeline (K1) as one batch: PSNR "
          f"{[round(x, 4) for x in psnr]} dB against the source's 224x224 "
          f"scale (diff to the reference's {[f'{x:+.4f}' for x in dpsnr]});"
          f" {counts}", flush=True)
    print(f"phase 19 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)
    return launches


def phase_intra(dev, card, codec: str, number: int) -> None:
    """Phases 20 (ProRes) and 21 (DNxHR HQX): the golden's 1920x1080
    10-bit 4:2:2 frame through open_encoder(codec) on the card at qscale
    4, its levels against the port's transform on the CPU (within one
    step, each difference on a tie or boundary that float32 cannot
    decide), the packet's size within 0.1% of the reference's (sha256
    reported); the packet through open_decoder(codec) on the card, the
    device stage against the same parse's device stage on the CPU (the
    decoder bar), each plane's PSNR against the source within 0.05 dB of
    the reference's decode of its own packet."""
    import hashlib
    import importlib
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.io.stream import CodecParameters
    from ffmpeg_tpu_torch.testing import (INTRA_GOLDEN, INTRA_QSCALE,
                                          clip_checksum, intra_clip_frame,
                                          intra_levels_check, plane_psnr)
    t_phase = time.monotonic()
    g = np.load(INTRA_GOLDEN)
    src = intra_clip_frame(ENC_W, ENC_H)
    if clip_checksum([src]) != str(g["clip_sha256"]):
        raise RuntimeError("the seeded frame differs from the golden's")
    mod = importlib.import_module(f"ffmpeg_tpu_torch.codecs.{codec}")

    def round_trip(frame, w, h, device, stats=False):
        par = CodecParameters(codec_id=codec, width=w, height=h,
                              pix_fmt="yuv422p10le")
        enc = CodecContext.open_encoder(par, {"qscale": INTRA_QSCALE},
                                        device=device)
        dec = CodecContext.open_decoder(CodecParameters(
            codec_id=codec, codec_tag=par.codec_tag), device=device)
        if stats:
            enc.codec.stats, dec.codec.stats = [], []
        t = time.perf_counter()
        enc.send_frame(frame)
        pkt = enc.receive_packet()
        t_enc = time.perf_counter() - t
        t = time.perf_counter()
        out = dec.decode_all([pkt])[0]
        torch.cuda.synchronize()
        return enc, dec, pkt.data, out, t_enc, time.perf_counter() - t

    round_trip(intra_clip_frame(64, 48), 64, 48, dev)          # warm
    zero_counts()
    enc, dec, pkt, out, enc_s, dec_s = round_trip(src, ENC_W, ENC_H, dev,
                                                  stats=True)
    counts = read_counts()
    if any(p.device != dev for p in out.planes):
        raise RuntimeError("decoded planes not on the card")

    cpu = CodecContext.open_encoder(CodecParameters(
        codec_id=codec, width=ENC_W, height=ENC_H, pix_fmt="yuv422p10le"),
        {"qscale": INTRA_QSCALE}, device="cpu")
    lv = intra_levels_check(enc.codec, cpu.codec, src)
    if lv["step"] > 1 or lv["off"]:
        raise RuntimeError(f"levels against the CPU transform: {lv}")
    rel = len(pkt) / int(g[f"{codec}_packet_bytes"]) - 1
    if abs(rel) > 1e-3:
        raise RuntimeError(f"packet {len(pkt)} B not within 0.1% of the "
                           f"reference's {int(g[f'{codec}_packet_bytes'])}")
    same = hashlib.sha256(pkt).hexdigest() == str(g[f"{codec}_packet_sha256"])
    note = "; ".join(
        check_close(a.cpu().numpy(), b.cpu().numpy(), f"{codec} decode "
                    f"against the CPU's device stage", bits=10)
        for a, b in zip(out.planes, mod.reconstruct(dec.codec.last_parsed,
                                                    "cpu")))
    psnr = plane_psnr(out.planes, src.planes, 10)
    dpsnr = [a - float(b) for a, b in zip(psnr, g[f"{codec}_psnr"])]
    if max(map(abs, dpsnr)) > 0.05:
        raise RuntimeError(f"PSNR {psnr} not within 0.05 dB of the "
                           f"reference's {g[f'{codec}_psnr'].tolist()}")
    es, ds = enc.codec.stats[0], dec.codec.stats[0]
    name = {"prores": "ProRes 4:2:2 10-bit",
            "dnxhd": "DNxHR HQX (CID 1271)"}[codec]
    print(f"phase {number} {codec} round trip [{card}]: {name} at "
          f"1920x1080, qscale {INTRA_QSCALE}, through open_encoder/"
          f"open_decoder('{codec}') on the card; levels against the CPU "
          f"transform: {lv['diff']} of {lv['levels']} differ by one step, "
          f"each on a tie or boundary float32 cannot decide (worst at "
          f"{lv['worst']:.3g} of its bound); packet {len(pkt)} B "
          f"({rel:+.5%} of the reference's, sha256 "
          f"{'equal' if same else 'differs'}); decode against the CPU's "
          f"device stage on the same parse (per plane: {note}); PSNR "
          f"against the source {[round(x, 4) for x in psnr]} dB (diff to "
          f"the reference's {[f'{x:+.4f}' for x in dpsnr]}); "
          f"encode {1 / enc_s:.3f} frames/s ({enc_s * 1e3:.1f} ms: device "
          f"transform with its copies {es['transform']:.2f}, host packing "
          f"{es['pack']:.1f}); decode {1 / dec_s:.3f} frames/s "
          f"({dec_s * 1e3:.1f} ms: host parse {ds['host']['parse']:.1f}, "
          f"h2d {ds['device']['h2d']:.3f} ms "
          f"({ds['h2d_bytes'] / 1e6:.2f} MB), device transform "
          f"{ds['device']['transform']:.3f}); {counts}", flush=True)
    print(f"phase {number} wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)


def phase22_mpeg4(dev, card) -> None:
    """The MPEG-4 and H.263 decoders on the card: the three committed
    streams (tests/data/port/mpeg4_streams.npz, CIF and below) through
    open_decoder on the card against the port's CPU decode (I pictures
    within 1 LSB on <= 1% of samples, every picture >= 60 dB), each
    frame's sha256 against the reference's reported."""
    import torch
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.core.packet import Packet
    from ffmpeg_tpu_torch.io.stream import CodecParameters
    from ffmpeg_tpu_torch.testing import (MPEG4_STREAM_NAMES, mpeg4_stream,
                                          plane_sha256)
    t_phase = time.monotonic()

    def decode(st, device, stats=None, n=None):
        dec = CodecContext.open_decoder(CodecParameters(
            codec_id=st["codec_id"], extradata=st["extradata"]),
            device=device)
        dec.codec.stats = stats
        return dec.decode_all([Packet(data=p, pts=t) for p, t in
                               zip(st["packets"][:n], st["pts"])])

    decode(mpeg4_stream(MPEG4_STREAM_NAMES[0]), dev, n=2)     # warm
    for name in MPEG4_STREAM_NAMES:
        st = mpeg4_stream(name)
        codec_id, w, h = st["codec_id"], st["width"], st["height"]
        zero_counts()
        stats = []
        t = time.perf_counter()
        got = decode(st, dev, stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = read_counts()
        want = decode(st, "cpu")
        if [f.pict_type for f in got] != st["types"]:
            raise RuntimeError(f"{name}: picture types differ")
        worst, dmax = check_pictures(got, want, dev, name)
        sha = [[plane_sha256(p) for p in f.planes] for f in got]
        equal = sum(a == b for a, b in zip(sha, st["sha256"]))
        parse = sum(s["host"]["parse"] for s in stats)
        mc = sum(s["host"]["mc"] for s in stats)
        idct = sum(s["device"].get("idct", 0.0) for s in stats)
        h2d = sum(s["h2d_bytes"] for s in stats)
        print(f"phase 22 {name} [{card}]: {codec_id} {w}x{h}, {len(got)} "
              f"pictures ({''.join(f.pict_type for f in got)}) through "
              f"open_decoder('{codec_id}') on the card; against the CPU "
              f"decode: max |diff| {max(dmax)}, worst PSNR {worst:.2f} dB; "
              f"{equal} of {len(got)} frames equal to the reference's "
              f"sha256; {len(got) / wall:.2f} frames/s ({wall * 1e3:.1f} "
              f"ms, wall): host parse {parse:.1f} ms, IDCT on the card "
              f"{idct:.3f} ms with its copies ({h2d / 1e6:.3f} MB up), host "
              f"MC and reconstruction {mc:.1f} ms; {counts}", flush=True)
    print(f"phase 22 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)

# phase 23: each decoder's filterbank on the card against its CPU run, as
# a share of the CPU output's largest magnitude (TX_REL, phase 12's bound)


def _audio_fb_cases(dev) -> list:
    """mp3fb's packet forms (Layer III: 2 granules of stereo; Layer II:
    36 slots) and ac3fb.frame (6 blocks of 5.1, some block-switched, the
    LFE never) on seeded inputs with carried state, on `dev` and on the
    CPU: [(what, (card tensors), (CPU tensors))]."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.ops import ac3fb, mp3fb
    rng = np.random.default_rng(23)

    def f32(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))
    xr, ov, fifo = f32((2, 2, 32, 18), 0.05), f32((2, 32, 18), 0.01), \
        f32((2, 16, 64), 0.01)
    bt = torch.from_numpy(rng.integers(0, 4, (2, 2, 32)).astype(np.int32))
    bt[0, 0, :2] = 0
    sub, xf, delay = f32((2, 36, 32), 0.1), f32((6, 6, 256), 0.1), \
        f32((6, 128), 0.1)
    sw = rng.random((6, 6)) < 0.3
    sw[:, 5] = False

    def run(d):
        sb, ov2 = mp3fb.imdct_packet(xr.to(d), bt.to(d), ov.to(d))
        pcm3, fifo3 = mp3fb.synth_packet(sb, fifo.to(d))
        pcm2, fifo2 = mp3fb.synth_packet(sub.to(d), fifo.to(d))
        return [("mp3fb Layer III packet", (pcm3, ov2, fifo3)),
                ("mp3fb synthesis of 36 slots", (pcm2, fifo2)),
                (f"ac3fb.frame ({int(sw.sum())} of 36 block-channels "
                 f"switched)", ac3fb.frame(xf.to(d), sw, delay.to(d)))]
    return [(what, card, cpu)
            for (what, card), (_, cpu) in zip(run(dev), run("cpu"))]


def _aac_split(st, dev) -> dict:
    """One decode_frames of an HE-AAC stream on `dev` by its stages: host
    parse, the IMDCT stage (h2d, device, d2h), host window, overlap-add
    and SBR; and the IMDCT's h2d and device time alone (CUDA events)."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch import testing as fx
    from ffmpeg_tpu_torch.codecs.aac import EIGHT_SHORT, LONG_SCALE
    from ffmpeg_tpu_torch.ops import tx
    from ffmpeg_tpu_torch.timing import cuda_ms
    dec = fx.audio_decoder(st, dev).codec
    t = [time.perf_counter()]
    parsed = dec.parse_packets(fx.audio_packets(st))
    t.append(time.perf_counter())
    dec.batched_imdct(parsed)
    t.append(time.perf_counter())
    dec.overlap_add(parsed)
    t.append(time.perf_counter())
    chans = [ch for _, outs, _ in parsed for _, ch in outs]
    spec = np.stack([ch.coeffs.astype(np.float32) for ch in chans
                     if ch.ics.window_sequence != EIGHT_SHORT])
    spec_d = torch.from_numpy(spec).to(dev)
    parse, stage, sbr = np.diff(t) * 1e3
    return {"parse": parse, "stage": stage, "sbr": sbr,
            "h2d_bytes": spec.nbytes, "d2h_bytes": 2 * spec.nbytes,
            "n_short": len(chans) - len(spec),
            "h2d_ms": cuda_ms(lambda: torch.from_numpy(spec).to(dev), 10),
            "imdct_ms": cuda_ms(lambda: tx.imdct(spec_d, 1024, LONG_SCALE),
                                10)}


def audio_decoders_profile(device: str = "cuda:0") -> None:
    """Phase 23's torch.profiler sessions, in a process of their own (see
    audio_profile): for each committed audio stream, after a warm decode
    of its first 2 packets, one whole decode profiled.  Prints one JSON
    line: name → packets, device kernels, copies, the host's launch calls
    and the device's busy ms."""
    sys.path.insert(0, str(REPO))
    import torch
    from ffmpeg_tpu_torch import testing as fx
    dev = torch.device(device)
    out = {}
    for name in fx.AUDIO_STREAM_NAMES:
        st = fx.audio_stream(name)
        fx.audio_decode(st, dev, n=2)
        device_ev, api = profile_device(lambda: fx.audio_decode(st, dev),
                                        warm=False)
        kernels = sum(1 for n, _ in device_ev
                      if not n.startswith(("Memcpy", "Memset")))
        out[name] = {"packets": len(st["packets"]), "kernels": kernels,
                     "copies": len(device_ev) - kernels, "api": api,
                     "busy_ms": sum(us for _, us in device_ev) / 1e3}
    print(json.dumps(out), flush=True)


def phase23_audio_decoders(dev, card) -> None:
    """The audio decoders on the card: the filterbanks against their CPU
    runs; each committed stream through open_decoder on the card against
    the port's CPU decode and the reference's committed PCM, its
    filterbank state on the card; x-realtime and its split; launches per
    packet (torch.profiler in a child process); K1 and K2 not launched."""
    import statistics
    import numpy as np
    import torch
    from ffmpeg_tpu_torch import testing as fx
    from ffmpeg_tpu_torch.codecs.aac import AacDecoder
    t_phase = time.monotonic()
    names = fx.AUDIO_STREAM_NAMES

    # the filterbanks on seeded inputs
    notes = []
    for what, card_t, cpu_t in _audio_fb_cases(dev):
        worst = 0.0
        for a, b in zip(card_t, cpu_t):
            if a.device != dev:
                raise RuntimeError(f"{what}: a result on {a.device}")
            full = float(b.abs().max())
            err = float((a.cpu() - b).abs().max())
            if err > TX_REL * full:
                raise RuntimeError(f"{what} on the card differs from the CPU "
                                   f"run by {err:.3g} (> {TX_REL} of full "
                                   f"scale {full:.3g})")
            worst = max(worst, err / full)
        notes.append(f"{what} within {worst:.3g} of full scale")
    print(f"phase 23 audio filterbanks [{card}]: on the card against the "
          f"CPU run: {'; '.join(notes)}", flush=True)

    # each stream, checked; the passes timed
    for name in names:
        fx.audio_decode(fx.audio_stream(name), dev, n=2)      # warm
    zero_counts()
    rows = {}
    for name in names:
        st = fx.audio_stream(name)
        ctx = fx.audio_decoder(st, dev)
        stats = []
        ctx.codec.stats = stats
        t = time.perf_counter()
        got = ctx.decode_frames(fx.audio_packets(st))
        torch.cuda.synchronize()
        walls = [time.perf_counter() - t]
        codec = ctx.codec
        state = ([codec._overlap, codec._fifo]
                 if st["codec_id"].startswith("mp") else
                 [] if isinstance(codec, AacDecoder) else [codec._delay])
        if codec.device != dev or any(
                x is not None and x.device != dev for x in state):
            raise RuntimeError(f"{name}: the decoder's state is not on the "
                               f"card")
        want = fx.audio_decode(st, "cpu")
        if len(got) != len(want) or len(got) != len(st["packets"]):
            raise RuntimeError(f"{name}: {len(got)} frames on the card, "
                               f"{len(want)} on the CPU, "
                               f"{len(st['packets'])} packets")
        bar = fx.audio_bar(name)
        n = fx.AUDIO_PREFIX_PACKETS
        checks = [_close_audio(fx.audio_pcm(got), fx.audio_pcm(want),
                               "against the CPU decode:", *bar),
                  _close_audio(np.concatenate([f.audio_data
                                               for f in got[:n]], 1),
                               st["prefix"], f"first {n} packets against "
                               f"the reference's PCM:", *bar)]
        rows[name] = {"st": st, "got": got, "stats": stats, "walls": walls,
                      "checks": checks}
    for _ in range(4):
        for name in names:
            t = time.perf_counter()
            fx.audio_decode(rows[name]["st"], dev)
            torch.cuda.synchronize()
            rows[name]["walls"].append(time.perf_counter() - t)
    counts = read_counts()
    from ffmpeg_tpu_torch.ops import huffman, me
    if huffman.KERNEL_LAUNCHES or me.KERNEL_LAUNCHES:
        raise RuntimeError(f"phase 23 launched K1 or K2: {counts}")

    prof = Child(f"audio_decoders_profile({str(dev)!r})",
                 "phase 23's profile").result()
    for name in names:
        r = rows[name]
        st, got = r["st"], r["got"]
        secs = sum(f.nb_samples for f in got) / got[0].sample_rate
        med = statistics.median(r["walls"])
        if st["codec_id"] == "aac":
            sp = _aac_split(st, dev)
            split = (f"host parse {sp['parse']:.1f}, IMDCT stage "
                     f"{sp['stage']:.2f} (h2d {sp['h2d_bytes']} B "
                     f"{sp['h2d_ms']:.3f} ms, device {sp['imdct_ms']:.4f} ms "
                     f"by CUDA events, {sp['n_short']} short-window "
                     f"channels, d2h {sp['d2h_bytes']} B), host window, "
                     f"overlap-add and SBR{' + PS' if 'ps' in name else ''} "
                     f"{sp['sbr']:.1f}")
        else:
            ss = r["stats"]
            dev_ms = {k: sum(s["device"][k] for s in ss)
                      for k in ("h2d", "filterbank", "d2h")}
            split = (f"host parse {sum(s['host']['parse'] for s in ss):.1f}, "
                     f"h2d {sum(s['h2d_bytes'] for s in ss)} B "
                     f"{dev_ms['h2d']:.3f} ms, device filterbank "
                     f"{dev_ms['filterbank']:.3f} ms (CUDA events, launches "
                     f"included), d2h {sum(s['d2h_bytes'] for s in ss)} B "
                     f"{dev_ms['d2h']:.3f} ms, over {len(ss)} packets")
        pr = prof[name]
        launches = (f"{pr['kernels'] / pr['packets']:.1f} kernels + "
                    f"{pr['copies'] / pr['packets']:.1f} copies per packet "
                    f"({pr['kernels']} + {pr['copies']} over "
                    f"{pr['packets']} packets, {pr['api']} launch calls; "
                    f"device busy {pr['busy_ms']:.3f} ms, "
                    f"{pr['busy_ms'] / (med * 1e3):.1%} of a pass)"
                    if pr["kernels"] or pr["api"] else
                    "launches not measured (the profiler saw no CUDA "
                    "activity)")
        print(f"phase 23 {name} [{card}]: {st['codec_id']}, "
              f"{len(got[0].planes)} ch at {got[0].sample_rate} Hz, "
              f"{len(got)} packets ({secs:.3f} s) through "
              f"open_decoder('{st['codec_id']}') on the card: "
              f"{'; '.join(r['checks'])}; {secs / med:.2f}x realtime "
              f"(median {med * 1e3:.1f} ms of 5 passes, wall, "
              f"{[round(w * 1e3, 1) for w in r['walls']]} ms); split of "
              f"the first pass (ms): {split}; {launches}; {counts}",
              flush=True)
    print(f"phase 23 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)


# phase 24's bars (tests/test_torch_filters_*.py): integer samples within
# 1 on <= 1% of each plane, float samples within 1e-6 of the plane's
# largest magnitude, scores within 1e-9 relative
FILTER_LSB_SHARE, FILTER_REL, SCORE_REL = 0.01, 1e-6, 1e-9


def _filter_planes(frame) -> list:
    """A filtered frame's planes as host arrays of the reference's types."""
    return frame.numpy().planes


def _filter_diff(got: list, want: list, bar: str, what: str) -> tuple:
    """Frames `got` against `want` (props exact, planes under `bar`);
    raises outside, else returns (max |diff|, largest share differing)."""
    if len(got) != len(want):
        raise RuntimeError(f"{what}: {len(got)} frames, expected "
                           f"{len(want)}")
    worst = [0.0, 0.0]
    for a, b in zip(got, want):
        if (a.pts, a.width, a.height, a.format) != \
                (b.pts, b.width, b.height, b.format):
            raise RuntimeError(f"{what}: frame {a.pts} {a.width}x{a.height} "
                               f"{a.format}, expected {b.pts} "
                               f"{b.width}x{b.height} {b.format}")
        for x, y in zip(_filter_planes(a), _filter_planes(b)):
            _plane_bar(x, y, bar, what, worst)
    return tuple(worst)


def _plane_bar(x, y, bar: str, what: str, worst: list) -> None:
    import numpy as np
    if x.dtype != y.dtype or x.shape != y.shape:
        raise RuntimeError(f"{what}: plane {x.dtype} {x.shape}, expected "
                           f"{y.dtype} {y.shape}")
    d = np.abs(x.astype(np.float64) - y.astype(np.float64))
    m, share = (float(d.max()), float((d > 0).mean())) if d.size else (0, 0)
    worst[0], worst[1] = max(worst[0], m), max(worst[1], share)
    if bar == "exact":
        ok = m == 0
    elif bar == "lsb":
        ok = m <= 1 and share <= FILTER_LSB_SHARE
    else:
        ok = m <= FILTER_REL * max(1.0, float(np.abs(y).max()))
    if not ok:
        raise RuntimeError(f"{what}: max |diff| {m} on {share:.4%} of a "
                           f"plane, outside the {bar} bar")


def _filter_golden(gold, key: str, frames: list, bar: str,
                   what: str) -> str:
    """`frames` against the reference's committed golden under `bar`:
    each frame's pts, size, format and plane types; every plane's
    sha256 (exact) or frame 0's corners."""
    import hashlib
    import numpy as np
    from ffmpeg_tpu_torch.testing import corner_size
    meta = json.loads(str(gold[f"{key}/meta"]))
    got = [{"pts": int(f.pts), "size": [f.width, f.height],
            "format": f.format,
            "planes": [[list(p.shape), p.dtype.str]
                       for p in _filter_planes(f)]} for f in frames]
    if got != meta:
        raise RuntimeError(f"{what}: frames {got[:2]}..., the reference's "
                           f"{meta[:2]}...")
    if bar == "exact":
        want = gold[f"{key}/sha256"]
        hashes = [[hashlib.sha256(np.ascontiguousarray(p).tobytes())
                   .hexdigest() for p in _filter_planes(f)] for f in frames]
        bad = sum(a != b for ha, hb in zip(hashes, want.tolist())
                  for a, b in zip(ha, hb))
        if bad:
            raise RuntimeError(f"{what}: {bad} of {want.size} planes differ "
                               f"from the reference's sha256")
        return f"{want.size} plane sha256 equal to the reference's"
    worst = [0.0, 0.0]
    for i, p in enumerate(_filter_planes(frames[0])):
        ch, cw = corner_size(frames[0].format, i)
        _plane_bar(p[:ch, :cw], gold[f"{key}/tl{i}"], bar, what, worst)
        _plane_bar(p[-ch:, -cw:], gold[f"{key}/br{i}"], bar, what, worst)
    return (f"frame 0's corners within {worst[0]:g} "
            f"(on {worst[1]:.3%}) of the reference's")


def _chain_feeds(chain, cache: dict) -> dict:
    """The chain's 1080p host inputs, each (format, frames, seed, divisor,
    interlaced) made once per run."""
    from ffmpeg_tpu_torch.testing import FilterChain, filter_chain_inputs
    out = {}
    for label, spec in chain.inputs:
        if spec not in cache:
            one = FilterChain("", "", (("x", spec),))
            cache[spec] = filter_chain_inputs(one, 1920, 1080)["x"]
        out[label] = cache[spec]
    return out


def _on(feeds: dict, dev) -> dict:
    """The feeds with every plane copied to `dev` once."""
    import torch
    out = {}
    for k, frames in feeds.items():
        out[k] = []
        for f in frames:
            g = f.clone_props()
            g.planes = [torch.as_tensor(p, device=dev) for p in f.planes]
            out[k].append(g)
    return out


def filters_profile(device: str = "cuda:0") -> None:
    """Phase 24's torch.profiler sessions, in a process of their own (see
    audio_profile): each chain's graph over its inputs already on the
    card, after a warm run.  Prints one JSON line: chain → input frames,
    kernels, copies, the host's launch calls and the device's busy ms."""
    sys.path.insert(0, str(REPO))
    import torch
    from ffmpeg_tpu_torch.filters import parse_graph
    from ffmpeg_tpu_torch.testing import FILTER_CHAINS, run_graph
    dev = torch.device(device)
    cache, out = {}, {}
    for chain in FILTER_CHAINS:
        feeds = _on(_chain_feeds(chain, cache), dev)

        def run():
            return run_graph(parse_graph(chain.graph_text(), device=dev),
                             feeds, chain.outs, chain.eof_early)
        ev, api = profile_device(run)
        kernels = sum(1 for n, _ in ev
                      if not n.startswith(("Memcpy", "Memset")))
        out[chain.name] = {"frames": len(feeds[chain.inputs[0][0]]),
                           "kernels": kernels, "copies": len(ev) - kernels,
                           "api": api,
                           "busy_ms": sum(us for _, us in ev) / 1e3}
    print(json.dumps(out), flush=True)


def phase24_filters(dev, card) -> None:
    """The video filters on the card at 1920x1080 through parse_graph:
    each chain of testing.FILTER_CHAINS against the reference's golden,
    timed; then, while a child process profiles the chains on the card,
    each against the port's CPU run; the sources against their CPU runs
    and the golden; K1 and K2 not launched."""
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.filters import get_filter, parse_graph
    from ffmpeg_tpu_torch.testing import (FILTER_CHAINS, FILTER_SOURCES,
                                          FILTERS_GOLDEN, chain_scores,
                                          run_graph)
    from ffmpeg_tpu_torch.timing import cuda_ms
    t_phase = time.monotonic()
    gold = np.load(FILTERS_GOLDEN)
    cache, runs, rows = {}, [], []
    split = dict.fromkeys(("inputs", "card", "timing", "cpu"), 0.0)

    def lap(key, t):
        split[key] += time.monotonic() - t
        return time.monotonic()
    zero_counts()
    for chain in FILTER_CHAINS:
        t = time.monotonic()
        feeds = _chain_feeds(chain, cache)
        t = lap("inputs", t)
        text = chain.graph_text()
        g = parse_graph(text, device=dev)
        got = run_graph(g, feeds, chain.outs, chain.eof_early)
        torch.cuda.synchronize()
        t = lap("card", t)
        if not all(isinstance(p, torch.Tensor) and p.device == dev
                   for o in chain.outs for f in got[o] for p in f.planes):
            raise RuntimeError(f"{chain.name}: output planes off the card")
        notes = {o: _filter_golden(gold, f"{chain.name}/{o}", got[o],
                                   chain.bar, f"phase 24 {chain.name}/{o} "
                                   f"against the golden")
                 for o in chain.outs}
        want_s = json.loads(str(gold[f"{chain.name}/scores"]))
        for name, sc in chain_scores(g, chain).items():
            err = max(abs(a - b) / abs(b) for a, b in zip(sc, want_s[name]))
            if len(sc) != len(want_s[name]) or err > SCORE_REL:
                raise RuntimeError(f"{chain.name}: {name} scores {sc}, the "
                                   f"reference's {want_s[name]}")
        t = time.monotonic()
        dfeeds = _on(feeds, dev)
        n_in = len(feeds[chain.inputs[0][0]])
        ms = cuda_ms(lambda: run_graph(parse_graph(text, device=dev), dfeeds,
                                       chain.outs, chain.eof_early), 3)
        lap("timing", t)
        runs.append((chain, feeds, g, got, notes, ms / n_in, n_in))

    t_child = time.monotonic()
    child = Child(f"filters_profile({str(dev)!r})", "phase 24's profile")
    for chain, feeds, g, got, notes, ms, n_in in runs:
        t = time.monotonic()
        gc = parse_graph(chain.graph_text(), device="cpu")
        want = run_graph(gc, feeds, chain.outs, chain.eof_early)
        lap("cpu", t)
        parts = []
        for o in chain.outs:
            m, share = _filter_diff(got[o], want[o], chain.bar,
                                    f"phase 24 {chain.name}/{o} against the "
                                    f"CPU run")
            parts.append(f"{o}: {len(got[o])} frames, within {m:g} (on "
                         f"{share:.3%}) of the CPU run; {notes[o]}")
        want_s = json.loads(str(gold[f"{chain.name}/scores"]))
        for name, sc in chain_scores(g, chain).items():
            cpu_s = chain_scores(gc, chain)[name]
            err = max(max(abs(a - b) / abs(b) for a, b in zip(sc, ref))
                      for ref in (want_s[name], cpu_s))
            if err > SCORE_REL:
                raise RuntimeError(f"{chain.name}: {name} scores {sc}, the "
                                   f"CPU's {cpu_s}")
            parts.append(f"{name} scores {[round(float(x), 4) for x in sc]} "
                         f"within {err:.2g} relative of the reference's and "
                         f"the CPU's")
        rows.append((chain, parts, ms, n_in))

    src_notes = []
    for name, args, n, bar in FILTER_SOURCES:
        a = ":".join(x for x in (args, "size=1920x1080") if x)
        made = []
        for d in (dev, torch.device("cpu")):
            src = get_filter(name)(a)
            src.device = d
            made.append(list(src.generate(n)))
        if not all(p.device == dev for f in made[0] for p in f.planes):
            raise RuntimeError(f"{name}: planes off the card")
        m, share = _filter_diff(made[0], made[1], bar,
                                f"phase 24 source {name} against the CPU")
        gnote = _filter_golden(gold, f"source/{name}", made[0], bar,
                               f"phase 24 source {name} against the golden")
        src_notes.append(f"{name} {n} frames within {m:g} of the CPU run, "
                         f"{gnote}")
    for name, args in (("sine", "frequency=1000:sample_rate=48000"),
                       ("anullsrc", "channels=2")):
        fr = list(get_filter(name)(args).generate(2))
        data = np.concatenate([f.audio_data for f in fr], axis=1)
        t = [(np.arange(1024) + pos) / 48000 for pos in (0, 1024)]
        want = np.concatenate([(0.5 * np.sin(2 * np.pi * 1000 * x))
                               .astype(np.float32) for x in t])[None] \
            if name == "sine" else np.zeros((2, 2048), np.float32)
        if not np.array_equal(data, want):
            raise RuntimeError(f"{name}: samples differ from the formula")
        src_notes.append(f"{name} {data.shape} host samples equal to the "
                         f"formula")
    counts = read_counts()
    from ffmpeg_tpu_torch.ops import huffman, me
    if huffman.KERNEL_LAUNCHES or me.KERNEL_LAUNCHES:
        raise RuntimeError(f"phase 24 launched K1 or K2: {counts}")

    prof = child.result()
    split["profile (beside the CPU runs)"] = time.monotonic() - t_child
    for chain, parts, ms, n_in in rows:
        pr = prof[chain.name]
        launches = (f"{pr['kernels'] / n_in:.1f} kernels + "
                    f"{pr['copies'] / n_in:.1f} copies per frame "
                    f"({pr['kernels']} + {pr['copies']} over {n_in} input "
                    f"frames, {pr['api']} launch calls; device busy "
                    f"{pr['busy_ms']:.3f} ms, "
                    f"{pr['busy_ms'] / (ms * n_in):.1%} of the run)"
                    if pr["kernels"] or pr["api"] else
                    "launches not measured (the profiler saw no CUDA "
                    "activity)")
        print(f"phase 24 {chain.name} [{card}]: '{chain.graph_text()}' "
              f"({chain.bar}): {'; '.join(parts)}; {ms:.3f} ms/frame "
              f"(CUDA events, 3 warm runs of a new graph over {n_in} "
              f"frames on the card, its construction included); "
              f"{launches}; {counts}", flush=True)
    print(f"phase 24 sources [{card}]: {'; '.join(src_notes)}; {counts}",
          flush=True)
    print(f"phase 24 wall time: {time.monotonic() - t_phase:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in split.items())
          + "; the sources and checks the rest)", flush=True)


def _tx25_cases() -> list:
    """Phase 25's transforms at the main path's shapes: (what, tx
    function name, n, scale, input shape)."""
    aac = 1.0 / 512 / 65536
    return [("AAC encoder MDCT n=1024 (48 blocks x 2 ch)", "mdct", 1024,
             1.0, (96, 2048)),
            ("AAC probe IMDCT n=1024", "imdct", 1024, aac, (3, 1024)),
            ("Vorbis IMDCT n=1024 (2 ch)", "imdct", 1024, 1.0, (2, 1024)),
            ("Vorbis IMDCT n=128 (2 ch)", "imdct", 128, 1.0, (2, 128))] + [
        (f"CELT IMDCT n={n} ({rows} rows)", "imdct", n, 1 / 32768,
         (rows, n)) for n, rows in ((120, 16), (240, 8), (480, 4),
                                    (960, 2))]


def audio_codecs_profile(device: str = "cuda:0") -> None:
    """Phase 25's torch.profiler sessions, in a process of their own (see
    audio_profile): for each AAC case one encode after a warm one, and for
    each Vorbis and Opus stream that makes device calls (the SILK streams
    make none: their `stats` in phase 25 are empty) one whole decode after
    a warm decode of its first 2 packets.  Prints one JSON line: name →
    packets, kernels, copies, launch calls, device busy ms and the
    kernels' names."""
    sys.path.insert(0, str(REPO))
    import torch
    from ffmpeg_tpu_torch import testing as fx
    dev = torch.device(device)
    runs = {}
    for name in fx.AAC_CHIP_CASES:
        rate, ch, n, q = fx.AAC_ENC_CASES[name]
        sig = fx.aac_signal(n, rate, ch)
        runs[name] = (lambda s=sig, r=rate, q=q: fx.aac_encode(s, r, q, dev),
                      -(-n // 1024) + 1)
    for name in fx.CODEC_STREAM_NAMES:
        if name.startswith("silk_"):
            continue
        st = fx.codec_stream(name)
        fx.codec_decode(st, dev, n=2)
        runs[name] = (lambda st=st: fx.codec_decode(st, dev),
                      len(st["packets"]))
    out = {}
    for name, (fn, packets) in runs.items():
        ev, api = profile_device(fn, warm=name in fx.AAC_CHIP_CASES)
        names = sorted({n[:60] for n, _ in ev
                        if not n.startswith(("Memcpy", "Memset"))})
        kernels = sum(1 for n, _ in ev
                      if not n.startswith(("Memcpy", "Memset")))
        out[name] = {"packets": packets, "kernels": kernels,
                     "copies": len(ev) - kernels, "api": api,
                     "busy_ms": sum(us for _, us in ev) / 1e3,
                     "names": names}
    print(json.dumps(out), flush=True)


def _stage_split(stats: list, wall_ms: float) -> str:
    """One pass's split from its `stats` (codecs/audio_tx.py): the host's
    time outside the device stage, and the stage's h2d, transform and d2h
    by CUDA events, with the bytes each way."""
    stage = sum(s["host"]["device"] for s in stats)
    dev = {k: sum(s["device"][k] for s in stats)
           for k in ("h2d", "transform", "d2h")}
    return (f"host {wall_ms - stage:.2f} ms, device stage {stage:.2f} ms "
            f"wall over {len(stats)} calls: h2d "
            f"{sum(s['h2d_bytes'] for s in stats)} B {dev['h2d']:.3f} ms, "
            f"transform {dev['transform']:.3f} ms, d2h "
            f"{sum(s['d2h_bytes'] for s in stats)} B {dev['d2h']:.3f} ms "
            f"(CUDA events)")


def _profile_note(pr, med_ms: float) -> str:
    """The profile child's counts for one run, per packet, with the
    device's busy share of `med_ms`; for a stream it did not profile,
    the pass's device calls from `stats` (none for SILK)."""
    if pr is None:
        return ("no device call in the pass (`stats`: SILK runs on the "
                "host), not profiled")
    if not (pr["kernels"] or pr["api"]):
        return "launches not measured (the profiler saw no CUDA activity)"
    return (f"{pr['kernels'] / pr['packets']:.2f} kernels + "
            f"{pr['copies'] / pr['packets']:.2f} copies per packet "
            f"({pr['kernels']} + {pr['copies']} over {pr['packets']} "
            f"packets, {pr['api']} launch calls; device busy "
            f"{pr['busy_ms']:.3f} ms, {pr['busy_ms'] / med_ms:.2%} of a "
            f"pass; kernels: {', '.join(pr['names'])})")


def phase25_audio_codecs(dev, card) -> None:
    """The AAC encoder, the Vorbis and Opus decoders and the audio filter
    chains on the card (see phase 25 in the module docstring); K1 and K2
    not launched."""
    import statistics
    import numpy as np
    import torch
    from ffmpeg_tpu_torch import testing as fx
    from ffmpeg_tpu_torch.filters import parse_graph
    from ffmpeg_tpu_torch.ops import huffman, me, tx
    t_phase = time.monotonic()

    # the transforms at the main path's shapes
    rng = np.random.default_rng(25)
    notes = []
    for what, kind, n, scale, shape in _tx25_cases():
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        fn = getattr(tx, kind)
        got, want = fn(x.to(dev), n, scale), fn(x, n, scale)
        if got.device != dev:
            raise RuntimeError(f"{what}: result on {got.device}")
        full = float(want.abs().max())
        err = float((got.cpu() - want).abs().max())
        if err > TX_REL * full:
            raise RuntimeError(f"{what} on the card differs from the CPU run "
                               f"by {err:.3g} (> {TX_REL} of full scale "
                               f"{full:.3g})")
        notes.append(f"{what} {err / full:.3g}")
    print(f"phase 25 transforms [{card}]: on the card against the CPU run, "
          f"max |diff| over full scale: {'; '.join(notes)}", flush=True)

    # warm every path once, then count K1/K2 over the main path's runs
    fx.aac_encode(fx.aac_signal(3000, 48000, 2), 48000, 2, dev)
    for name in fx.CODEC_STREAM_NAMES:
        fx.codec_decode(fx.codec_stream(name), dev, n=2)
    zero_counts()

    # the AAC encoder
    aac_med = {}
    for name in fx.AAC_CHIP_CASES:
        rate, ch, n, q = fx.AAC_ENC_CASES[name]
        r = fx.aac_check(name, dev)
        sig = fx.aac_signal(n, rate, ch)
        walls, stats = [], []
        for i in range(3):
            st = [] if i == 0 else None
            t = time.perf_counter()
            fx.aac_encode(sig, rate, q, dev, st)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            stats = st if st is not None else stats
        med = aac_med[name] = statistics.median(walls)
        decided = ("all byte-equal to the reference's" if
                   r["equal"] == r["packets"] else
                   f"{r['equal']} byte-equal to the reference's, the rest "
                   f"holding {r['diff']} levels and {r['sf_diff']} "
                   f"scalefactors that differ, each one step at most and "
                   f"within float32's error of its tie (worst "
                   f"{max(r['worst'], r['sf_worst']):.3g} of the bound)")
        print(f"phase 25 AAC encoder {name} [{card}]: {ch} ch at {rate} Hz, "
              f"{n / rate:.3f} s at quality {q} through open_encoder('aac') "
              f"on the card: {r['packets']} packets, {decided}; "
              f"{r['bytes']} bytes (reference {r['ref_bytes']}); decoded "
              f"on the card at {r['snr']:.4f} dB to the source (reference "
              f"{r['ref_snr']:.4f} dB); {r['packets'] * 1e3 / med:.1f} "
              f"frames/s, {n / rate * 1e3 / med:.2f}x realtime (median "
              f"{med:.1f} ms of {[round(w, 1) for w in walls]}, wall); "
              f"split of the first pass: {_stage_split(stats, walls[0])}; "
              f"the host part is the windows, band loop and packing",
              flush=True)

    # the Vorbis and Opus streams
    rows = {}
    for name in fx.CODEC_STREAM_NAMES:
        st = fx.codec_stream(name)
        walls, stats, got = [], [], None
        for i in range(3):
            s_ = [] if i == 0 else None
            t = time.perf_counter()
            frames = fx.codec_decode(st, dev, s_)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
            if i == 0:
                got, stats = frames, s_
        pre = fx.codec_decode(st, dev, n=fx.CODEC_PREFIX_PACKETS)
        rows[name] = {"st": st, "got": got, "pre": pre, "walls": walls,
                      "stats": stats}
    counts = read_counts()
    child = Child(f"audio_codecs_profile({str(dev)!r})",
                  "phase 25's profile")
    try:
        for name, r in rows.items():
            st = r["st"]
            want = fx.codec_decode(st, "cpu")
            pcm = fx.audio_pcm(r["got"])
            checks = [_close_audio(
                np.concatenate([f.audio_data for f in r["got"]], 1),
                np.concatenate([f.audio_data for f in want], 1),
                "against the CPU decode:", fx.AUDIO_DECODE_TOL,
                fx.AUDIO_DECODE_MIN_SNR),
                _close_audio(np.concatenate([f.audio_data for f in r["pre"]],
                                            1), st["prefix"],
                             f"first {fx.CODEC_PREFIX_PACKETS} packets "
                             f"against the reference's PCM:",
                             fx.AUDIO_DECODE_TOL, fx.AUDIO_DECODE_MIN_SNR)]
            r["checks"] = checks
            r["secs"] = pcm.size / st["channels"] / st["sample_rate"]
    finally:
        prof = child.result()
    for name, r in rows.items():
        st = r["st"]
        med = statistics.median(r["walls"])
        print(f"phase 25 {name} [{card}]: {st['codec_id']}, "
              f"{st['channels']} ch, {len(st['packets'])} packets "
              f"({r['secs']:.3f} s) through open_decoder("
              f"'{st['codec_id']}') on the card: {'; '.join(r['checks'])}; "
              f"{r['secs'] * 1e3 / med:.2f}x realtime (median {med:.1f} ms "
              f"of {[round(w, 1) for w in r['walls']]}, wall); split of the "
              f"first pass: {_stage_split(r['stats'], r['walls'][0])}; "
              f"{_profile_note(prof.get(name), med)}", flush=True)
        if bool(r["stats"]) != (name in prof):
            raise RuntimeError(f"{name}: {len(r['stats'])} device calls, "
                               f"profiled: {name in prof}")
    for name in fx.AAC_CHIP_CASES:
        print(f"phase 25 AAC encoder {name} launches [{card}]: one encode "
              f"with the encoder's opening: "
              f"{_profile_note(prof[name], aac_med[name])}", flush=True)

    # the audio filter chains
    z = np.load(fx.AUDIO_CODECS)
    inputs = fx.audio_chain_inputs()
    for name in fx.AUDIO_CHAINS:
        host = fx.run_audio_chain(lambda t: parse_graph(t, device=dev), name,
                                  inputs, resample=False)
        try:
            fx.audio_chain_host_check(host, z, name)
        except AssertionError as e:
            raise RuntimeError(str(e)) from None
        walls = []
        for _ in range(3):
            t = time.perf_counter()
            got = fx.run_audio_chain(lambda t: parse_graph(t, device=dev),
                                     name, inputs)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        cpu = fx.run_audio_chain(lambda t: parse_graph(t, device="cpu"),
                                 name, inputs)
        checks = [_close_audio(got, z[f"chain_{name}"], "against the golden:",
                               TX_REL, AUDIO_MIN_SNR),
                  _close_audio(got, cpu, "against the CPU graph:", TX_REL,
                               AUDIO_MIN_SNR)]
        med = statistics.median(walls)
        print(f"phase 25 audio chain {name} [{card}]: "
              f"parse_graph('{fx.audio_chain_text(name)}') on the card over "
              f"{fx.AUDIO_CHAIN_SECONDS} s of 48 kHz stereo: host filters "
              f"{host.shape} bit-equal to the golden (sha256); "
              f"{'; '.join(checks)}; {med / fx.AUDIO_CHAIN_SECONDS:.1f} ms "
              f"per second of audio (median of "
              f"{[round(w, 1) for w in walls]} ms, wall)", flush=True)

    counts = f"{counts}; after the chains {read_counts()}"
    if huffman.KERNEL_LAUNCHES or me.KERNEL_LAUNCHES:
        raise RuntimeError(f"phase 25 launched K1 or K2: {counts}")
    print(f"phase 25 K1 and K2: 0 launches in phase 25 ({counts})",
          flush=True)
    print(f"phase 25 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)



class _FrameCalls:
    """Counts, while it is entered, the calls of the function `name` of
    core/frame.py that `counts` accepts, in every module of the port
    that holds that function."""

    name = ""

    def counts(self, *args) -> bool:
        raise NotImplementedError

    def __enter__(self):
        from ffmpeg_tpu_torch.core import frame
        self.n, self._orig = 0, getattr(frame, self.name)

        def counted(*args):
            if self.counts(*args):
                self.n += 1
            return self._orig(*args)
        self._mods = [m for name, m in list(sys.modules.items())
                      if name.startswith("ffmpeg_tpu_torch")
                      and getattr(m, self.name, None) is self._orig]
        for m in self._mods:
            setattr(m, self.name, counted)
        return self

    def __exit__(self, *exc):
        for m in self._mods:
            setattr(m, self.name, self._orig)


class PlaneCopies(_FrameCalls):
    """Counts the device-to-host copies of frame planes while it is
    entered: each call of core.frame.host_array on a tensor off the CPU
    (Frame.numpy and to_bytes, and the encoders that read planes on the
    host)."""

    name = "host_array"

    def counts(self, plane) -> bool:
        import torch
        return isinstance(plane, torch.Tensor) and plane.device.type != "cpu"


class Uploads(_FrameCalls):
    """Counts the uploads of pictures to `dev` while it is entered: each
    call of core.frame.device_planes (Frame.from_bytes and the decoders)
    that copies host planes to a device of dev's type."""

    name = "device_planes"

    def __init__(self, dev):
        import torch
        self.type = torch.device(dev).type

    def counts(self, planes, device) -> bool:
        import torch
        return torch.device(device).type == self.type and any(
            not isinstance(p, torch.Tensor) for p in planes)


class CliRuns:
    """One phase's runs of the port's CLI in process (phases 26-27): each
    command of `cmds` by name, timed on the host's clock up to a
    synchronize, with K1's and K2's launches and the plane copies to the
    host (PlaneCopies) in `rows`, and its report line."""

    def __init__(self, phase: int, dev, card: str, cmds: dict):
        self.phase, self.dev, self.card, self.cmds = phase, dev, card, cmds
        self.rows: dict = {}

    def run(self, name: str, frames: int = 0, secs: float = 0.0) -> dict:
        """Runs command `name`; `frames` (video) or `secs` (audio) give
        the report its rate."""
        import torch
        from ffmpeg_tpu_torch.cli.ffmpeg import main as fftpu
        from ffmpeg_tpu_torch.ops import huffman, me
        zero_counts()
        with PlaneCopies() as cp:
            t = time.perf_counter()
            rc = fftpu(self.cmds[name], device=self.dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        if rc != 0:
            raise RuntimeError(f"phase {self.phase} ({name}): fftpu-torch "
                               f"{' '.join(self.cmds[name])} returned {rc}")
        r = self.rows[name] = {"wall": wall, "frames": frames, "secs": secs,
                               "k1": huffman.KERNEL_LAUNCHES,
                               "k2": me.KERNEL_LAUNCHES, "copies": cp.n}
        return r

    def report(self, name: str, what: str, check: str,
               direct: str = "") -> None:
        r = self.rows[name]
        rate = (f", {r['frames'] / r['wall']:.3f} frames/s" if r["frames"]
                else f", {r['secs'] / r['wall']:.2f}x realtime"
                if r["secs"] else "")
        per = (f" ({r['copies'] / r['frames']:.2f} a frame)" if r["frames"]
               else "")
        args = " ".join(Path(a).name if "/" in a else a
                        for a in self.cmds[name])
        print(f"phase {self.phase} ({name}) [{self.card}]: fftpu-torch "
              f"{args}: {what}; {check}; wall {r['wall'] * 1e3:.1f} ms"
              f"{rate}{direct}; K1/K2 launches {r['k1']}/{r['k2']}; "
              f"{r['copies']} plane copies to the host{per}", flush=True)

    def probe_text(self, path: Path, args=None) -> str:
        """fftpu-probe's text of `path` with `args` (by default
        testing.CLI_PROBE_ARGS)."""
        import contextlib
        import io
        from ffmpeg_tpu_torch import testing as fx
        from ffmpeg_tpu_torch.cli.ffprobe import main as fftpu_probe
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fftpu_probe([*(fx.CLI_PROBE_ARGS if args is None
                                else args), str(path)], device=self.dev)
        if rc != 0:
            raise RuntimeError(f"phase {self.phase}: fftpu-probe of "
                               f"{path.name} returned {rc}")
        return buf.getvalue()


def phase26_cli(dev, card, d: Path) -> dict:
    """The port's CLI on the card (phase 26 in the module docstring), in
    directory `d`; returns each command's wall time, frames, K1 and K2
    launches and plane copies."""
    import hashlib
    import json
    import numpy as np
    import torch
    from ffmpeg_tpu_torch import testing as fx
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.filters import parse_graph
    from ffmpeg_tpu_torch.io import open_input
    t_phase = time.monotonic()
    gold = json.loads(fx.CLI_GOLDEN.read_text())
    cli = CliRuns(26, dev, card, fx.cli_commands(d))
    run, report, rows = cli.run, cli.report, cli.rows

    # (a) MJPEG -> scale -> rgb24, against the direct path on the card
    run("a", 8)
    got = (d / "out.rgb").read_bytes()
    dm = open_input(str(fx.FIXTURE))
    pkts = list(dm.packets())
    dm.close()
    t = time.perf_counter()
    frames = CodecContext.open_decoder(dm.streams[0].codecpar,
                                       device=dev).decode_all(pkts)
    out = parse_graph("scale=224:224,format=rgb24", device=dev).run(
        frames)
    want = b"".join(f.to_bytes() for f in out)
    direct_ms = (time.perf_counter() - t) * 1e3
    if got != want or len(got) != 8 * 224 * 224 * 3:
        raise RuntimeError(f"phase 26 (a): {len(got)} bytes, not equal "
                           f"to the direct path's {len(want)}")
    report("a", f"{len(pkts)} frames of 1920x1080 MJPEG",
           "byte-equal to open_decoder('mjpeg') + parse_graph('scale="
           "224:224,format=rgb24') on the card",
           f" (the direct path {direct_ms:.1f} ms)")

    # (b) VP9 -> framemd5, against the reference CLI's text
    run("b", 3)
    if (d / "out_vp9.md5").read_text() != gold["b_framemd5"]:
        raise RuntimeError("phase 26 (b): the framemd5 differs from "
                           "the reference CLI's golden")
    report("b", "3 frames of the 1920x1080 VP9 bench stream",
           "framemd5 text equal to the reference CLI's golden")

    # (c) H.264 remuxed, then its first frame decoded
    npk = len(list(open_input(str(fx.H264_CABAC)).packets()))
    for name, ext in (("c_mkv", "mkv"), ("c_mp4", "mp4")):
        run(name, 0)
        sha = hashlib.sha256((d / f"out.{ext}").read_bytes()).hexdigest()
        if sha != gold[f"c_{ext}_sha256"]:
            raise RuntimeError(f"phase 26 ({name}): the remux differs "
                               f"from the reference CLI's (sha256)")
        report(name, f"{npk} packets of the 1920x1088 H.264 stream "
               f"copied", "sha256 equal to the reference CLI's remux")
    run("c_md5", 1)
    if (d / "out_h264.md5").read_text() != gold["c_framemd5"]:
        raise RuntimeError("phase 26 (c_md5): the framemd5 differs "
                           "from the reference CLI's golden")
    report("c_md5", "the Matroska file's first frame decoded (the "
           "decoder takes the pictures it needs to emit it)",
           "framemd5 text equal to the reference CLI's golden")

    # (d) a 1080p y4m -> MPEG-2 in Matroska, K2 in the motion search
    y4m = fx.write_y4m(d / "mpeg2_clip.y4m", fx.mpeg2_clip(
        fx.CLI_MPEG2_FRAMES, ENC_W, ENC_H))
    r = run("d", fx.CLI_MPEG2_FRAMES)
    if r["k2"] < 1:
        raise RuntimeError("phase 26 (d): K2 not launched by the CLI's "
                           "MPEG-2 encode")
    dm = open_input(str(d / "out_mpeg2.mkv"))
    got = [p.data for p in dm.packets()]
    dm.close()
    par, frames = fx.cli_encoder_input(y4m, "mpeg2video", dev)
    t = time.perf_counter()
    ctx = CodecContext.open_encoder(par, {}, device=dev)
    want = [p.data for p in fx.encode_all(ctx, frames)]
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t) * 1e3
    if got != want:
        raise RuntimeError(f"phase 26 (d): packets {[len(x) for x in got]}"
                           f" differ from the direct encode's "
                           f"{[len(x) for x in want]}")
    ref_bytes = gold["d_packet_bytes"]
    rel = max(abs(len(a) / b - 1) for a, b in zip(got, ref_bytes))
    if len(got) != len(ref_bytes) or rel > 0.01:
        raise RuntimeError(f"phase 26 (d): sizes {[len(x) for x in got]}"
                           f" not within 1% of the reference's "
                           f"{ref_bytes}")
    report("d", f"{len(got)} frames of mpeg2_clip at {ENC_W}x{ENC_H} "
           f"to MPEG-2", f"packets {[len(x) for x in got]} B byte-equal "
           f"to open_encoder('mpeg2video') on the card on the same "
           f"frames, within {rel:.3%} of the reference's {ref_bytes}",
           f" (the direct encode {direct_ms:.1f} ms)")

    # (e) the audio frontend's command
    run("e", 0)
    got = np.fromfile(d / "out.f32", np.float32)[None]
    note = _close_audio(got, np.load(fx.AUDIO_GOLDEN)["resampled"],
                        "against the frontend golden:", AUDIO_TOL,
                        AUDIO_MIN_SNR)
    secs = got.shape[1] / 16000
    report("e", f"{secs:.2f} s of 48 kHz stereo AAC to 16 kHz mono f32le",
           f"{note}; {secs / rows['e']['wall']:.2f}x realtime")

    # (f) the probe of the outputs
    for ext in ("mkv", "mp4"):
        if cli.probe_text(d / f"out.{ext}") != gold[f"f_probe_{ext}"]:
            raise RuntimeError(f"phase 26 (f): the probe of out.{ext} "
                               f"differs from the reference's")
    text = cli.probe_text(d / "out_mpeg2.mkv")
    if fx.probe_without_sizes(text) != fx.probe_without_sizes(
            gold["f_probe_mpeg2"]):
        raise RuntimeError("phase 26 (f): the probe of the MPEG-2 file "
                           "differs from the reference's beyond the "
                           "packets' sizes")
    print(f"phase 26 (f) [{card}]: fftpu-probe "
          f"{' '.join(fx.CLI_PROBE_ARGS)} of out.mkv and out.mp4 equal "
          f"to the reference's text, of out_mpeg2.mkv equal but for "
          f"the packets' sizes and positions", flush=True)
    if any(r["k1"] for r in rows.values()):
        raise RuntimeError("phase 26 launched K1, which no CLI path runs")
    print(f"phase 26 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)
    return rows


def _framemd5s(text: str) -> list:
    """The md5 column of a framemd5 file's frame lines."""
    return [ln.rsplit(",", 1)[1].strip() for ln in text.splitlines()
            if ln and not ln.startswith("#")]


def phase27_containers(dev, card, d: Path, rows26: dict) -> dict:
    """The CLI through the containers of io/formats/avi.py, mpegts.py and
    ogg.py on the card (phase 27 in the module docstring), in phase 26's
    directory `d`, on its outputs; returns each command's figures as
    phase26_cli does."""
    import hashlib
    import json
    import numpy as np
    import torch
    from ffmpeg_tpu_torch import testing as fx
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.io import open_input
    t_phase = time.monotonic()
    gold = json.loads(fx.CLI_GOLDEN.read_text())
    cli = CliRuns(27, dev, card, fx.cli_container_commands(d))
    run, report, rows = cli.run, cli.report, cli.rows

    def sha(path: Path) -> str:
        return hashlib.sha256(path.read_bytes()).hexdigest()

    # (g) MJPEG into AVI, then the AVI as command (a)
    run("g_avi")
    if sha(d / "out.avi") != gold["g_avi_sha256"]:
        raise RuntimeError("phase 27 (g_avi): out.avi differs from the "
                           "reference CLI's (sha256)")
    report("g_avi", "the 8 frames of 1920x1080 MJPEG copied into AVI",
           "sha256 equal to the reference CLI's")
    r = run("g_rgb", 8)
    if (d / "out_avi.rgb").read_bytes() != (d / "out.rgb").read_bytes():
        raise RuntimeError("phase 27 (g_rgb): differs from phase 26 (a)'s "
                           "out.rgb")
    if r["copies"] != rows26["a"]["copies"]:
        raise RuntimeError(f"phase 27 (g_rgb): {r['copies']} plane copies, "
                           f"phase 26 (a) {rows26['a']['copies']}")
    report("g_rgb", "the AVI to 224x224 rgb24", "byte-equal to phase 26 "
           f"(a)'s out.rgb, its plane copies as (a)'s (wall "
           f"{rows26['a']['wall'] * 1e3:.1f} ms there)")

    # (h) the MPEG-2 Matroska file into MPEG-TS, then the TS to framemd5
    run("h_ts")
    pk, par = {}, {}
    for ext in ("mkv", "ts"):
        dm = open_input(str(d / f"out_mpeg2.{ext}"))
        pk[ext] = list(dm.packets())
        dm.close()
        par[ext] = dm.streams[0].codecpar
    if [p.data for p in pk["ts"]] != [p.data for p in pk["mkv"]] or [
            p.pts * p.time_base.num / p.time_base.den for p in pk["ts"]] != [
            p.pts * p.time_base.num / p.time_base.den for p in pk["mkv"]]:
        raise RuntimeError("phase 27 (h_ts): the TS's packets differ from "
                           "the Matroska file's in payload or pts")
    report("h_ts", f"{len(pk['ts'])} MPEG-2 packets of phase 26 (d) copied "
           "into MPEG-TS", "packets equal to the Matroska file's in payload "
           f"and in pts (seconds; {pk['ts'][0].time_base} against "
           f"{pk['mkv'][0].time_base})")
    n = len(pk["mkv"])
    r = run("h_md5", n)
    dec = CodecContext.open_decoder(par["mkv"], device=dev)
    t = time.perf_counter()
    frames = dec.decode_all(pk["mkv"])
    torch.cuda.synchronize()
    direct_ms = (time.perf_counter() - t) * 1e3
    want = [hashlib.md5(f.to_bytes()).hexdigest() for f in frames]
    got = _framemd5s((d / "out_ts.md5").read_text())
    if got != want or len(got) != n:
        raise RuntimeError(f"phase 27 (h_md5): frame md5s {got} differ from "
                           f"open_decoder('mpeg2video')'s {want}")
    planes = len(frames[0].planes)
    if r["copies"] != planes * n:
        raise RuntimeError(f"phase 27 (h_md5): {r['copies']} plane copies, "
                           f"not the rawvideo encoder's {planes} a frame")
    report("h_md5", f"the TS's {n} 1920x1080 MPEG-2 pictures to framemd5",
           f"each frame's md5 equal to open_decoder('mpeg2video') on the "
           f"card on the Matroska file's packets ({direct_ms:.1f} ms)")

    # (i) the ADTS clip into MPEG-TS, then the TS as command (e)
    run("i_ts")
    if sha(d / "out_aac.ts") != gold["i_ts_sha256"]:
        raise RuntimeError("phase 27 (i_ts): out_aac.ts differs from the "
                           "reference CLI's (sha256)")
    report("i_ts", "the 20.03 s ADTS clip copied into MPEG-TS",
           "sha256 equal to the reference CLI's")
    secs = (d / "out.f32").stat().st_size / 4 / 16000
    run("i_f32", secs=secs)
    if (d / "out_ts.f32").read_bytes() != (d / "out.f32").read_bytes():
        raise RuntimeError("phase 27 (i_f32): differs from phase 26 (e)'s "
                           "out.f32")
    report("i_f32", f"the TS's AAC to 16 kHz mono f32le ({secs:.2f} s)",
           f"byte-equal to phase 26 (e)'s out.f32 (there "
           f"{rows26['e']['wall'] * 1e3:.1f} ms)")

    # (j) the Ogg files, each against the direct decode on the card
    fx.write_cli_ogg(d)
    for name in fx.CLI_OGG_STREAMS:
        st = fx.codec_stream(name)
        ch = st["channels"]
        r = run(f"j_{name}")
        got = np.fromfile(d / f"{name}.f32", np.float32).reshape(-1, ch).T
        r["secs"] = got.shape[1] / st["sample_rate"]
        if got.shape[1] != gold["j_samples"][name]:
            raise RuntimeError(f"phase 27 (j_{name}): {got.shape[1]} samples,"
                               f" the reference CLI {gold['j_samples'][name]}")
        want = np.concatenate([f.audio_data for f in fx.codec_decode(
            st, dev)], 1)
        m = min(got.shape[1], want.shape[1])
        note = _close_audio(np.ascontiguousarray(got[:, :m]),
                            np.ascontiguousarray(want[:, :m]),
                            "against open_decoder on the same packets on "
                            "the card:", fx.AUDIO_DECODE_TOL,
                            fx.AUDIO_DECODE_MIN_SNR)
        report(f"j_{name}", f"Ogg {st['codec_id']}, {ch} ch, "
               f"{len(st['packets'])} packets", f"{note}; "
               f"{got.shape[1]} samples as the reference CLI's")

    # (k) the probe of the outputs
    for f in fx.CLI_PROBE_FILES:
        text, want = cli.probe_text(d / f), gold["k_probe"][f]
        if f == "out_mpeg2.ts":
            text, want = (fx.probe_without_sizes(text),
                          fx.probe_without_sizes(want))
        if text != want:
            raise RuntimeError(f"phase 27 (k): the probe of {f} differs "
                               f"from the reference's")
    print(f"phase 27 (k) [{card}]: fftpu-probe {' '.join(fx.CLI_PROBE_ARGS)}"
          f" of {', '.join(fx.CLI_PROBE_FILES)} equal to the reference's "
          f"text (out_mpeg2.ts but for the packets' sizes and positions)",
          flush=True)
    if any(r["k1"] or r["k2"] for r in rows.values()):
        raise RuntimeError("phase 27 launched K1 or K2, which no command "
                           "here runs")
    print(f"phase 27 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)
    return rows


def _hls_aes_start():
    """testing.hls_aes_files in a child process on the CPU, in a new
    temporary directory: phase 28 (m)'s AES-128 HLS files, whose CBC
    encryption (the port's utils/aes.py, a block at a time: about 100 s)
    runs beside phases 2-27.  Returns (the child, its directory); at exit
    the child is killed if it still runs and the directory removed."""
    import atexit
    import shutil
    import tempfile
    d = Path(tempfile.mkdtemp(prefix="chip_smoke_hls_"))
    child = subprocess.Popen(
        [sys.executable, "-c", "import sys; from ffmpeg_tpu_torch import "
         "testing; testing.hls_aes_files(sys.argv[1])", str(d)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def stop():
        if child.poll() is None:
            child.kill()
            child.communicate()
        shutil.rmtree(d, ignore_errors=True)
    atexit.register(stop)
    return child, d


def _hls_aes_result(hls, d: Path) -> float:
    """Waits for _hls_aes_start's child (600 s at most) and copies its
    encrypted playlist, segments and key into `d`; returns the seconds
    waited."""
    import shutil
    child, src = hls
    t = time.monotonic()
    try:
        _, err = child.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        child.kill()
        child.communicate()
        raise
    if child.returncode != 0:
        raise RuntimeError(f"phase 28's AES-128 child exited "
                           f"{child.returncode}: {err[-3000:]}")
    for f in [*src.glob("aac_enc*"), src / "aac.key"]:
        shutil.copy(f, d / f.name)
    return time.monotonic() - t



def cpu_oracle(kind: str, src: str, dst: str) -> None:
    """Body of a child process: the port's CPU decode that phase 13
    ("vp9": the VP9 bench stream's frames 0-1) or phase 18 ("mpeg2": the
    packets in the npz `src`, phase 7's encode) holds the card's frames
    against, on two CPU threads; its planes go to the npz `dst` as
    "<frame>_<plane>"."""
    import numpy as np
    import torch
    torch.set_num_threads(2)
    if kind == "vp9":
        from ffmpeg_tpu_torch.io.ivf import read_ivf
        from ffmpeg_tpu_torch.testing import VP9_BENCH, vp9_decode
        _par, _tb, pkts = read_ivf(VP9_BENCH.read_bytes())
        frames = vp9_decode(pkts[:2], "cpu")
    else:
        from ffmpeg_tpu_torch.codecs import CodecContext
        from ffmpeg_tpu_torch.core.packet import Packet
        from ffmpeg_tpu_torch.io.stream import CodecParameters
        z = np.load(src)
        frames = CodecContext.open_decoder(
            CodecParameters(codec_id="mpeg2video"), device="cpu"
        ).decode_all([Packet(data=z[str(i)].tobytes(), pts=i)
                      for i in range(len(z.files))])
    np.savez(dst, **{f"{i}_{j}": np.asarray(pl) for i, f in
                     enumerate(frames) for j, pl in enumerate(f.planes)})


class CpuOracle:
    """cpu_oracle(kind) in a child process, started after phase 7 so that
    it runs beside the card's work of the phases before the one that
    reads it (the whole script's budget: phase 30 took the room).  At
    exit the child is killed if it still runs."""

    def __init__(self, kind: str, work: Path, packets=None):
        import atexit
        import numpy as np
        src, self.dst = work / f"{kind}_in.npz", work / f"{kind}_out.npz"
        if packets is not None:
            np.savez(src, **{str(i): np.frombuffer(p, np.uint8)
                             for i, p in enumerate(packets)})
        self.kind, self.waited = kind, 0.0
        self.child = subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke; "
             "chip_smoke.cpu_oracle(*sys.argv[1:])", kind, str(src),
             str(self.dst)], cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        atexit.register(self.stop)

    def stop(self) -> None:
        if self.child.poll() is None:
            self.child.kill()
            self.child.communicate()

    def planes(self) -> list:
        """Each frame's planes as numpy arrays, once the child ends (600 s
        at most); the seconds waited for it in `waited`."""
        import numpy as np
        t = time.monotonic()
        try:
            _, err = self.child.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            self.stop()
            raise
        self.waited = time.monotonic() - t
        if self.child.returncode != 0:
            raise RuntimeError(f"the {self.kind} CPU decode's child exited "
                               f"{self.child.returncode}: {err[-3000:]}")
        z = np.load(self.dst)
        n = 1 + max(int(k.split("_")[0]) for k in z.files)
        return [[z[f"{i}_{j}"] for j in range(3)] for i in range(n)]


class GifUploads:
    """Counts the GIF decoder's uploads of a frame to its device
    (codecs/gif.py upload_rgba) while it is entered."""

    def __enter__(self):
        from ffmpeg_tpu_torch.codecs import gif
        self.n, self._mod, self._orig = 0, gif, gif.upload_rgba

        def counted(canvas, device):
            self.n += 1
            return self._orig(canvas, device)
        gif.upload_rgba = counted
        return self

    def __exit__(self, *exc):
        self._mod.upload_rgba = self._orig


def phase28_protocols(dev, card, d: Path, rows26: dict, rows27: dict,
                      hls) -> None:
    """The CLI through the protocols and the host codecs on the card
    (phase 28 in the module docstring), in phase 26's directory `d`, on
    the outputs of phases 26-27; `hls` is _hls_aes_start's child, which
    encrypts command (m)'s HLS files."""
    import contextlib
    import hashlib
    import io
    import json
    import threading
    from ffmpeg_tpu_torch import testing as fx
    from ffmpeg_tpu_torch.cli.ffprobe import main as fftpu_probe
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.filters import parse_graph
    from ffmpeg_tpu_torch.io import open_input
    from ffmpeg_tpu_torch.io.rtmp import RtmpServer
    t_phase = time.monotonic()
    gold = json.loads(fx.CLI_GOLDEN.read_text())

    def sha(path: Path) -> str:
        return hashlib.sha256(path.read_bytes()).hexdigest()

    srv, srv_thread, base = fx.serve_http(d, fx.DATA.parent)
    relay, relayed = RtmpServer(), {}
    relay_thread = None
    cli = CliRuns(28, dev, card, fx.cli_protocol_commands(
        d, base, f"rtmp://127.0.0.1:{relay.port}/live/k"))
    run, report, rows = cli.run, cli.report, cli.rows
    ts_f32 = (d / "out_ts.f32").read_bytes()
    secs = len(ts_f32) / 4 / 16000
    try:
        # (l) the flagship over HTTP, as command (a)
        r = run("l", 8)
        if (d / "out_http.rgb").read_bytes() != (d / "out.rgb").read_bytes():
            raise RuntimeError("phase 28 (l): differs from phase 26 (a)'s "
                               "out.rgb")
        if r["copies"] != rows26["a"]["copies"]:
            raise RuntimeError(f"phase 28 (l): {r['copies']} plane copies, "
                               f"phase 26 (a) {rows26['a']['copies']}")
        report("l", "the 8 frames of 1920x1080 MJPEG over HTTP to 224x224 "
               "rgb24", "byte-equal to phase 26 (a)'s out.rgb, its plane "
               f"copies as (a)'s (wall {rows26['a']['wall'] * 1e3:.1f} ms "
               "there)")

        # (m) the TS into HLS, its AES-128 copy over HTTP
        run("m_hls")
        got = {p.name: sha(p) for p in sorted(d.glob("aac*"))
               if "_enc" not in p.name}
        if got != gold["m_hls_sha256"]:
            raise RuntimeError("phase 28 (m_hls): the playlist or segments "
                               "differ from the reference CLI's (sha256)")
        report("m_hls", f"(i)'s MPEG-TS copied into HLS, {len(got) - 1} "
               "segments", "playlist and segments equal to the reference "
               "CLI's (sha256)")
        waited = _hls_aes_result(hls, d)
        got = {p.name: sha(p) for p in sorted(d.glob("aac_enc*"))}
        got["aac.key"] = sha(d / "aac.key")
        if got != gold["m_enc_sha256"]:
            raise RuntimeError("phase 28 (m): the AES-128 playlist or "
                               "segments differ from the reference's")
        run("m_f32", secs=secs)
        if (d / "out_hls.f32").read_bytes() != ts_f32 or not \
                gold["m_f32_equals_ts"]:
            raise RuntimeError("phase 28 (m_f32): differs from phase 27 "
                               "(i)'s out_ts.f32")
        report("m_f32", f"the AES-128 HLS playlist over HTTP to 16 kHz "
               f"mono f32le ({secs:.2f} s)", "the encrypted files (made "
               "beside phases 2-27 by testing.hls_aes_files on the CPU, "
               f"{waited:.1f} s waited for) equal to the reference's "
               "(sha256), the output byte-equal to phase 27 (i)'s "
               f"out_ts.f32 (there {rows27['i_f32']['wall'] * 1e3:.1f} ms),"
               " as the reference CLI's is")

        # (n) the TS published to an RTMP relay and played from it
        relay_thread = threading.Thread(target=fx.rtmp_relay,
                                        args=(relay, relayed, 120.0))
        relay_thread.start()
        run("n_pub", secs=secs)
        run("n_f32", secs=secs)
        relay_thread.join(30)
        if relay_thread.is_alive() or "error" in relayed:
            raise RuntimeError(f"phase 28 (n): the RTMP relay failed: "
                               f"{relayed.get('error', 'still running')}")
        n_media = len(relayed["media"])
        if n_media != gold["n_media"]:
            raise RuntimeError(f"phase 28 (n_pub): {n_media} messages "
                               f"relayed, the reference {gold['n_media']}")
        report("n_pub", "(i)'s MPEG-TS published as FLV to the RTMP "
               "relay", f"{n_media} messages relayed, as the reference "
               "CLI's")
        if (d / "out_rtmp.f32").read_bytes() != ts_f32 or not \
                gold["n_f32_equals_ts"]:
            raise RuntimeError("phase 28 (n_f32): differs from phase 27 "
                               "(i)'s out_ts.f32")
        report("n_f32", "the RTMP stream played from the relay to 16 kHz "
               "mono f32le", "byte-equal to phase 27 (i)'s out_ts.f32, as "
               "the reference CLI's is")

        # (o) FLAC and back, against the direct s16le
        for name in ("o_flac", "o_s16", "o_direct"):
            run(name, secs=secs)
        flac = (d / "out.flac").read_bytes()
        if (d / "out_flac.s16").read_bytes() != \
                (d / "out_direct.s16").read_bytes() or not gold["o_lossless"]:
            raise RuntimeError("phase 28 (o): the FLAC's decode differs "
                               "from the direct s16le")
        if flac[:42].hex() != gold["o_streaminfo"]:
            raise RuntimeError(f"phase 28 (o_flac): STREAMINFO "
                               f"{fx.flac_streaminfo(flac)} differs from "
                               f"the reference's")
        info = fx.flac_streaminfo(flac)
        report("o_flac", "(i)'s AAC to 16 kHz mono FLAC", f"STREAMINFO "
               f"equal to the reference's ({info['rate']} Hz, "
               f"{info['channels']} ch, {info['bits']} bits, MD5 "
               f"{'unset' if set(info['md5']) == {'0'} else info['md5']}"
               f" as the reference's encoder leaves it)")
        report("o_s16", "the FLAC to s16le", "byte-equal to the direct "
               "s16le below (lossless)")
        report("o_direct", "(i)'s AAC to 16 kHz mono s16le", "the direct "
               "path of (o)")
    finally:
        relay.close()
        if relay_thread is not None:
            relay_thread.join(10)
        srv.shutdown()
        srv.server_close()
        srv_thread.join(10)
    if srv_thread.is_alive() or (relay_thread is not None
                                 and relay_thread.is_alive()):
        raise RuntimeError("phase 28: a server thread did not end")

    # (p) the port's GIF, to framemd5 and to 224x224 rgb24
    fx.write_cli_gif(d / "clip.gif")
    if sha(d / "clip.gif") != gold["p_gif_sha256"]:
        raise RuntimeError("phase 28 (p): clip.gif differs from the "
                           "reference encoder's (sha256)")
    n = fx.GIF_FRAMES
    with GifUploads() as up:
        r = run("p_md5", n)
    if (d / "out_gif.md5").read_text() != gold["p_framemd5"]:
        raise RuntimeError("phase 28 (p_md5): the framemd5 differs from "
                           "the reference CLI's golden")
    if up.n != n or r["copies"] != 4 * n:
        raise RuntimeError(f"phase 28 (p_md5): {up.n} uploads and "
                           f"{r['copies']} plane copies for {n} frames, "
                           f"not one upload and the rawvideo encoder's 4 "
                           f"planes a frame")
    report("p_md5", f"the port's GIF ({n} frames, {fx.GIF_W}x{fx.GIF_H}, "
           f"equal to the reference encoder's) to framemd5",
           f"framemd5 text equal to the reference CLI's golden; {up.n} "
           f"uploads of rgba planes")
    r = run("p_rgb", n)
    dm = open_input(str(d / "clip.gif"))
    pkts = list(dm.packets())
    dm.close()
    t = time.perf_counter()
    frames = CodecContext.open_decoder(dm.streams[0].codecpar,
                                       device=dev).decode_all(pkts)
    out = parse_graph("scale=224:224,format=rgb24", device=dev).run(frames)
    want = b"".join(f.to_bytes() for f in out)
    direct_ms = (time.perf_counter() - t) * 1e3
    if (d / "out_gif.rgb").read_bytes() != want or \
            len(want) != n * 224 * 224 * 3:
        raise RuntimeError("phase 28 (p_rgb): differs from the direct "
                           "path's")
    if r["copies"] != 3 * n:
        raise RuntimeError(f"phase 28 (p_rgb): {r['copies']} plane copies, "
                           f"not the rawvideo encoder's 3 a frame")
    report("p_rgb", "the GIF to 224x224 rgb24", "byte-equal to open_decoder"
           "('gif') + parse_graph('scale=224:224,format=rgb24') on the "
           "card", f" (the direct path {direct_ms:.1f} ms)")

    # (q) the host codecs' streams, and the tagged MP3's probe
    fx.write_host_codec_streams(d)
    for name, (ext, _, _, suffix) in fx.HOST_CODEC_STREAMS.items():
        out = Path(fx.host_codec_command(d, name)[-1])
        r = run(f"q_{name}")
        data = out.read_bytes()
        if hashlib.sha256(data).hexdigest() != fx.host_codec_golden(name):
            raise RuntimeError(f"phase 28 (q_{name}): the decode differs "
                               f"from the reference CLI's (sha256)")
        dm = open_input(str(d / f"{name}.{ext}"))
        st = dm.streams[0].codecpar
        dm.close()
        pcm = len(data) - (44 if suffix == "wav" else 0)
        r["secs"] = pcm / (st.sample_rate * st.channels * (
            2 if suffix == "s16" else 4))
        report(f"q_{name}", f"{(d / f'{name}.{ext}').stat().st_size} "
               f"bytes of {st.codec_id}, {st.channels} ch",
               f"{len(data)} bytes, sha256 equal to the reference CLI's")
    mp3 = d / fx.PROBE_MP3
    mp3.write_bytes(fx.tagged_mp3())
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fftpu_probe([*fx.PROBE_MP3_ARGS, str(mp3)], device=dev)
    if rc != 0 or buf.getvalue().replace(str(mp3), "{path}") != \
            gold["q_probe"]:
        raise RuntimeError("phase 28 (q): the probe of the tagged MP3 "
                           "differs from the reference's")
    print(f"phase 28 (q) [{card}]: fftpu-probe "
          f"{' '.join(fx.PROBE_MP3_ARGS)} of an ID3v2.4-tagged MP3 (text "
          f"frames, TXXX, COMM, two chapters, APIC) equal to the "
          f"reference's text but for the path", flush=True)
    if any(r["k1"] or r["k2"] for r in rows.values()):
        raise RuntimeError("phase 28 launched K1 or K2, which no command "
                           "here runs")
    print(f"phase 28 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)


def _direct_mpeg2(par, frames, dev, n_p: int, what: str) -> tuple:
    """open_encoder("mpeg2video") on the card fed `frames` (what the CLI's
    encoder was fed), with each (cur, ref) pair the encoder hands K2
    recorded and then held against K2's plain version at this path's
    shape; raises if K2 differs or searched other than once for each of
    the `n_p` P frames.  Returns (the packets' bytes, K2's max |diff|,
    the pairs' shape and type, the encode's ms)."""
    import torch
    from ffmpeg_tpu_torch import testing as fx
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.ops import me
    pairs, strip = [], me.sad_cost_volume_strip

    def record(cur, ref, block, search):
        pairs.append((cur, ref, block, search))
        return strip(cur, ref, block, search)
    me.sad_cost_volume_strip = record
    try:
        t = time.perf_counter()
        ctx = CodecContext.open_encoder(par, {}, device=dev)
        want = [p.data for p in fx.encode_all(ctx, frames)]
        torch.cuda.synchronize()
        direct_ms = (time.perf_counter() - t) * 1e3
    finally:
        me.sad_cost_volume_strip = strip
    k2_err = 0.0
    for cur, ref, block, search in pairs:
        got_v = me.sad_cost_volume_strip(cur, ref, block, search)
        want_v = me.sad_cost_volume_strip_plain(cur, ref, block, search)
        torch.cuda.synchronize()
        k2_err = max(k2_err, float((got_v - want_v).abs().max()))
        if not torch.equal(got_v, want_v):
            raise RuntimeError(f"{what}: K2 differs from its plain version "
                               f"on the encoder's {tuple(cur.shape)} "
                               f"{cur.dtype} planes, B={block} R={search}: "
                               f"max |diff| {k2_err}")
    if len(pairs) != n_p:
        raise RuntimeError(f"{what}: the direct encode searched "
                           f"{len(pairs)} times for {n_p} P frames")
    return (want, k2_err, f"{tuple(pairs[0][0].shape)} {pairs[0][0].dtype}",
            direct_ms)


def phase29_images(dev, card, d: Path) -> dict:
    """The CLI through the image codecs, FFV1, VP8 and WebP on the card
    (phase 29 in the module docstring), in phase 26's directory `d`;
    returns each command's figures as phase26_cli does, with its
    uploads."""
    import hashlib
    import json
    import numpy as np
    import torch
    from ffmpeg_tpu_torch import testing as fx
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.io import open_input
    t_phase = time.monotonic()
    gold = json.loads(fx.CLI_GOLDEN.read_text())
    fx.write_image_sources(d)
    cli = CliRuns(29, dev, card, fx.image_commands(d))
    rows = cli.rows

    def sha(path: Path) -> str:
        return hashlib.sha256(path.read_bytes()).hexdigest()

    def run(name: str, frames: int, planes: int) -> dict:
        """Runs `name` and checks one upload a picture and `planes`
        plane copies to the host a frame (the encoder's)."""
        with Uploads(dev) as up:
            r = cli.run(name, frames)
        r["uploads"] = up.n
        if up.n != frames or r["copies"] != planes * frames:
            raise RuntimeError(f"phase 29 ({name}): {up.n} uploads and "
                               f"{r['copies']} plane copies for {frames} "
                               f"pictures, not one upload and {planes} "
                               f"copies a picture")
        return r

    def report(name: str, what: str, check: str, direct: str = "") -> None:
        r = rows[name]
        cli.report(name, what, f"{check}; {r['uploads']} uploads "
                   f"({r['uploads'] / r['frames']:.2f} a picture)", direct)

    # (r) the image encoders at 1920x1080 (QOI 480x270) and back
    srcs = {"rgb": (d / "src.rgb").read_bytes(),
            "rgba": (d / "src.rgba").read_bytes()}
    for ext, pix, n in [(e, "rgb", 3) for e in fx.IMAGE_ENCODES] + [
            ("qoi", "rgba", 4)]:
        size = (f"{fx.IMAGE_W}x{fx.IMAGE_H}" if pix == "rgb"
                else f"{fx.QOI_W}x{fx.QOI_H}")
        run(f"r_{ext}", 1, n)
        if sha(d / f"out.{ext}") != gold["r_sha256"][f"out.{ext}"]:
            raise RuntimeError(f"phase 29 (r_{ext}): out.{ext} differs "
                               f"from the reference CLI's (sha256)")
        report(f"r_{ext}", f"a {size} {pix}{'24' if n == 3 else ''} "
               f"picture to {ext}", f"{(d / f'out.{ext}').stat().st_size} "
               f"bytes, sha256 equal to the reference CLI's")
        back = f"r_{ext}_{pix}" if ext == "qoi" else f"r_{ext}_rgb"
        run(back, 1, n)
        out = d / f"out_{ext}.{pix}"
        if out.read_bytes() != srcs[pix]:
            raise RuntimeError(f"phase 29 ({back}): the decode differs "
                               f"from the source")
        report(back, f"out.{ext} to rawvideo {pix}",
               "byte-equal to the source (lossless), as the reference "
               "CLI's")

    # (r_exr) the half-float EXR to float planes
    run("r_exr", 1, 3)
    if sha(d / "out_exr.raw") != gold["r_exr_sha256"]:
        raise RuntimeError("phase 29 (r_exr): differs from the reference "
                           "CLI's (sha256)")
    report("r_exr", f"the committed {fx.EXR_W}x{fx.EXR_H} half-float ZIP "
           "EXR to gbrpf32le", "sha256 equal to the reference CLI's "
           "(bit-equal float32)")

    # (s) FFV1 in Matroska and back, and the committed streams
    n = fx.FFV1_FRAMES
    run("s_enc", n, 3)
    if sha(d / "out_ffv1.mkv") != gold["s_mkv_sha256"]:
        raise RuntimeError("phase 29 (s_enc): out_ffv1.mkv differs from "
                           "the reference CLI's (sha256)")
    report("s_enc", f"{n} frames of mpeg2_clip at {fx.FFV1_W}x{fx.FFV1_H} "
           "to FFV1 in Matroska", "file (and so its packets) equal to the "
           "reference CLI's (sha256)")
    run("s_md5", n, 3)
    text = (d / "out_ffv1.md5").read_text()
    if text != gold["s_framemd5"] or \
            _framemd5s(text) != fx.image_source_md5s():
        raise RuntimeError("phase 29 (s_md5): the framemd5 differs from "
                           "the reference CLI's or from the source's")
    report("s_md5", "out_ffv1.mkv to framemd5", "text equal to the "
           "reference CLI's, each md5 the source frame's (lossless)")
    for name in fx.CLI_FFV1_STREAMS:
        run(f"s_{name}", 8, 3)
        got = sha(d / f"out_ffv1_{name}.yuv")
        if got != fx.image_golden(f"ffv1_{name}") or \
                got != gold["s_raw_sha256"][name]:
            raise RuntimeError(f"phase 29 (s_{name}): differs from the "
                               f"reference binary's decode (sha256)")
        report(f"s_{name}", f"the committed 112x80 FFV1 {name} stream (8 "
               "frames) to rawvideo", "sha256 equal to the reference "
               "binary's and CLI's decode")

    # (t) the VP8 clip to framemd5, and to MPEG-2 with K2
    run("t_md5", 4, 3)
    if (d / "out_vp8.md5").read_text() != gold["t_framemd5"]:
        raise RuntimeError("phase 29 (t_md5): the framemd5 differs from "
                           "the reference CLI's golden")
    report("t_md5", f"the committed {fx.VP8_W}x{fx.VP8_H} VP8 clip (a "
           "keyframe and 3 inter frames, loop filter on) to framemd5",
           "text equal to the reference CLI's golden")
    r = run("t_m2v", 4, 3)
    dm = open_input(str(d / "out_vp8_m2v.mkv"))
    pk = list(dm.packets())
    dm.close()
    got = [p.data for p in pk]
    n_p = sum(1 for p in pk if not p.flags & 1)
    if r["k2"] != n_p or n_p < 1:
        raise RuntimeError(f"phase 29 (t_m2v): K2 launched {r['k2']} "
                           f"times for {n_p} P frames")
    par, frames = fx.cli_encoder_input(d / "vp8.ivf", "mpeg2video", dev)
    want, k2_err, k2_shape, direct_ms = _direct_mpeg2(
        par, frames, dev, n_p, "phase 29 (t_m2v)")
    r["k2_err"] = k2_err
    ref_bytes = gold["t_m2v_packet_bytes"]
    rel = max(abs(len(a) / b - 1) for a, b in zip(got, ref_bytes))
    if got != want or len(got) != len(ref_bytes) or rel > 0.01:
        raise RuntimeError(f"phase 29 (t_m2v): packets "
                           f"{[len(x) for x in got]} against the direct "
                           f"encode's {[len(x) for x in want]} and the "
                           f"reference's {ref_bytes}")
    report("t_m2v", "the VP8 clip to MPEG-2 in Matroska", f"packets "
           f"{[len(x) for x in got]} B byte-equal to open_encoder("
           f"'mpeg2video') on the card on the same decoded frames, within "
           f"{rel:.3%} of the reference's {ref_bytes}; K2 once per P "
           f"frame ({n_p}), bit-exact against its plain version on the "
           f"encoder's {n_p} {k2_shape} pairs (max |diff| {k2_err})",
           f" (the direct encode {direct_ms:.1f} ms)")

    # (u) the lossy WebP, and lossless WebP of a seeded picture
    run("u_webp", 1, 3)
    if sha(d / "out_webp.yuv") != gold["u_webp_sha256"]:
        raise RuntimeError("phase 29 (u_webp): differs from the reference "
                           "CLI's (sha256)")
    report("u_webp", "the lossy WebP of the clip's keyframe to rawvideo",
           "sha256 equal to the reference CLI's")
    run("u_ll", 1, 4)
    if sha(d / "out_ll.webp") != gold["u_ll_sha256"]:
        raise RuntimeError("phase 29 (u_ll): out_ll.webp differs from the "
                           "reference CLI's (sha256)")
    dm = open_input(str(d / "out_ll.webp"))
    pkts = list(dm.packets())
    dm.close()
    with Uploads(dev) as up:
        f = CodecContext.open_decoder(dm.streams[0].codecpar, device=dev
                                      ).decode_all(pkts)[0]
    px = f.planes[0].cpu().numpy().reshape(fx.WEBP_LL_H, fx.WEBP_LL_W, 4)
    src = np.frombuffer((d / "src_ll.rgba").read_bytes(), np.uint8)
    if f.planes[0].device.type != torch.device(dev).type or up.n != 1 or \
            not np.array_equal(px, src.reshape(px.shape)[..., [3, 0, 1, 2]]):
        raise RuntimeError("phase 29 (u_ll): open_decoder('webp') on the "
                           "card does not give the source's pixels")
    report("u_ll", f"a {fx.WEBP_LL_W}x{fx.WEBP_LL_H} rgba picture to "
           "lossless WebP", "sha256 equal to the reference CLI's; "
           "open_decoder('webp') on the card gives its pixels back (argb, "
           "one upload)")

    # (v) the probes
    for f in fx.IMAGE_PROBE_FILES:
        text = cli.probe_text(d / f, fx.IMAGE_PROBE_ARGS)
        if text.replace(str(d / f), "{path}") != gold["v_probe"][f]:
            raise RuntimeError(f"phase 29 (v): the probe of {f} differs "
                               f"from the reference's")
    print(f"phase 29 (v) [{card}]: fftpu-probe "
          f"{' '.join(fx.IMAGE_PROBE_ARGS)} of "
          f"{', '.join(fx.IMAGE_PROBE_FILES)} equal to the reference's "
          f"text but for the paths", flush=True)
    if any(r["k1"] for r in rows.values()) or any(
            r["k2"] for k, r in rows.items() if k != "t_m2v"):
        raise RuntimeError("phase 29 launched K1, or K2 outside (t_m2v)")
    print(f"phase 29 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)
    return rows


def phase30_bsf_av1_vvc(dev, card, d: Path, flagship) -> dict:
    """The CLI's bitstream filters, AV1 and VVC on the card, and the
    flagship through the host Pipeline (phase 30 in the module
    docstring), in phase 26's directory `d`; `flagship` is phase 4's
    output.  Returns each command's figures as phase26_cli does, with
    (z)'s K1 launches and error."""
    import hashlib
    import json
    import numpy as np
    import torch
    from ffmpeg_tpu_torch import testing as fx
    from ffmpeg_tpu_torch.cli import ffmpeg as fcli
    from ffmpeg_tpu_torch.codecs import CodecContext
    from ffmpeg_tpu_torch.core.packet import Packet
    from ffmpeg_tpu_torch.io import open_input
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    from ffmpeg_tpu_torch.io.stream import CodecParameters
    from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline, TpuEntropySpec)
    from ffmpeg_tpu_torch.ops import huffman
    from ffmpeg_tpu_torch.parallel.pipeline import Pipeline
    t_phase = time.monotonic()
    gold = json.loads(fx.CLI_GOLDEN.read_text())
    fx.write_vvc_av1_sources(d)
    cmds = fx.bsf_av1_vvc_commands(d)
    cli = CliRuns(30, dev, card, cmds)
    rows = cli.rows

    def sha(path: Path) -> str:
        return hashlib.sha256(path.read_bytes()).hexdigest()

    def copied(name: str, what: str, frames: int = 0) -> None:
        """Runs a stream-copy command: its output's sha256 the reference
        CLI's, no upload and no plane copy."""
        with Uploads(dev) as up:
            r = cli.run(name, frames)
        out = d / fx.BSF_FILES[name]
        if sha(out) != gold["w_sha256"][name] or up.n or r["copies"]:
            raise RuntimeError(f"phase 30 ({name}): {out.name} differs from "
                               f"the reference CLI's (sha256), or {up.n} "
                               f"uploads and {r['copies']} plane copies")
        cli.report(name, what, f"{out.stat().st_size} bytes, sha256 equal "
                   f"to the reference CLI's; no upload")

    # (w) the bitstream filters
    copied("w_h264", "phase 26 (c)'s MP4 of the 1920x1088 H.264 stream "
           "through h264_mp4toannexb into MPEG-TS")
    copied("w_hevc_mp4", "the 1080p HEVC bench stream copied into MP4")
    copied("w_hevc", "its MP4 through hevc_mp4toannexb into MPEG-TS")
    copied("w_vp9", "the 100-frame 1080p VP9 bench stream through "
           "vp9_superframe_split")
    copied("w_noise", f"{fx.BSF_FRAMES} frames of mpeg2_clip at "
           f"{fx.BSF_W}x{fx.BSF_H} (y4m) through noise=amount=50:seed=7")
    copied("w_setts", "the H.264 MP4 through setts=offset=7 to packet "
           "framemd5")
    copied("w_dts2pts", "the H.264 MP4 through dts2pts to packet framemd5")
    if (d / "noise.y4m").read_bytes() == (d / "bsf_clip.y4m").read_bytes():
        raise RuntimeError("phase 30 (w_noise): the noise filter changed "
                           "nothing")
    rc = fcli.main(cmds["w_unknown"], device=dev)
    try:
        fcli.transcode(fcli.parse_args(cmds["w_unknown"]), dev)
        err = None
    except Exception as e:               # noqa: BLE001 — its class kept
        err = type(e).__name__
    if rc != 1 or err != gold["w_refused"]["w_unknown"]:
        raise RuntimeError(f"phase 30 (w_unknown): returned {rc}, raised "
                           f"{err}, not as the reference CLI")
    print(f"phase 30 (w_unknown) [{card}]: -bsf:v nosuch_bsf refused as "
          f"the reference CLI refuses it (return code 1, {err})",
          flush=True)

    # (x) AV1: copies, filters, probe and the shell decoder
    units = fx.av1_units()
    for name, ext in (("x_ivf", "ivf"), ("x_mp4", "mp4"), ("x_mkv", "mkv")):
        copied(name, f"the {fx.AV1_W}x{fx.AV1_H} AV1 OBU stream "
               f"({len(units)} temporal units) copied into {ext}",
               len(units))
        dm = open_input(str(d / f"av1.{ext}"))
        if [bytes(p.data) for p in dm.packets()] != units:
            raise RuntimeError(f"phase 30 ({name}): the packets read back "
                               f"are not the stream's units")
        dm.close()
    copied("x_split", "the AV1 stream through av1_frame_split")
    copied("x_meta", "the AV1 stream through av1_metadata=color_range=pc:"
           "color_primaries=9")
    text = cli.probe_text(d / "av1.ivf", fx.AV1_PROBE_ARGS)
    if text.replace(str(d / "av1.ivf"), "{path}") != gold["x_probe"]:
        raise RuntimeError("phase 30 (x): the probe of av1.ivf differs "
                           "from the reference's")
    dm = open_input(str(d / "av1.obu"))
    try:
        CodecContext.open_decoder(dm.streams[0].codecpar, device=dev
                                  ).decode_all(list(dm.packets()))
        err = None
    except Exception as e:               # noqa: BLE001 — its class kept
        err = [type(e).__name__, str(e)]
    dm.close()
    if err != gold["x_decode_error"]:
        raise RuntimeError(f"phase 30 (x): the AV1 decode gave {err}, not "
                           f"the reference's {gold['x_decode_error']}")
    print(f"phase 30 (x) [{card}]: fftpu-probe "
          f"{' '.join(fx.AV1_PROBE_ARGS)} of av1.ivf equal to the "
          f"reference's text but for the path; open_decoder('av1') on the "
          f"card raises the reference's {err[0]} after parsing the "
          f"headers", flush=True)

    # (y) VVC: framemd5 with one upload a picture, the direct decodes
    def vvc(name: str, frames: int, what: str, key: str) -> None:
        with Uploads(dev) as up:
            r = cli.run(name, frames)
        r["uploads"] = up.n
        out = d / cmds[name][-1].rsplit("/", 1)[-1]
        if out.read_text() != gold[key] or up.n != frames or \
                r["copies"] != 3 * frames:
            raise RuntimeError(f"phase 30 ({name}): the framemd5 differs "
                               f"from the reference CLI's, or {up.n} "
                               f"uploads and {r['copies']} plane copies for "
                               f"{frames} pictures")
        cli.report(name, what, f"text equal to the reference CLI's; "
                   f"{up.n} uploads (1.00 a picture)")
    vvc("y_md5", 4, f"the {fx.VVC_GOPS['vvc_832x480'][2]}x"
        f"{fx.VVC_GOPS['vvc_832x480'][3]} VVC GOP (I P B B, MTT, two "
        "references in each list) to framemd5", "y_framemd5")
    vvc("y_10", 4, "the 416x240 10-bit VVC GOP to framemd5",
        "y_10_framemd5")
    # the direct decodes: serial (what the CLI's MPEG-2 encoder is fed,
    # testing.cli_encoder_input), threads=4, and the 10-bit GOP
    walls, decoded = {}, {}
    for name, threads, path in (("vvc_832x480", 1, "vvc.266"),
                                ("vvc_832x480", 4, None),
                                ("vvc10_416x240", 1, None)):
        with Uploads(dev) as up:
            t = time.perf_counter()
            if path:
                par, frames = fx.cli_encoder_input(d / path, "mpeg2video",
                                                   dev)
            else:
                frames = CodecContext.open_decoder(
                    CodecParameters(codec_id="vvc"), {"threads": threads},
                    device=dev).decode_all([Packet(
                        data=fx.vvc_av1_stream(name), pts=0)])
            torch.cuda.synchronize()
            walls[(name, threads)] = time.perf_counter() - t
        got = [hashlib.sha256(p.cpu().numpy().tobytes()).hexdigest()
               for f in frames for p in f.planes]
        if up.n != len(frames) or got != fx.vvc_golden(name) or any(
                p.device.type != torch.device(dev).type
                for f in frames for p in f.planes):
            raise RuntimeError(f"phase 30 (y): open_decoder('vvc', "
                               f"threads={threads}) of {name} on the card: "
                               f"{up.n} uploads, planes not the reference's "
                               f"sha256 or off the card")
        decoded[(name, threads)] = frames
    serial = decoded[("vvc_832x480", 1)]
    if not all(torch.equal(a, b) for f, g in zip(
            decoded[("vvc_832x480", 4)], serial)
            for a, b in zip(f.planes, g.planes)):
        raise RuntimeError("phase 30 (y): threads=4 differs from the "
                           "serial decode")
    n8 = len(serial)
    print(f"phase 30 (y) [{card}]: open_decoder('vvc') on the card, every "
          f"plane the reference's sha256, one upload a picture: 832x480 "
          f"serial {n8 / walls[('vvc_832x480', 1)]:.3f} frames/s "
          f"({walls[('vvc_832x480', 1)] * 1e3:.1f} ms), threads=4 "
          f"{n8 / walls[('vvc_832x480', 4)]:.3f} frames/s "
          f"({walls[('vvc_832x480', 4)] * 1e3:.1f} ms), byte-equal to the "
          f"serial decode; 416x240 10-bit (yuv420p10le, torch.uint16 "
          f"planes) {4 / walls[('vvc10_416x240', 1)]:.3f} frames/s",
          flush=True)
    with Uploads(dev) as up:
        r = cli.run("y_m2v", 4)
    r["uploads"] = up.n
    dm = open_input(str(d / "out_vvc_m2v.mkv"))
    pk = list(dm.packets())
    dm.close()
    got = [p.data for p in pk]
    n_p = sum(1 for p in pk if not p.flags & 1)
    if r["k2"] != n_p or n_p < 1 or up.n != 4:
        raise RuntimeError(f"phase 30 (y_m2v): K2 launched {r['k2']} times "
                           f"for {n_p} P frames, {up.n} uploads")
    want, k2_err, k2_shape, direct_ms = _direct_mpeg2(
        par, serial, dev, n_p, "phase 30 (y_m2v)")
    r["k2_err"] = k2_err
    ref_bytes = gold["y_m2v_packet_bytes"]
    rel = max(abs(len(a) / b - 1) for a, b in zip(got, ref_bytes))
    if got != want or len(got) != len(ref_bytes) or rel > 0.01:
        raise RuntimeError(f"phase 30 (y_m2v): packets "
                           f"{[len(x) for x in got]} against the direct "
                           f"encode's {[len(x) for x in want]} and the "
                           f"reference's {ref_bytes}")
    cli.report("y_m2v", "the 832x480 VVC GOP to MPEG-2 in Matroska",
               f"packets {[len(x) for x in got]} B byte-equal to "
               f"open_encoder('mpeg2video') on the card on the same decoded "
               f"frames, within {rel:.3%} of the reference's {ref_bytes}; "
               f"K2 once per P frame ({n_p}), bit-exact against its plain "
               f"version on the encoder's {n_p} {k2_shape} pairs (max "
               f"|diff| {k2_err}); {up.n} uploads (1.00 a picture)",
               f" (the direct encode {direct_ms:.1f} ms)")
    if any(r["k1"] for r in rows.values()) or any(
            r["k2"] for k, r in rows.items() if k != "y_m2v"):
        raise RuntimeError("phase 30 launched K1, or K2 outside (y_m2v)")

    # (z) the flagship through the host Pipeline: prep | device stage
    pkts = split_packets(fx.FIXTURE.read_bytes())
    spec = TpuEntropySpec(fx.W, fx.H, fx.OUT, fx.OUT, batch=fx.BATCH,
                          stride=fx.STRIDE, packed_cap=fx.packed_cap(pkts))
    pipes = [MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=dev)
             for _ in range(3)]
    for pipe in pipes:                       # warm: not in the pass
        for i, p in enumerate(pkts):
            pipe.prep_frame(p, i)
        pipe.run_batch()
    torch.cuda.synchronize()
    # prep_frame waits only for its own pipeline's last copy to the card,
    # and with queue size 1 prep runs at most two batches ahead of
    # run_batch: three pipelines in turn keep each staged batch until its
    # run_batch has copied it
    n_batches = 8
    turn = iter(pipes * n_batches)

    def prep(batch):                         # host: stage the next batch
        pipe = next(turn)
        for i, p in enumerate(batch):
            pipe.prep_frame(p, i)
        return pipe

    def run(pipe):                           # card: decode, copy back
        return np.stack([c.cpu().numpy() for c in pipe.run_batch()])
    zero_counts()
    pl = Pipeline((pkts for _ in range(n_batches)), [prep, run],
                  queue_size=1, names=["prep", "device"])
    t = time.perf_counter()
    outs = list(pl.run())
    wall = time.perf_counter() - t
    k1 = huffman.KERNEL_LAUNCHES
    if len(outs) != n_batches or k1 != n_batches:
        raise RuntimeError(f"phase 30 (z): {len(outs)} batches, K1 launched "
                           f"{k1} times, not once for each of {n_batches}")
    for j, o in enumerate(outs):
        if not np.array_equal(o, flagship):
            raise RuntimeError(f"phase 30 (z): batch {j} differs from "
                               f"phase 4's output")
    k1_err = 0
    for pipe in pipes:
        regions = torch.from_numpy(pipe.regions).to(dev)
        lens, luts = pipe.program.split_regions(regions)
        a = huffman.jpeg_scan_decode_packed(regions, lens, luts, pipe.hdr)
        b = huffman.decode_packed_plain(regions, lens, luts, pipe.hdr)
        torch.cuda.synchronize()
        k1_err = max(k1_err, int((a.int() - b.int()).abs().max()))
        if not torch.equal(a, b):
            raise RuntimeError(f"phase 30 (z): K1 differs from its plain "
                               f"version on a staged batch: max |diff| "
                               f"{k1_err}")
    busy = {st.name: st.busy_s for st in pl.stats}
    work = busy["prep"] + busy["device"]
    rows["z"] = {"k1": k1, "k1_err": k1_err, "wall": wall}
    print(f"phase 30 (z) [{card}]: {n_batches} batches of {fx.BATCH} "
          f"1920x1080 frames through parallel/pipeline.Pipeline (host "
          f"prep_frame | run_batch and the copy back, queue size 1, three "
          f"staging pipelines in turn): every batch equal to phase 4's "
          f"output; K1 launched {k1} times (once a batch), bit-exact "
          f"against its plain version on each pipeline's staged batch "
          f"(max |diff| {k1_err}); wall {wall * 1e3:.1f} ms "
          f"({n_batches * fx.BATCH / wall:.2f} frames/s) against the "
          f"stages' busy time (Pipeline.stats; the source's includes its "
          f"waits on the full queue) "
          + ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in busy.items())
          + f"; prep + device {work * 1e3:.1f} ms, "
          f"{work / wall:.2f}x the wall", flush=True)
    print(f"phase 30 wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)
    return rows


def _blocky_plane(rng, h: int, w: int):
    """Per-8x8 constant + noise: content whose block edges filter."""
    import numpy as np
    base = rng.integers(0, 255, (-(-h // 8), w // 8)).repeat(8, 0).repeat(
        8, 1)[:h]
    return np.clip(base + rng.integers(-3, 4, (h, w)), 0, 255).astype(
        np.uint8)


def _sharded_deblock_check(plane, n: int, devices, what: str) -> float:
    """sharded_deblock of `plane` over n positions of `devices` against
    deblock_plane on the whole plane, bit for bit; returns its ms (CUDA
    events on the first position's card, mean of 3)."""
    import torch
    from ffmpeg_tpu_torch.ops.deblock import deblock_plane
    from ffmpeg_tpu_torch.parallel.halo import sharded_deblock
    from ffmpeg_tpu_torch.parallel.mesh import make_mesh
    from ffmpeg_tpu_torch.timing import cuda_ms
    mesh = make_mesh(n, spatial=n, devices=devices)
    got = sharded_deblock(plane, mesh)
    want = deblock_plane(plane)
    if not (torch.equal(got, want) and got.device == plane.device):
        raise RuntimeError(f"phase 31 (a): sharded_deblock differs from "
                           f"deblock_plane ({what})")
    if torch.equal(want, plane):
        raise RuntimeError(f"phase 31 (a): the filter left {what} as it was")
    return cuda_ms(lambda: sharded_deblock(plane, mesh), 3)


def _sharded_filters_check(key, n: int, devices, what: str) -> float:
    """sharded_filters of phase 15's keyframe over n positions of
    `devices` against filters_tpu on the card, bit for bit; returns its
    ms (CUDA events, mean of 3)."""
    import copy
    import torch
    from ffmpeg_tpu_torch.codecs.hevc.filter_tpu import sharded_filters
    from ffmpeg_tpu_torch.parallel.mesh import make_mesh
    from ffmpeg_tpu_torch.timing import cuda_ms
    dec = copy.copy(key["dec"])
    dec.y, dec.u, dec.v = key["pre"]
    mesh = make_mesh(n, spatial=n, devices=devices)
    got = sharded_filters(dec, mesh)
    for name, g, w in zip("yuv", got, key["out"]):
        if not torch.equal(g.to(w.device), w):
            raise RuntimeError(f"phase 31 (c): sharded_filters differs from "
                               f"filters_tpu ({what}, {name})")
    return cuda_ms(lambda: sharded_filters(dec, mesh), 3)


def phase31_alone(dev, card) -> None:
    """Phase 31 without the phases before it: the keyframes of phases 13
    and 15 taken as those phases take them, then phase 31 (its sharded
    VP9 filter over 3 positions too)."""
    from ffmpeg_tpu_torch.core.packet import Packet
    from ffmpeg_tpu_torch.io.ivf import read_ivf
    from ffmpeg_tpu_torch.testing import HEVC_SAO, VP9_LF, hevc_pictures
    _par, _tb, lpkts = read_ivf(VP9_LF.read_bytes())
    lf_key = dict(vp9_lf_keyframe(dev, lpkts[0].data), tpu_ms=float("nan"))
    sctx = _hevc_open(dev)
    sctx.decode_all([Packet(data=hevc_pictures(HEVC_SAO.read_bytes())[0],
                            pts=0)])
    phase31_multidevice(dev, card, lf_key,
                        hevc_sao_keyframe(dev, *sctx.codec.capture[0]))


def phase31_multidevice(dev, card, lf_key, hevc_key) -> None:
    """The multi-device layer with every mesh position on the card (phase
    31 in the module docstring): (a) sharded_deblock, (b) the sharded VP9
    loop filter on phase 13's 1080p keyframe, (c) sharded_filters on
    phase 15's 1080p keyframe, (d) entry.dryrun_multichip(8), (e) (a)
    and (c) over distinct cards where more than one is visible."""
    import copy
    import numpy as np
    import torch
    from ffmpeg_tpu_torch import entry
    from ffmpeg_tpu_torch.codecs.hevc.filter_tpu import filters_tpu
    from ffmpeg_tpu_torch.codecs.vp9 import lf_tpu
    from ffmpeg_tpu_torch.codecs.vp9.lf_sharded import loopfilter_sharded
    from ffmpeg_tpu_torch.ops.deblock import deblock_plane
    from ffmpeg_tpu_torch.parallel.mesh import make_mesh
    from ffmpeg_tpu_torch.timing import cuda_ms
    t_phase = time.monotonic()
    zero_counts()
    rng = np.random.default_rng(31)

    # (a) row-sharded deblock: 1088x1920 over 4 positions, 1080x1920 over 3
    a_ms = {}
    for h, n in ((1088, 4), (1080, 3)):
        plane = torch.from_numpy(_blocky_plane(rng, h, 1920)).to(dev)
        a_ms[(h, n)] = _sharded_deblock_check(plane, n, [dev] * n,
                                              f"{h}x1920 over {n}")
    whole_ms = cuda_ms(lambda: deblock_plane(plane), 3)
    print(f"phase 31 (a) [{card}]: sharded_deblock of seeded blocky planes "
          f"equal to deblock_plane on the whole plane: 1088x1920 over 4 "
          f"positions {a_ms[(1088, 4)]:.3f} ms, 1080x1920 over 3 "
          f"{a_ms[(1080, 3)]:.3f} ms, against deblock_plane's "
          f"{whole_ms:.3f} ms on the 1080x1920 plane (CUDA events, mean of "
          f"3)", flush=True)

    # (b) the sharded VP9 loop filter on phase 13's keyframe
    def vp9_run(n):
        fs = copy.copy(lf_key["fs"])
        fs.y, fs.u, fs.v = (p.copy() for p in lf_key["pre"])
        # count the edge_filter calls of this run by wrapping the callee
        calls, edge = [0], lf_tpu.edge_filter

        def counted(*a):
            calls[0] += 1
            return edge(*a)
        lf_tpu.edge_filter = counted
        try:
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = loopfilter_sharded(fs, make_mesh(n, spatial=n,
                                                   devices=[dev] * n))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t) * 1e3
        finally:
            lf_tpu.edge_filter = edge
        for name, a, b, o in zip("yuv", lf_key["host"], (fs.y, fs.u, fs.v),
                                 out):
            if not (np.array_equal(a, b) and o.device == dev
                    and np.array_equal(o.cpu().numpy(), a)):
                raise RuntimeError(f"phase 31 (b): loopfilter_sharded over "
                                   f"{n} differs from lf.loopfilter_frame "
                                   f"({name})")
        return ms, calls[0]
    b_ms = {2: vp9_run(2)}
    # n = 3 only while the script stays well inside its 1200 s limit
    if time.monotonic() - T0 + 1.2 * b_ms[2][0] / 1e3 < 1080:
        b_ms[3] = vp9_run(3)
    # the launches of one edge_filter call, by torch.profiler: the host's
    # launch calls (a session after the script's earlier ones may miss
    # some of the device's records, so the kernels it saw are printed
    # beside them)
    s = torch.randint(0, 256, (64, 16), dtype=torch.int32, device=dev)
    z = torch.full((64,), 8, dtype=torch.int32, device=dev)
    dev_k, api = profile_device(lambda: lf_tpu.edge_filter(
        s, z * 4, z, z, z, z > 0))
    k_edge = sum(1 for name, _ in dev_k
                 if not name.startswith(("Memcpy", "Memset")))
    edge_us = sum(us for _, us in dev_k)
    runs = "; ".join(
        f"over {n} positions {ms:.1f} ms, {calls} edge_filter calls "
        f"(~{calls * api} launches, derived; "
        f"{ms * 1e3 / calls:.1f} us of wall a call)"
        for n, (ms, calls) in b_ms.items())
    print(f"phase 31 (b) [{card}]: loopfilter_sharded on phase 13's "
          f"1920x1080 loop-filter keyframe (30 SB columns, 17 SB rows) "
          f"equal to lf.loopfilter_frame: {runs}"
          + ("" if 3 in b_ms else "; over 3 positions skipped (the "
             "script's 1200 s limit)")
          + f"; loopfilter_frame_tpu {lf_key['tpu_ms']:.1f} ms (phase 13); "
          f"one edge_filter call {api} launch calls on the host, the "
          f"trace's device records {k_edge} kernels, {edge_us:.1f} us busy "
          f"(torch.profiler)",
          flush=True)

    # (c) the HEVC filters in 4 tile columns (15 CTB columns each)
    c_ms = _sharded_filters_check(hevc_key, 4, [dev] * 4, "4 positions")
    f_ms = cuda_ms(lambda: filters_tpu(hevc_key["dec"], *hevc_key["pre"]),
                   3)
    print(f"phase 31 (c) [{card}]: sharded_filters on phase 15's 1920x1080 "
          f"SAO + deblock keyframe over 4 positions (60 CTB columns, 15 "
          f"each) equal to filters_tpu on the card: {c_ms:.3f} ms against "
          f"filters_tpu's {f_ms:.3f} ms (CUDA events, mean of 3; "
          f"{hevc_key['filt_ms']:.3f} ms in phase 15)", flush=True)

    # (d) the dryrun, eight positions of the card
    t = time.perf_counter()
    legs = entry.dryrun_multichip(8, device=dev)
    torch.cuda.synchronize()
    d_ms = (time.perf_counter() - t) * 1e3
    lsb = legs["decode_scale_diff"]
    print(f"phase 31 (d) [{card}]: entry.dryrun_multichip(8) on the card, "
          f"mesh (4, 2): its 5 legs each equal to its unsharded "
          f"counterpart (decode->scale within 1 LSB on <= "
          f"{entry.DRYRUN_LSB_SHARE:.1%} of samples: {lsb['differ']} of "
          f"{lsb['samples']} samples differ, max |diff| {lsb['max']}; the "
          f"others bit-exact) in {d_ms:.1f} ms, wall", flush=True)

    # (e) distinct cards
    nc = torch.cuda.device_count()
    if nc > 1:
        cards = [torch.device("cuda", i) for i in range(nc)]
        plane = torch.from_numpy(_blocky_plane(rng, 8 * 16 * nc,
                                               1920)).to(dev)
        e_a = _sharded_deblock_check(plane, nc, cards, f"over {nc} cards")
        e_c = (_sharded_filters_check(hevc_key, nc, cards, f"{nc} cards")
               if 60 % nc == 0 and 1920 % (16 * nc) == 0 else None)
        print(f"phase 31 (e) [{card}]: over {nc} distinct cards: (a) "
              f"{e_a:.3f} ms; (c) "
              + (f"{e_c:.3f} ms" if e_c is not None else
                 f"skipped (60 CTB columns do not split over {nc})"),
              flush=True)
    else:
        print(f"phase 31 (e) [{card}]: one card visible, so no run over "
              f"distinct cards", flush=True)
    counts = read_counts()
    if counts != "K1/K2 launches 0/0":
        raise RuntimeError(f"phase 31: {counts}, not 0/0")
    print(f"phase 31 {counts}; wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)


def phase32_general_scan(dev, card) -> int:
    """ops/huffman.jpeg_scan_decode, the general-length scan decode, on
    the card (phase 32 in the module docstring): (a) the standard-table
    fixture against the C++ host decoder, with its > 9-bit codes shown to
    be decoded; (b) the flagship's 8 frames against K1; (c) its time,
    steps and launches.  Returns K1's launches in this phase (one, (b))."""
    import statistics
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.codecs.mjpeg import _JpegState, _parse_until_scan
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline, TpuEntropySpec)
    from ffmpeg_tpu_torch.ops import huffman
    from ffmpeg_tpu_torch.testing import (BATCH, FIXTURE, H, HUFFMAN_ANNEXK,
                                          OUT, STRIDE, W,
                                          general_scan_inputs, host_decode,
                                          packed_cap)
    from ffmpeg_tpu_torch.timing import cuda_ms
    t_phase = time.monotonic()
    zero_counts()

    def decode(args, what, want=None, oracle="the C++ host decoder"):
        stats = {}
        got = huffman.jpeg_scan_decode(*args, stats=stats)
        torch.cuda.synchronize()
        if got.device != dev or got.dtype != torch.int32:
            raise RuntimeError(f"phase 32: {what} came back as {got.dtype} "
                               f"on {got.device}")
        if want is not None and not np.array_equal(got.cpu().numpy(), want):
            raise RuntimeError(f"phase 32: {what} differs from {oracle}")
        return got, stats["steps"]

    # (a) the Annex K fixture against the C++ host decoder
    pkts = split_packets(HUFFMAN_ANNEXK.read_bytes())
    if len(pkts) != 2:
        raise RuntimeError(f"phase 32: {len(pkts)} standard-table frames")
    steps, cut_diff = [], []
    for i, p in enumerate(pkts):
        st = _JpegState()
        _parse_until_scan(p, st)
        try:
            huffman.build_jpeg_luts9(st)
        except ValueError:
            pass
        else:
            raise RuntimeError("phase 32 (a): the fixture's tables fit K1's "
                               "9 bits")
        args = general_scan_inputs(p, dev)
        got, n = decode(args, f"standard-table frame {i}",
                        host_decode(p).astype(np.int32))
        steps.append(n)
        buf, bitpos, valid, luts = args
        cut = torch.where((luts >> 8) > 9, 0, luts)
        cut_diff.append(int((decode((buf, bitpos, valid, cut),
                                    "the cut tables")[0] != got).sum()))
        if not cut_diff[-1]:
            raise RuntimeError(f"phase 32 (a): frame {i} decodes the same "
                               f"without its codes of over 9 bits")
    lanes = int(args[1].numel())
    print(f"phase 32 (a) [{card}]: jpeg_scan_decode on the 2 standard-table "
          f"(Annex K, codes to 16 bits) 1920x1080 frames, {lanes} lanes "
          f"each, equal to mjpeg_decode_scan; build_jpeg_luts9 refuses both "
          f"frames' tables; with the > 9-bit entries zeroed "
          f"{cut_diff} coefficients differ", flush=True)

    # (b) the flagship's 8 frames against K1
    fpk = split_packets(FIXTURE.read_bytes())
    spec = TpuEntropySpec(W, H, OUT, OUT, batch=BATCH, stride=STRIDE,
                          packed_cap=packed_cap(fpk))
    pipe = MjpegTpuEntropyPipeline(spec, max(fpk, key=len), device=dev)
    for i, p in enumerate(fpk):
        pipe.prep_frame(p, i)
    regions = torch.from_numpy(pipe.regions).to(dev)
    k1 = huffman.jpeg_scan_decode_packed(
        regions, *pipe.program.split_regions(regions), pipe.hdr).cpu().numpy()
    fsteps = [decode(general_scan_inputs(p, dev), f"flagship frame {i}",
                     k1[i], "K1")[1] for i, p in enumerate(fpk)]
    print(f"phase 32 (b) [{card}]: jpeg_scan_decode on the flagship's "
          f"{len(fpk)} frames equal to K1's coefficients (one K1 launch); "
          f"steps {fsteps}", flush=True)

    # (c) time, steps and launches of one standard-table frame
    args = general_scan_inputs(pkts[0], dev)
    ms = statistics.median(cuda_ms(lambda: huffman.jpeg_scan_decode(*args),
                                   1) for _ in range(3))
    dev_k, api = profile_device(lambda: huffman.jpeg_scan_decode(*args))
    print(f"phase 32 (c) [{card}]: one standard-table frame "
          f"{ms:.3f} ms a call (CUDA events, median of 3); {steps} steps "
          f"of max_iter {huffman.BLOCKS_PER_SEG * 130}; one call "
          f"{summarize_launches(dev_k, api, ms)}; "
          f"~{api / max(steps[0], 1):.1f} launch calls a step (derived)",
          flush=True)
    counts = read_counts()
    if counts != "K1/K2 launches 1/0":
        raise RuntimeError(f"phase 32: {counts}, not 1/0")
    print(f"phase 32 {counts}; wall time: {time.monotonic() - t_phase:.1f} s",
          flush=True)
    return huffman.KERNEL_LAUNCHES



def phase33_camera_k1(dev, card) -> dict:
    """K1's camera kernel on the card (phase 33 in the module docstring):
    (a) 64 type-64 1080p frames of the benchmark's generator against the
    generator and the plain version, and random bytes against the plain
    version; (b) the Annex K 4:2:0 fixture, one MCU a segment; (c) its
    time, the plain version's and its bound; (d) the pipeline's
    run_batch.  Returns the kernel's entry of the JSON line."""
    import json as _json
    import numpy as np
    import torch
    from ffmpeg_tpu_torch.io.mjpeg import split_packets
    from ffmpeg_tpu_torch.models.mjpeg_tpu_entropy import (
        MjpegTpuEntropyPipeline, TpuEntropySpec)
    from ffmpeg_tpu_torch.ops import huffman
    from ffmpeg_tpu_torch.testing import HUFFMAN_ANNEXK, host_decode
    from ffmpeg_tpu_torch.timing import cuda_ms, kernel_ms
    from portbench.inputs.rtpjpeg import make_clip
    from portbench.reference.mjpeg422 import Mjpeg422Reference
    t_phase = time.monotonic()
    if huffman.ROWS_KERNEL_LAUNCHES:
        raise RuntimeError(f"phase 33: the camera kernel ran "
                           f"{huffman.ROWS_KERNEL_LAUNCHES} times before it, "
                           f"so K1's tally is not the flagship kernel's")
    zero_counts()

    def stage(pkts, spec):
        pipe = MjpegTpuEntropyPipeline(spec, max(pkts, key=len), device=dev)
        for i, p in enumerate(pkts):
            pipe.prep_frame(p, i)
        regions = torch.from_numpy(pipe.regions).to(dev)
        return pipe, regions, *pipe.program.split_regions(regions)

    def decode(fn, regions, lens, tables, hdr, kw):
        got = fn(regions, lens, tables, hdr, **kw)
        torch.cuda.synchronize()
        return got

    # (a) 64 camera frames: the generator, the plain version, random bytes
    cfg = _json.loads((REPO / "portbench" / "configs"
                       / "rtpjpeg1080_422_rgb224.json").read_text())
    w, h, n = cfg["width"], cfg["height"], CAMERA_FRAMES
    t = time.monotonic()
    clip = make_clip(2 ** 33 + 33, w, h, n, cfg["quality"],
                     cfg["restart_rows"], cfg["luma_texture"],
                     cfg["chroma_texture"], dev)
    make_s = time.monotonic() - t
    spec = TpuEntropySpec(w, h, cfg["out_w"], cfg["out_h"], batch=n,
                          stride=cfg["stride"], out_fmt=cfg["out_fmt"],
                          filter=cfg["filter"])
    pipe, regions, lens, tables = stage(clip.packets, spec)
    kw = dict(mcus_per_seg=cfg["restart_rows"] * (w // 16),
              blocks_per_mcu=4, nmcu=pipe.nmcu)
    got = decode(huffman.jpeg_scan_decode_packed, regions, lens, tables,
                 pipe.hdr, kw)
    if (huffman.KERNEL_LAUNCHES, huffman.ROWS_KERNEL_LAUNCHES) != (1, 1):
        raise RuntimeError(f"phase 33 (a): launches "
                           f"{huffman.KERNEL_LAUNCHES}/"
                           f"{huffman.ROWS_KERNEL_LAUNCHES}, not 1/1")
    for f in range(n):
        if not torch.equal(got[f].long(),
                           clip.frame_coef(f).reshape(-1, 4, 64)):
            raise RuntimeError(f"phase 33 (a): frame {f} differs from the "
                               f"generator's coefficients")
    want = decode(huffman.decode_packed_plain, regions, lens, tables,
                  pipe.hdr, kw)
    err = int((got.int() - want.int()).abs().max())
    if not torch.equal(got, want):
        raise RuntimeError(f"phase 33 (a): differs from the plain version "
                           f"in {int((got != want).sum())} values")
    rng = np.random.default_rng(33)
    junk = regions[:8].clone()
    junk[:, pipe.hdr:] = torch.from_numpy(rng.integers(
        0, 256, tuple(junk[:, pipe.hdr:].shape), dtype=np.uint8)).to(dev)
    jlens = lens[:8].clone()
    jlens[:, ::4] = 0                          # padding lanes
    jgot = decode(huffman.jpeg_scan_decode_packed, junk, jlens, tables[:8],
                  pipe.hdr, kw)
    jwant = decode(huffman.decode_packed_plain, junk, jlens, tables[:8],
                   pipe.hdr, kw)
    if not torch.equal(jgot, jwant):
        raise RuntimeError(f"phase 33 (a): differs from the plain version "
                           f"on random bytes in "
                           f"{int((jgot != jwant).sum())} values")
    err = max(err, int((jgot.int() - jwant.int()).abs().max()))
    print(f"phase 33 (a) [{card}]: {n} type-64 {w}x{h} frames (generated "
          f"in {make_s:.1f} s, {int(clip.symbols.sum())} symbols, "
          f"{int(clip.long_codes.sum())} with codes over 9 bits), "
          f"{lens.shape[1]} segments each, one launch: bit-exact against "
          f"the generator and the plain version (max |diff| {err}); the "
          f"first 8 regions with random scan bytes and every fourth lane "
          f"padding bit-exact against the plain version", flush=True)

    # (b) the Annex K 4:2:0 fixture, one MCU of 6 blocks a segment
    apk = split_packets(HUFFMAN_ANNEXK.read_bytes())
    apipe, areg, alens, atab = stage(apk, TpuEntropySpec(
        1920, 1080, 224, 224, batch=len(apk), stride=192))
    akw = dict(mcus_per_seg=1, blocks_per_mcu=6, nmcu=apipe.nmcu)
    agot = decode(huffman.jpeg_scan_decode_packed, areg, alens, atab,
                  apipe.hdr, akw)
    if not torch.equal(agot, decode(huffman.decode_packed_plain, areg,
                                    alens, atab, apipe.hdr, akw)):
        raise RuntimeError("phase 33 (b): differs from the plain version")
    for i, p in enumerate(apk):
        if not np.array_equal(agot[i].cpu().numpy(), host_decode(p)):
            raise RuntimeError(f"phase 33 (b): frame {i} differs from the "
                               f"C++ host decoder")
    print(f"phase 33 (b) [{card}]: the {len(apk)} Annex K 4:2:0 frames, "
          f"{alens.shape[1]} one-MCU segments each, bit-exact against the "
          f"plain version and mjpeg_decode_scan", flush=True)

    # (c) time, the plain version's, the bound
    ms = kernel_ms(lambda: huffman.jpeg_scan_decode_packed(
        regions, lens, tables, pipe.hdr, **kw), 20)
    nospin_ms = cuda_ms(lambda: huffman.jpeg_scan_decode_packed(
        regions, lens, tables, pipe.hdr, **kw), 20)
    plain_ms = cuda_ms(lambda: huffman.decode_packed_plain(
        regions, lens, tables, pipe.hdr, **kw), 1)
    bound_ms, by = rows_bound(lens, tables, got, int(clip.symbols.sum()))
    print(f"phase 33 (c) [{card}]: {n} frames {ms:.4f} ms (no spin "
          f"{nospin_ms:.4f} ms); plain version {plain_ms:.1f} ms; bound "
          f"{bound_ms:.4f} ms by {by}, {bound_ms / ms:.1%} of it", flush=True)

    # (d) the pipeline's run_batch
    base = (huffman.KERNEL_LAUNCHES, huffman.ROWS_KERNEL_LAUNCHES)
    comps = pipe.run_batch()
    torch.cuda.synchronize()
    launches = (huffman.KERNEL_LAUNCHES - base[0],
                huffman.ROWS_KERNEL_LAUNCHES - base[1])
    if launches != (1, 1):
        raise RuntimeError(f"phase 33 (d): run_batch launched K1's kernels "
                           f"{launches[0]} times, the camera kernel "
                           f"{launches[1]}, not once and once")
    rgb = torch.stack(list(comps), 1)
    ref = Mjpeg422Reference(w, h, cfg["out_w"], cfg["out_h"], clip.q_luma,
                            clip.q_chroma, dev)
    worst = 0.0
    for f in range(2):
        want = ref.rgb(clip.frame_coef(f)).double().clamp(0, 255)
        gap = float((rgb[f].double() - want).abs().max())
        worst = max(worst, gap - 0.5, 0.0)
    if worst >= cfg["check"]["excess_lsb"]:
        raise RuntimeError(f"phase 33 (d): rgb24 {worst} LSB outside the "
                           f"reference's rounding")
    print(f"phase 33 (d) [{card}]: run_batch {tuple(rgb.shape)}: one launch "
          f"of the camera kernel, none of the flagship's; frames 0-1 "
          f"{worst:.3g} LSB outside the float64 reference's rounding "
          f"(limit {cfg['check']['excess_lsb']}); wall time: "
          f"{time.monotonic() - t_phase:.1f} s", flush=True)
    if huffman.KERNEL_LAUNCHES != huffman.ROWS_KERNEL_LAUNCHES:
        raise RuntimeError("phase 33: the flagship kernel ran in it")
    return {"name": "jpeg_scan_decode_packed_rows", "route": "cuda",
            "source": K1_SOURCE, "replaces": ROWS_REPLACES,
            "launches": huffman.ROWS_KERNEL_LAUNCHES, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by, "library_ms": None}


if __name__ == "__main__":
    sys.exit(main())
