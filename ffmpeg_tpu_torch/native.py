"""Builder and loader for the port's host C++ (`csrc/host/`): the MJPEG
scan splitter that feeds K1, the sequential host decoder K1 is held
against, the AAC spectral Huffman decoder and the VP9 tile parse
(counterpart of ffmpeg_tpu/native.py, for the port's own copy of those
four functions).

The splitter, `mjpeg_split_segments`, takes its scan as `bytes` or as an
address (`c_void_p`), so a caller can pass a scan inside a larger buffer
without copying it.  It picks its vector width once, from what the host
CPU reports: `mjpeg_split_isa()` gives 2 (AVX2) or 0 (the portable
path, which `mjpeg_split_segments_portable` runs on any CPU).

At first use `g++` compiles `csrc/host/*.cpp` into one shared library
under `build/ffmpeg_tpu_torch/` at the repository root, named by a
content hash of the sources and flags; `ctypes` loads it.  `CXX_FLAGS`
name no `-march`: the AVX2 code is selected at run time, so the library
loads on any host of its architecture.  A failed build raises; there is
no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

from ._cuda_build import BUILD_DIR

_HOST = Path(__file__).resolve().parent / "csrc" / "host"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    pass


def _sources() -> list[Path]:
    return sorted(list(_HOST.glob("*.cpp")) + list(_HOST.glob("*.h")))


def so_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libffmpeg_tpu_torch_host-{h.hexdigest()[:16]}.so"


def build(so: Path) -> None:
    """Compile csrc/host/*.cpp into `so`; raise NativeBuildError on any
    failure."""
    srcs = [str(p) for p in _sources() if p.suffix == ".cpp"]
    if not srcs:
        raise NativeBuildError(f"no C++ sources under {_HOST}")
    so.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        cmd = ["g++", *CXX_FLAGS, "-o", f"{tmp}/lib.so", *srcs]
        try:
            r = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=BUILD_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise NativeBuildError(f"g++ failed: {e}") from e
        if r.returncode != 0:
            raise NativeBuildError(f"g++ failed ({r.returncode}):\n"
                                   f"{' '.join(cmd)}\n{r.stderr[-4000:]}")
        os.replace(f"{tmp}/lib.so", so)


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    for split in (lib.mjpeg_split_segments,
                  lib.mjpeg_split_segments_portable):
        split.restype = c.c_long
        split.argtypes = [
            c.c_void_p, c.c_long,               # scan (bytes or address), size
            c.POINTER(c.c_uint8), c.c_long,     # out, out_cap
            c.POINTER(c.c_int32), c.c_long,     # seg_offsets, max_segs
        ]
    lib.mjpeg_split_isa.restype = c.c_int
    lib.mjpeg_split_isa.argtypes = []
    lib.mjpeg_decode_scan.restype = c.c_int
    lib.mjpeg_decode_scan.argtypes = [
        c.c_char_p, c.c_long,                   # scan, size
        c.c_char_p, c.c_char_p, c.c_char_p, c.c_char_p,  # DHT counts/values
        c.POINTER(c.c_int), c.c_int,            # comp_spec, ncomp
        c.c_int, c.c_int, c.c_int, c.c_int,     # mcus_x, mcus_y, ri, limit
        c.POINTER(c.POINTER(c.c_int16)),        # out planes
    ]
    lib.aac_decode_spectral.restype = c.c_long
    lib.aac_decode_spectral.argtypes = [
        c.c_char_p, c.c_long, c.c_long,         # data, nbits, pos
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # band_cb, swb_offset
        c.POINTER(c.c_int32), c.c_int, c.c_int, c.c_int,  # group_len, ng,
        #                                         max_sfb, eight_short
        c.POINTER(c.c_int32), c.POINTER(c.c_uint8),  # lut_sym, lut_len
        c.POINTER(c.c_int32), c.POINTER(c.c_int32),  # lut_off, lut_maxlen
        c.POINTER(c.c_int32),                   # out
    ]
    lib.vp9_parse_frame.restype = c.c_long
    lib.vp9_parse_frame.argtypes = [
        c.c_char_p, c.c_long,                   # tile region, size
        c.POINTER(c.c_int32),                   # hdr32
        c.POINTER(c.c_void_p),                  # slot table
    ]


def get() -> ctypes.CDLL:
    """The loaded host library, built first if it is not there."""
    global _lib
    with _lock:
        if _lib is None:
            so = so_path()
            if not so.exists():
                build(so)
            lib = ctypes.CDLL(str(so))
            _bind(lib)
            _lib = lib
        return _lib
