"""Builder and loader for the port's CUDA kernels (the counterpart of
ffmpeg_tpu/native.py, for `csrc/*.cu` instead of the host C++).

At first use, one `nvcc` per `ffmpeg_tpu_torch/csrc/*.cu`, all started
together, compiles each source for Hopper (`sm_90a`), and a last `nvcc`
links the objects into one shared library with a plain C interface under
`build/ffmpeg_tpu_torch/` at the repository root, named by a content hash
of the sources; `ctypes` loads it.  No PyTorch headers are compiled, so a
build takes seconds.  A failed build raises; there is no fallback.

Calling convention of every entry point: device pointers and the CUDA
stream are `c_void_p` (from `tensor.data_ptr()` and
`torch.cuda.current_stream().cuda_stream`), sizes are `c_int`, and the
function returns `cudaGetLastError()` after its launch.  `check` raises
on a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent
_CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "ffmpeg_tpu_torch"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas=-v")
BUILD_TIMEOUT_S = 600

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class CudaBuildError(RuntimeError):
    pass


def _sources() -> list[Path]:
    return sorted(list(_CSRC.glob("*.cu")) + list(_CSRC.glob("*.cuh")))


def so_path() -> Path:
    """Library path keyed by a content hash of csrc/ (git does not keep
    mtimes, so they cannot tell staleness)."""
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libffmpeg_tpu_torch-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise CudaBuildError("nvcc not found (PATH, $CUDA_HOME/bin)")


def _check(cmd: list[str], code: int, out: str) -> None:
    if code != 0:
        raise CudaBuildError(f"nvcc failed ({code}):\n{' '.join(cmd)}\n"
                             f"{out[-4000:]}")


def build(so: Path) -> str:
    """Compile every csrc/*.cu, one `nvcc` each, all started together, and
    link the objects into `so`.  Returns the compilers' messages (ptxas's
    register and shared-memory report for each kernel); raises
    CudaBuildError on any failure and leaves no compiler running."""
    srcs = [p for p in _sources() if p.suffix == ".cu"]
    if not srcs:
        raise CudaBuildError(f"no CUDA sources under {_CSRC}")
    so.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=so.parent) as tmp:
        objs = [f"{tmp}/{p.stem}.o" for p in srcs]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                for p, o in zip(srcs, objs)]
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE, text=True,
                                  stderr=subprocess.STDOUT) for c in cmds]
        try:
            logs = [pr.communicate(timeout=BUILD_TIMEOUT_S)[0] for pr in procs]
        finally:
            for pr in procs:
                pr.kill()  # does nothing to one that has ended
                pr.wait()
        for cmd, pr, out in zip(cmds, procs, logs):
            _check(cmd, pr.returncode, out)
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", f"{tmp}/lib.so", *objs]
        r = subprocess.run(link, capture_output=True, text=True,
                           timeout=BUILD_TIMEOUT_S)
        _check(link, r.returncode, r.stdout + r.stderr)
        os.replace(f"{tmp}/lib.so", so)
    return "".join(logs)


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.jpeg_scan_decode_packed_launch.restype = c.c_int
    lib.jpeg_scan_decode_packed_launch.argtypes = [
        c.c_void_p,            # regions (B, cap) u8
        c.c_int,               # cap
        c.c_void_p,            # lens (B, nmcu) i32
        c.c_int,               # hdr
        c.c_void_p,            # luts: B tables (512, 12) i8
        c.c_longlong,          # lut_stride (bytes between tables)
        c.c_void_p,            # out (B, nmcu, 6, 64) i16
        c.c_int, c.c_int,      # B, nmcu
        c.c_int,               # max_iter
        c.c_void_p,            # cudaStream_t
    ]
    lib.jpeg_scan_decode_packed_rows_launch.restype = c.c_int
    lib.jpeg_scan_decode_packed_rows_launch.argtypes = [
        c.c_void_p,            # regions (B, cap) u8
        c.c_int,               # cap
        c.c_void_p,            # lens (B, nseg) i32
        c.c_longlong,          # lens_stride (int32s between rows)
        c.c_int, c.c_int,      # nseg, hdr
        c.c_void_p,            # tables: B of build_jpeg_tables16
        c.c_longlong,          # table_stride (bytes between tables)
        c.c_void_p,            # out (B, nmcu, bpm, 64) i16
        c.c_int, c.c_int,      # B, nmcu
        c.c_int, c.c_int,      # mcus_per_seg, bpm
        c.c_int,               # max_iter
        c.c_void_p,            # cudaStream_t
    ]
    lib.sad_cost_volume_launch.restype = c.c_int
    lib.sad_cost_volume_launch.argtypes = [
        c.c_void_p,            # cur (h, w) u8 or f32
        c.c_void_p,            # ref (h, w), cur's type
        c.c_int,               # is_float
        c.c_int, c.c_int,      # h, w
        c.c_int, c.c_int,      # block, search
        c.c_void_p,            # out (h/B, w/B, 2R+1, 2R+1) f32
        c.c_void_p,            # cudaStream_t
    ]
    lib.cuda_error_string.restype = c.c_char_p
    lib.cuda_error_string.argtypes = [c.c_int]


def get() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is not there."""
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


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
