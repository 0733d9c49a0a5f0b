"""Build and load the host (CPU) C++ library of ``isegprobe_torch/csrc/host``.

Every ``csrc/host/*.cpp`` goes into one library: ``jpeg.cpp`` holds the
data layer's host image work (the JPEG decoder and encoder and the PNG row
unfilter of ``data/image_io.py``, the bilinear affine warp of
``data/raster.py``),
``edt.cpp`` the exact distance transform and the click distance maps of
``ops/edt.py`` (the simulated user's and the click sampler's). They have a
plain C interface and are compiled by ``g++ -O2 -shared -fPIC`` at first
use into ``csrc/build/`` (git-ignored), under a name that hashes every
source and the flags, and loaded with ``ctypes``, which releases the GIL
for the length of each call, so loader threads decode, warp and measure
distances in parallel. There is no fallback: a failed build raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CXX_FLAGS", "sources", "library_path", "load", "check"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: list = []


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found: the host library is built "
                           "with it (set CXX or put g++ on PATH)")
    return found


def sources() -> list:
    """The library's sources: every ``csrc/host/*.cpp``, by name."""
    return sorted((CSRC / "host").glob("*.cpp"))


def library_path() -> Path:
    """Where the library lives: its name hashes every source (name and
    bytes) and the flags."""
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    h.update(" ".join(CXX_FLAGS).encode())
    return CSRC / "build" / f"libhost_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run([_cxx(), *CXX_FLAGS, "-o", str(tmp),
                           *map(str, sources())],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)


def load() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    with _lock:
        if _lib:
            return _lib[0]
        out = library_path()
        if not out.exists():
            _build(out)
        lib = ctypes.CDLL(str(out))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        intp = ctypes.POINTER(ctypes.c_int)
        lib.iseg_host_error.argtypes = [ctypes.c_int]
        lib.iseg_host_error.restype = ctypes.c_char_p
        lib.iseg_jpeg_info.argtypes = [u8p, ctypes.c_size_t, intp, intp,
                                       intp, intp]
        lib.iseg_jpeg_info.restype = ctypes.c_int
        lib.iseg_jpeg_decode_rgb.argtypes = [u8p, ctypes.c_size_t, u8p]
        lib.iseg_jpeg_decode_rgb.restype = ctypes.c_int
        lib.iseg_jpeg_encode.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
            ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t)]
        lib.iseg_jpeg_encode.restype = ctypes.c_int
        lib.iseg_png_unfilter.argtypes = [u8p, u8p, ctypes.c_int,
                                          ctypes.c_int, ctypes.c_int]
        lib.iseg_png_unfilter.restype = ctypes.c_int
        lib.iseg_warp_affine_linear.argtypes = [
            u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, u8p,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
        lib.iseg_warp_affine_linear.restype = ctypes.c_int
        f32p = ctypes.POINTER(ctypes.c_float)
        for name in ("edt_l2sq", "edt_l2"):
            getattr(lib, name).argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                           f32p]
            getattr(lib, name).restype = None
        lib.click_dist_maps.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, ctypes.c_float, f32p]
        lib.click_dist_maps.restype = None
        _lib.append(lib)
        return lib


def check(code: int, what: str) -> None:
    """Raise ``ValueError`` naming ``what`` for a nonzero return code."""
    if code:
        msg = load().iseg_host_error(code).decode()
        raise ValueError(f"{what}: {msg}")
