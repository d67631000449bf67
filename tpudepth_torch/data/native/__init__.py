"""ctypes binding of the port's C++ batch decoder (``decoder.cpp``).

Counterpart of ``tpudepth/data/native/__init__.py`` with the same entries
(:func:`probe`, :func:`decode_batch`, :func:`decode_batch_raw`). The library
is built with ``g++`` from this package's own ``decoder.cpp`` at first use,
into ``tpudepth_torch/_build/`` under a name that carries the hash of the
source and the flags, and loaded once a process. When the toolchain or the
libjpeg / libpng headers are missing the build fails, every entry returns
None and the datasets decode with Pillow; :func:`build_error` says why.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().with_name("decoder.cpp")
_BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_LIBS = ("-ljpeg", "-lpng", "-lz", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error: Optional[str] = None


def _target() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes())
    digest.update(" ".join(_FLAGS + _LIBS).encode())
    return _BUILD_DIR / f"libdecode-{digest.hexdigest()[:16]}.so"


def _build(target: Path) -> Optional[str]:
    """Compile ``decoder.cpp`` into ``target``; None on success, else the
    reason."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp), *_LIBS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cmd[0]}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        lines = (proc.stderr or proc.stdout).strip().splitlines()
        return lines[0] if lines else f"g++ exited {proc.returncode}"
    os.replace(tmp, target)  # atomic: another process never loads a partial .so
    return None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    bufs = (ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_int)
    lib.tpudepth_decode_batch.restype = ctypes.c_int
    lib.tpudepth_decode_batch.argtypes = [
        *bufs, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tpudepth_decode_batch_raw.restype = ctypes.c_int
    lib.tpudepth_decode_batch_raw.argtypes = [
        *bufs, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.tpudepth_decode_batch_raw_scaled.restype = ctypes.c_int
    lib.tpudepth_decode_batch_raw_scaled.argtypes = [
        *bufs, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.tpudepth_probe.restype = ctypes.c_int
    lib.tpudepth_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The native decoder, built on first use; None when it cannot be built
    or loaded (:func:`build_error` says why)."""
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        target = _target()
        if not target.is_file():
            _error = _build(target)
            if _error is not None:
                return None
        try:
            _lib = _bind(ctypes.CDLL(str(target)))
        except OSError as e:
            _error = str(e)
        return _lib


def build_error() -> Optional[str]:
    """Why the native decoder is unavailable, or None when it loaded (or was
    not tried yet)."""
    return _error


def _arrays(bufs: List[bytes]):
    n = len(bufs)
    return (ctypes.c_char_p * n)(*bufs), (ctypes.c_size_t * n)(
        *[len(b) for b in bufs])


def probe(buf: bytes) -> Optional[Tuple[int, int, int, int]]:
    """(h, w, channels, bit_depth) of an encoded image, or None."""
    lib = get_lib()
    if lib is None:
        return None
    h, w, c, bd = (ctypes.c_int() for _ in range(4))
    rc = lib.tpudepth_probe(buf, len(buf), ctypes.byref(h), ctypes.byref(w),
                            ctypes.byref(c), ctypes.byref(bd))
    if rc != 0:
        return None
    return h.value, w.value, c.value, bd.value


def decode_batch(bufs: List[bytes], h: int, w: int, c: int,
                 nthreads: int = 0) -> Optional[np.ndarray]:
    """Decode encoded JPEG/PNG buffers into float32 [n, h, w, c]; None on any
    failure (the caller decodes with Pillow)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(bufs)
    if nthreads <= 0:
        nthreads = min(n, os.cpu_count() or 8)
    out = np.empty((n, h, w, c), dtype=np.float32)
    arr_bufs, arr_sizes = _arrays(bufs)
    rc = lib.tpudepth_decode_batch(
        arr_bufs, arr_sizes, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), h, w, c, nthreads)
    return out if rc == 0 else None


def decode_batch_raw(bufs: List[bytes], h: int, w: int, c: int,
                     bit_depth: int, nthreads: int = 0,
                     scale_denom: int = 1) -> Optional[np.ndarray]:
    """Decode into raw integer pixels: uint8 [n,h,w,c] for 8-bit sources,
    uint16 for 16-bit PNG; the /255 and depth scaling run in the train step.

    ``scale_denom`` in {1,2,4,8}: (h, w) are the OUTPUT dims and files must
    be (h*s, w*s). JPEGs decode directly at 1/s by libjpeg's DCT scaling,
    PNGs average s x s boxes."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(bufs)
    if nthreads <= 0:
        nthreads = min(n, os.cpu_count() or 8)
    out = np.empty((n, h, w, c), dtype=np.uint16 if bit_depth == 16
                   else np.uint8)
    arr_bufs, arr_sizes = _arrays(bufs)
    rc = lib.tpudepth_decode_batch_raw_scaled(
        arr_bufs, arr_sizes, n, out.ctypes.data_as(ctypes.c_void_p),
        h, w, c, bit_depth, scale_denom, nthreads)
    return out if rc == 0 else None
