"""ctypes bindings for the native (C++) volume loader (counterpart of
octcubem_tpu/native/__init__.py).

``volume_loader.cpp`` decodes a volume's PNG frames in parallel threads
(libpng), with PIL's grayscale conversion, 1024 -> 512 downsample and
/255, so its output equals ``data/ingest.py``'s PIL path.  It is built
with ``g++ ... -lpng -lz`` at first use into the port's build directory
(``ops/_cuda.build_dir()``: ``build/octcubem_tpu_torch/`` in a checkout,
git-ignored), named by a hash of the source and flags, never beside its
source.  When the toolchain or libpng is missing the build fails once
and every caller falls back to PIL.  This is host decoding, not a
device path: nothing here touches the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "volume_loader.cpp"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
LIBS = ("-lpng", "-lz")

_lib = None
_build_failed = False
_lock = threading.Lock()


def lib_path() -> Path:
    """Where the library is built: keyed on the source and the flags."""
    from ..ops._cuda import build_dir

    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return build_dir() / f"libvolume_loader_{h.hexdigest()[:16]}.so"


def _build() -> Path:
    out = lib_path()
    if not out.exists():
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is None:
            raise RuntimeError("no C++ compiler (g++ or $CXX)")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                       check=True, capture_output=True)
        os.replace(tmp, out)
    return out


def _get_lib():
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
            lib.octcubem_png_dims.argtypes = [
                ctypes.c_char_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
            lib.octcubem_png_dims.restype = ctypes.c_int
            lib.octcubem_load_png_stack.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_float)]
            lib.octcubem_load_png_stack.restype = ctypes.c_int
            _lib = lib
        except (OSError, RuntimeError, subprocess.CalledProcessError):
            _build_failed = True
        return _lib


def available() -> bool:
    return _get_lib() is not None


def load_png_stack_native(paths: list[str], downsample_width: bool = True,
                          n_threads: int = 8) -> np.ndarray | None:
    """[T, H, W] float32 in [0, 1], or None if the native path is
    unavailable or a frame fails to decode (caller falls back to PIL)."""
    lib = _get_lib()
    if lib is None or not paths:
        return None
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.octcubem_png_dims(paths[0].encode(), int(downsample_width),
                             ctypes.byref(h), ctypes.byref(w)) != 0:
        return None
    out = np.empty((len(paths), h.value, w.value), np.float32)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.octcubem_load_png_stack(
        arr, len(paths), h.value, w.value, int(downsample_width), n_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        return None
    return out
