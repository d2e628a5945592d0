"""ctypes binding of the native host runtime ``native/hgr_native.cpp``
(port of hgr_tpu/data/native.py): libjpeg decode and a thread pool that
decodes and stages a whole batch into caller-owned numpy buffers with the
GIL released.

The library is built from the repository's source at first use, with
``g++ -O3 -fPIC -shared -std=c++17 -march=native ... -ljpeg -lpthread``
(the flags of ``native/build.sh``), into ``build/native/`` at the
repository root (listed in ``.gitignore``), named by a hash of the source
and the flags. Where it cannot be built or loaded (no compiler, no
libjpeg headers or library), ``available()`` is False and every call
returns None; the loader then decodes with PIL. This is host data code,
not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "hgr_native.cpp"
BUILD_DIR = SOURCE.parents[1] / "build" / "native"
CXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17", "-march=native"]
LINK_FLAGS = ["-ljpeg", "-lpthread"]

_lib: Optional[ctypes.CDLL] = None
_tried = False
_lock = threading.Lock()


def _build() -> Optional[Path]:
    """Compile the library if no build of this source exists; its path,
    or None when it cannot be built."""
    if not SOURCE.exists():
        return None
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(
        CXX_FLAGS + LINK_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"libhgr_native-{digest}.so"
    if lib_path.exists():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp),
                           *LINK_FLAGS], capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, lib_path)  # atomic: readers see whole files
    return lib_path


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:  # e.g. a build copied from a host with libjpeg
            return None
        u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(
            ctypes.c_int)
        lib.hgr_decode_jpeg.restype = ctypes.c_int
        lib.hgr_decode_jpeg.argtypes = [ctypes.c_char_p, u8p, ctypes.c_int64,
                                        i32p, i32p]
        lib.hgr_decode_jpeg_mem.restype = ctypes.c_int
        lib.hgr_decode_jpeg_mem.argtypes = [u8p, ctypes.c_int64, u8p,
                                            ctypes.c_int64, i32p, i32p]
        lib.hgr_stage_batch2.restype = ctypes.c_int
        lib.hgr_stage_batch2.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, u8p, ctypes.c_int,
            ctypes.c_float, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), u8p, ctypes.c_int]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (builds it once)."""
    return _load() is not None


_MAX_SIDE = 4096


def _decode(call) -> Optional[np.ndarray]:
    """One libjpeg decode ``call(out_ptr, cap, &w, &h) -> rc`` into a
    scratch buffer; the (H, W, 3) BGR copy, or None on failure."""
    cap = _MAX_SIDE * _MAX_SIDE * 3
    buf = np.empty((cap,), np.uint8)
    w, h = ctypes.c_int(0), ctypes.c_int(0)
    rc = call(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap,
              ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        return None
    return buf[: h.value * w.value * 3].reshape(h.value, w.value, 3).copy()


def decode_jpeg_bgr(path: str) -> Optional[np.ndarray]:
    """Decode one JPEG file to BGR uint8 (H, W, 3); None on failure or
    when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    return _decode(lambda out, cap, w, h: lib.hgr_decode_jpeg(
        path.encode(), out, cap, w, h))


def decode_jpeg_bgr_bytes(data: bytes) -> Optional[np.ndarray]:
    """Decode an in-memory JPEG to BGR uint8 (H, W, 3); None on failure or
    when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, np.uint8)
    return _decode(lambda out, cap, w, h: lib.hgr_decode_jpeg_mem(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data), out,
        cap, w, h))


def stage_batch(
    paths: List[str],
    canvas_size: int,
    num_threads: int = 4,
    out_canvases: Optional[np.ndarray] = None,
    out_affines: Optional[np.ndarray] = None,
    out_sizes: Optional[np.ndarray] = None,
    window_frac: float = 0.75,
) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Decode and stage a whole batch natively: (canvases (N, S, S, 3)
    uint8, affines (N, 2, 3) f32, sizes_hw (N, 2) f32, ok (N,) uint8), or
    None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    canvases = out_canvases if out_canvases is not None else np.empty(
        (n, canvas_size, canvas_size, 3), np.uint8)
    affines = out_affines if out_affines is not None else np.empty(
        (n, 2, 3), np.float32)
    sizes = out_sizes if out_sizes is not None else np.empty(
        (n, 2), np.float32)
    ok = np.empty((n,), np.uint8)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.hgr_stage_batch2(
        c_paths, n, canvases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        canvas_size, window_frac,
        affines.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), num_threads)
    return canvases, affines, sizes, ok
