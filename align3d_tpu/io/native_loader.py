"""ctypes bindings for the native C++ frame loader (native/loader.cpp).

Provides fast libpng/libjpeg decode and a multithreaded prefetching frame
pipeline so the host keeps the device fed during odometry. Falls back
gracefully: :func:`available` is False when the shared library has not been
built (``make -C native``) or cannot load, and callers (dataset loaders)
decode in Python instead.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "liba3d_loader.so",
)

_lib: Optional[ctypes.CDLL] = None
_unavailable = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _unavailable
    if _lib is not None:
        return _lib
    if _unavailable:
        return None
    lib = _open_library()
    if lib is None:
        _unavailable = True  # one build/load attempt per process
    return lib


def _open_library() -> Optional[ctypes.CDLL]:
    global _lib
    if not os.path.exists(_LIB_PATH):
        # Try a one-shot build if the toolchain is present.
        src_dir = os.path.dirname(_LIB_PATH)
        if os.path.exists(os.path.join(src_dir, "Makefile")):
            try:
                subprocess.run(
                    ["make", "-C", src_dir],
                    check=True,
                    capture_output=True,
                    timeout=120,
                )
            except Exception:
                return None
        if not os.path.exists(_LIB_PATH):
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None  # built elsewhere, or its libpng/libjpeg are missing here
    lib.a3d_decode_rgb.restype = ctypes.c_int
    lib.a3d_decode_rgb.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.a3d_decode_depth_png.restype = ctypes.c_int
    lib.a3d_decode_depth_png.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.a3d_free.argtypes = [ctypes.c_void_p]
    lib.a3d_loader_create.restype = ctypes.c_void_p
    lib.a3d_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.a3d_loader_get.restype = ctypes.c_int
    lib.a3d_loader_get.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int,
    ] + [ctypes.POINTER(ctypes.c_int)] * 4
    lib.a3d_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def decode_rgb(path: str) -> np.ndarray:
    """Decode a PNG/JPEG into (H, W, 3) u8."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader not built (make -C native)")
    data = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.a3d_decode_rgb(path.encode(), ctypes.byref(data), ctypes.byref(w), ctypes.byref(h))
    if rc != 0:
        raise IOError(f"native rgb decode failed for {path}")
    try:
        arr = np.ctypeslib.as_array(data, shape=(h.value, w.value, 3)).copy()
    finally:
        lib.a3d_free(data)
    return arr


def decode_depth(path: str) -> np.ndarray:
    """Decode a 16-bit grayscale PNG into (H, W) u16."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native loader not built (make -C native)")
    data = ctypes.POINTER(ctypes.c_uint16)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    rc = lib.a3d_decode_depth_png(
        path.encode(), ctypes.byref(data), ctypes.byref(w), ctypes.byref(h)
    )
    if rc != 0:
        raise IOError(f"native depth decode failed for {path}")
    try:
        arr = np.ctypeslib.as_array(data, shape=(h.value, w.value)).copy()
    finally:
        lib.a3d_free(data)
    return arr


class PrefetchLoader:
    """Decode-ahead frame pipeline over (color_path, depth_path) pairs.

    A C++ worker pool decodes ``prefetch`` frames ahead of the last consumed
    index; ``get`` blocks only if the frame is not ready yet. Designed for
    the sequential odometry access pattern.
    """

    def __init__(
        self,
        color_paths: Sequence[str],
        depth_paths: Sequence[str],
        max_width: int = 1920,
        max_height: int = 1080,
        n_threads: int = 4,
        prefetch: int = 8,
    ):
        lib = _load()
        if lib is None:
            raise RuntimeError("native loader not built (make -C native)")
        if len(color_paths) != len(depth_paths):
            raise ValueError("color/depth path lists must have equal length")
        self._lib = lib
        self._n = len(color_paths)
        c_arr = (ctypes.c_char_p * self._n)(*[p.encode() for p in color_paths])
        d_arr = (ctypes.c_char_p * self._n)(*[p.encode() for p in depth_paths])
        self._handle = lib.a3d_loader_create(c_arr, d_arr, self._n, n_threads, prefetch)
        self._ccap = max_width * max_height * 3
        self._dcap = max_width * max_height
        self._cbuf = np.empty(self._ccap, np.uint8)
        self._dbuf = np.empty(self._dcap, np.uint16)

    def __len__(self) -> int:
        return self._n

    def get(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        cw = ctypes.c_int()
        ch = ctypes.c_int()
        dw = ctypes.c_int()
        dh = ctypes.c_int()
        rc = self._lib.a3d_loader_get(
            self._handle,
            idx,
            self._cbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._ccap,
            self._dbuf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
            self._dcap,
            ctypes.byref(cw),
            ctypes.byref(ch),
            ctypes.byref(dw),
            ctypes.byref(dh),
        )
        if rc != 0:
            raise IOError(f"native loader_get({idx}) failed with code {rc}")
        color = self._cbuf[: ch.value * cw.value * 3].reshape(ch.value, cw.value, 3).copy()
        depth = self._dbuf[: dh.value * dw.value].reshape(dh.value, dw.value).copy()
        return color, depth

    def close(self) -> None:
        if self._handle:
            self._lib.a3d_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
