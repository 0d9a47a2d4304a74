"""ctypes bindings for the native tile service (counterpart of
tpumil/utils/native.py; the service is ``native/tileservice.cc``, built by
``make -C native`` into ``native/build/libtileservice.so``): the batch JPEG
decoder, the JPEG encoder, the batched FIND_EDGES background energy, and
the libtiff pyramid reader and writer.

``available()`` is False when the library has not been built; the callers
then take their PIL paths, as the JAX package's do. This is host code, not
a device path.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Tuple

import numpy as np

_LIB = None
_LOCK = threading.Lock()


def _search_paths() -> List[str]:
    """The ``TPUMIL_TILESERVICE`` override first, then the repo's build;
    read at load time, not import time."""
    return [
        os.environ.get("TPUMIL_TILESERVICE", ""),
        os.path.join(os.path.dirname(__file__), "..", "..", "native", "build",
                     "libtileservice.so"),
    ]


def _bind(lib) -> None:
    c_int, c_void_p, c_char_p = ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p
    lib.ts_decode_batch.restype = c_int
    lib.ts_decode_batch.argtypes = [
        ctypes.POINTER(c_char_p), c_int, c_int, c_void_p, c_void_p, c_void_p,
        c_int, c_int]
    lib.ts_encode_jpeg.restype = c_int
    lib.ts_encode_jpeg.argtypes = [c_void_p, c_int, c_int, c_int, c_char_p]
    lib.ts_edge_energy.restype = None
    lib.ts_edge_energy.argtypes = [c_void_p, c_int, c_int, c_void_p, c_int]
    lib.ts_tiff_open.restype = c_void_p
    lib.ts_tiff_open.argtypes = [c_char_p]
    lib.ts_tiff_close.argtypes = [c_void_p]
    lib.ts_tiff_levels.restype = c_int
    lib.ts_tiff_levels.argtypes = [c_void_p]
    lib.ts_tiff_dims.argtypes = [c_void_p, c_int, c_void_p, c_void_p]
    lib.ts_tiff_read_region.restype = c_int
    lib.ts_tiff_read_region.argtypes = [
        c_void_p, c_int, c_int, c_int, c_int, c_int, c_void_p]
    lib.ts_tiff_description.restype = c_int
    lib.ts_tiff_description.argtypes = [c_void_p, c_char_p, c_int]
    # older builds of the service lack these two
    if hasattr(lib, "ts_tiff_is_tiled"):
        lib.ts_tiff_is_tiled.restype = c_int
        lib.ts_tiff_is_tiled.argtypes = [c_void_p, c_int]
    if hasattr(lib, "ts_write_tiled_pyramid"):
        lib.ts_write_tiled_pyramid.restype = c_int
        lib.ts_write_tiled_pyramid.argtypes = [
            c_char_p, c_void_p, c_int, c_int, c_int, c_int, c_int, c_char_p]


def _load():
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        for path in _search_paths():
            if path and os.path.exists(path):
                try:
                    lib = ctypes.CDLL(os.path.abspath(path))
                except OSError:
                    continue
                _bind(lib)
                _LIB = lib
                return lib
        _LIB = False
        return False


def _lib():
    lib = _load()
    if not lib:
        raise RuntimeError("native tile service not built (make -C native)")
    return lib


def available() -> bool:
    return bool(_load())


def can_write_pyramid() -> bool:
    """True iff the loaded library has the tiled-pyramid writer (older
    builds lack it)."""
    lib = _load()
    return bool(lib) and hasattr(lib, "ts_write_tiled_pyramid")


def decode_batch(paths: List[str], size: int, num_threads: int = 8,
                 as_float: bool = True,
                 allow_resize: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Decode JPEGs in parallel into [N, size, size, 3]. Returns (images,
    error codes [N]): float32 in [0, 1] if ``as_float``, else uint8.

    Unless ``allow_resize``, sources whose size differs from ``size`` are
    not resized natively (error -4): native bilinear point sampling differs
    from PIL's resampling, so callers re-decode those through PIL."""
    lib = _lib()
    num_threads = max(1, min(num_threads, os.cpu_count() or 1))
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.uint8)
    out_f = np.zeros((n, size, size, 3), np.float32) if as_float else None
    err = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.ts_decode_batch(arr, n, size, out.ctypes.data_as(ctypes.c_void_p),
                        None if out_f is None
                        else out_f.ctypes.data_as(ctypes.c_void_p),
                        err.ctypes.data_as(ctypes.c_void_p), num_threads,
                        1 if allow_resize else 0)
    return (out if out_f is None else out_f), err


def encode_jpeg(img: np.ndarray, path: str, quality: int = 70) -> None:
    lib = _lib()
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    rc = lib.ts_encode_jpeg(img.ctypes.data_as(ctypes.c_void_p), w, h,
                            quality, path.encode())
    if rc != 0:
        raise IOError(f"jpeg encode failed ({rc}): {path}")


def edge_energy_batch(imgs_u8: np.ndarray, num_threads: int = 8) -> np.ndarray:
    """FIND_EDGES background energies of [N, S, S, 3] uint8 images."""
    lib = _lib()
    imgs_u8 = np.ascontiguousarray(imgs_u8, np.uint8)
    n, s = imgs_u8.shape[0], imgs_u8.shape[1]
    out = np.zeros((n,), np.float32)
    lib.ts_edge_energy(imgs_u8.ctypes.data_as(ctypes.c_void_p), n, s,
                       out.ctypes.data_as(ctypes.c_void_p), num_threads)
    return out


def write_tiled_pyramid(path: str, img: np.ndarray, tile: int = 256,
                        levels: int = 3, quality: int = 75,
                        description: str = "") -> None:
    """Write a tiled, JPEG-compressed pyramidal TIFF (the layout of scanner
    files such as Aperio .svs) from a full-resolution RGB uint8 image."""
    lib = _load()
    if not lib or not hasattr(lib, "ts_write_tiled_pyramid"):
        raise RuntimeError("native tile service not built (make -C native)")
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape[:2]
    rc = lib.ts_write_tiled_pyramid(path.encode(),
                                    img.ctypes.data_as(ctypes.c_void_p),
                                    w, h, tile, levels, quality,
                                    description.encode())
    if rc != 0:
        raise IOError(f"tiled pyramid write failed ({rc}): {path}")


class NativeTiff:
    """Pyramidal TIFF reader backed by libtiff (tiled reads, no full-page
    decode)."""

    def __init__(self, path: str):
        lib = _lib()
        self._lib = lib
        # a libtiff handle is not thread-safe (directory switches and reads
        # race), so every call on it is serialized
        self._rlock = threading.Lock()
        self._h = lib.ts_tiff_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open TIFF {path}")
        self.level_count = lib.ts_tiff_levels(self._h)
        self.level_dimensions = []
        for lv in range(self.level_count):
            w, h = ctypes.c_int(), ctypes.c_int()
            lib.ts_tiff_dims(self._h, lv, ctypes.byref(w), ctypes.byref(h))
            self.level_dimensions.append((w.value, h.value))
        buf = ctypes.create_string_buffer(4096)
        n = lib.ts_tiff_description(self._h, buf, 4096)
        self.description = buf.value.decode(errors="replace") if n else ""
        self.is_tiled = bool(lib.ts_tiff_is_tiled(self._h, 0)) \
            if hasattr(lib, "ts_tiff_is_tiled") else True

    def read_region(self, level: int, x: int, y: int, w: int,
                    h: int) -> np.ndarray:
        out = np.empty((h, w, 3), np.uint8)  # ts_tiff_read_region clears it
        with self._rlock:
            if not self._h:
                raise IOError("TIFF handle closed")
            rc = self._lib.ts_tiff_read_region(
                self._h, level, x, y, w, h, out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise IOError(f"tiff read failed ({rc})")
        return out

    def close(self):
        with self._rlock:
            if self._h:
                self._lib.ts_tiff_close(self._h)
                self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
