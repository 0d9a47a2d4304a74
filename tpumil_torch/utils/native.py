"""ctypes binding to the native tile service's batch JPEG decoder
(counterpart of tpumil/utils/native.py, decode only; the service is
``native/tileservice.cc``, built by ``make -C native`` into
``native/build/libtileservice.so``).

``available()`` is False when the library has not been built; the patch
loader then decodes with PIL, as the JAX package's does. This is host
decode, not a device path.
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
                lib.ts_decode_batch.restype = ctypes.c_int
                lib.ts_decode_batch.argtypes = [
                    ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int]
                _LIB = lib
                return lib
        _LIB = False
        return False


def available() -> bool:
    return bool(_load())


def decode_batch(paths: List[str], size: int,
                 num_threads: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Decode JPEGs in parallel into uint8 [N, size, size, 3]. Returns
    (images, error codes [N]).

    Sources whose size differs from ``size`` are not resized natively
    (error -4): native bilinear point sampling differs from PIL's
    resampling, so callers re-decode those through PIL."""
    lib = _load()
    if not lib:
        raise RuntimeError("native tile service not built (make -C native)")
    num_threads = max(1, min(num_threads, os.cpu_count() or 1))
    n = len(paths)
    out = np.zeros((n, size, size, 3), np.uint8)
    err = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.ts_decode_batch(arr, n, size, out.ctypes.data_as(ctypes.c_void_p),
                        None, err.ctypes.data_as(ctypes.c_void_p),
                        num_threads, 0)
    return out, err
