"""Build and load the package's hand-written CUDA kernels.

Every ``tpumil_torch/csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
ONE shared library with a plain C interface, loaded with ``ctypes``. No
source includes PyTorch's headers, so a build takes seconds, not minutes.
The library lands in ``build/tpumil_torch/`` at the repo root, named by a
hash of the sources' contents: a rebuild happens only when a source changes.

Nothing here runs at import time: the first kernel launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "tpumil_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash(srcs: List[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (on PATH or under $CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def build(verbose: bool = False) -> Tuple[Path, float, str]:
    """Compile the kernels unless a library for these exact sources exists.
    Returns ``(library path, build seconds (0 when cached), compiler log)``;
    ``verbose`` adds ``-Xptxas -v`` (registers, shared memory, spills)."""
    srcs = sources()
    lib_path = BUILD_DIR / f"libtpumil_kernels_{_source_hash(srcs)}.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (rc={proc.returncode}):\n{log}")
    os.replace(tmp, lib_path)  # atomic: another process never sees half a file
    return lib_path, seconds, log


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library once per process, with
    every entry point's ``argtypes`` / ``restype`` declared."""
    global _lib
    with _lock:
        if _lib is None:
            path, _, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            lib.tpumil_instance_norm.argtypes = [p, p, i, i, i, i, i,
                                                 ctypes.c_float, p]
            lib.tpumil_instance_norm.restype = i
            _lib = lib
        return _lib
