"""Build and load the package's hand-written CUDA kernels.

Every ``tpumil_torch/csrc/*.cu`` is compiled by its own ``nvcc`` for
``sm_90a`` (all started together), and the objects are linked into ONE
shared library with a plain C interface, loaded with ``ctypes``. No source
includes PyTorch's headers, so a build takes seconds, not minutes.
The library lands in ``build/tpumil_torch/`` at the repo root, named by a
hash of the sources' and headers' contents: a rebuild happens only when one
changes.

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
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _source_hash(srcs: List[Path]) -> str:
    """A hash of the flags, the sources and every ``*.cuh`` header beside
    them: the headers are not compiled on their own, but an edit to one
    must rebuild the sources that include it."""
    headers = sorted({h for d in {p.parent for p in srcs}
                      for h in d.glob("*.cuh")})
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [*srcs, *headers]:
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
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    nvcc = nvcc_path()
    ptxas = ["-Xptxas", "-v"] if verbose else []
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, *ptxas, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    log = "".join(logs)
    try:
        failed = [str(src) for src, proc in zip(srcs, procs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed (rc={proc.returncode}):\n{log}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
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
                                                 ctypes.c_float, i, i, p]
            lib.tpumil_instance_norm.restype = i
            lib.tpumil_attention_pool_fwd_scratch.argtypes = [i] * 5
            lib.tpumil_attention_pool_fwd_scratch.restype = ctypes.c_longlong
            lib.tpumil_attention_pool_fwd_bf16_scratch.argtypes = [i] * 6
            lib.tpumil_attention_pool_fwd_bf16_scratch.restype = ctypes.c_longlong
            lib.tpumil_attention_pool_fwd_bf16_smem.argtypes = [i]
            lib.tpumil_attention_pool_fwd_bf16_smem.restype = ctypes.c_longlong
            lib.tpumil_attention_pool_fwd_bf16.argtypes = [p] * 6 + [i] * 6 + [p] * 6
            lib.tpumil_attention_pool_fwd_bf16.restype = i
            lib.tpumil_attention_pool_bwd1_scratch.argtypes = [i] * 4
            lib.tpumil_attention_pool_bwd1_scratch.restype = ctypes.c_longlong
            lib.tpumil_attention_pool_bwd2_size.argtypes = [i, i]
            lib.tpumil_attention_pool_bwd2_size.restype = ctypes.c_longlong
            lib.tpumil_attention_pool_bwd2_scratch.argtypes = [i] * 6
            lib.tpumil_attention_pool_bwd2_scratch.restype = ctypes.c_longlong
            lib.tpumil_attention_pool_fwd.argtypes = [p] * 6 + [i] * 5 + [p] * 6
            lib.tpumil_attention_pool_fwd.restype = i
            lib.tpumil_attention_pool_bwd1.argtypes = [p] * 5 + [i] * 4 + [p] * 3
            lib.tpumil_attention_pool_bwd1.restype = i
            lib.tpumil_attention_pool_bwd2.argtypes = [p] * 10 + [i] * 6 + [p] * 4
            lib.tpumil_attention_pool_bwd2.restype = i
            lib.tpumil_stem_scratch.argtypes = [i, i]
            lib.tpumil_stem_scratch.restype = ctypes.c_longlong
            lib.tpumil_stem.argtypes = [p] * 4 + [i] * 2 + [ctypes.c_float, p]
            lib.tpumil_stem.restype = i
            lib.tpumil_depthwise_band.argtypes = (
                [i] * 4 + [p, i, i, i, p, p] + [i] * 7
                + [p, p, i, p, i, i] + [p] * 5 + [i] * 4 + [p, i, p])
            lib.tpumil_depthwise_band.restype = i
            lib.tpumil_depthwise_rows_wgrad.argtypes = (
                [p, i, i, p] + [i] * 5 + [p, p])
            lib.tpumil_depthwise_rows_wgrad.restype = i
            lib.tpumil_depthwise_reduce.argtypes = (
                [p] + [i] * 6 + [p, p, i, p, i] + [p] * 4)
            lib.tpumil_depthwise_reduce.restype = i
            _lib = lib
        return _lib
