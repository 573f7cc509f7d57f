"""Build and load the BitParticle matmul CUDA library.

``nvcc`` compiles ``csrc/bp_matmul.cu`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``.  The build runs on
first use, never at import, into ``build/repro_torch/`` at the root of the
checkout (listed in ``.gitignore``); the file name carries a hash of the
source, so an edited source is rebuilt and a stale library is never loaded.
There is no fallback: a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "bp_matmul.cu",)
#: <checkout>/build/repro_torch (this file is
#: <checkout>/src/repro_torch/kernels/bitparticle_matmul/build.py)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[4] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when the library was already on disk)
last_build_s: Optional[float] = None
#: nvcc's output of the last build (``-Xptxas -v``: registers, spills)
last_build_log: str = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the BitParticle CUDA kernel cannot "
                       "be built on this machine")


def _source_hash() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_DIR / f"libbp_matmul_{_source_hash()}.so"


def build() -> pathlib.Path:
    """Compile the library if it is not on disk; returns its path."""
    global last_build_s, last_build_log
    out = library_path()
    if out.exists():
        last_build_s = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
           *map(str, SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    last_build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{last_build_log}")
    os.replace(tmp, out)
    last_build_s = time.perf_counter() - t0
    return out


def library() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.bp_matmul_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
