"""Build and load the port's CUDA libraries.

Each kernel's ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs on first use, never at import, into ``build/repro_torch/`` at the root
of the checkout (listed in ``.gitignore``); the file name carries the
kernel's name and a hash of its sources, so an edited source is rebuilt and
a stale library is never loaded.  There is no fallback: a failed build
raises.

One :class:`CudaLibrary` per kernel keeps its own loaded handle and its own
``last_build_s`` / ``last_build_log``.  Building several at once is safe:
each call runs its own ``nvcc`` process, and ``subprocess.run`` releases the
interpreter lock while it waits.
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
from typing import Callable, Optional, Sequence

#: <checkout>/build/repro_torch (this file is
#: <checkout>/src/repro_torch/kernels/build.py)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be "
                       "built on this machine")


class KernelError(RuntimeError):
    """A hand-written kernel could not run: its launch failed, or it was
    asked for where it cannot run.  The serving path never retries,
    recovers from or hides it: it raises out of the serve."""


class KernelInputError(KernelError, ValueError):
    """The ``kernel`` backend asked for on tensors the kernel cannot take
    (CPU tensors): a caller's error as well as a kernel fault."""


class CudaLibrary:
    """One kernel's shared library: built on first :meth:`load`, then
    bound by ``bind(lib)`` (which sets ``argtypes``/``restype``)."""

    def __init__(self, name: str, sources: Sequence[pathlib.Path],
                 bind: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.sources = tuple(sources)
        self._bind = bind
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        #: seconds the last build took (0.0 when the library was on disk)
        self.last_build_s: Optional[float] = None
        #: nvcc's output of the last build (``-Xptxas -v``: registers,
        #: spills)
        self.last_build_log: str = ""

    def source_hash(self) -> str:
        h = hashlib.sha256()
        for src in self.sources:
            h.update(src.read_bytes())
        h.update(" ".join(ARCH_FLAGS).encode())
        return h.hexdigest()[:16]

    def path(self) -> pathlib.Path:
        return BUILD_DIR / f"lib{self.name}_{self.source_hash()}.so"

    def build(self) -> pathlib.Path:
        """Compile the library if it is not on disk; returns its path."""
        out = self.path()
        if out.exists():
            self.last_build_s = 0.0
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               *map(str, self.sources)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        self.last_build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed on {self.name} "
                               f"({proc.returncode}):\n{self.last_build_log}")
        os.replace(tmp, out)
        self.last_build_s = time.perf_counter() - t0
        return out

    def load(self) -> ctypes.CDLL:
        """The loaded library (built on first call)."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._bind(lib)
                self._lib = lib
            return self._lib
