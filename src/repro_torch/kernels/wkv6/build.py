"""The WKV6 CUDA library (``csrc/wkv6.cu``), built and loaded on first use
by the shared helper :mod:`repro_torch.kernels.build`."""

from __future__ import annotations

import ctypes
import pathlib

from repro_torch.kernels.build import CudaLibrary

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.wkv6_launch
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("wkv6", (CSRC / "wkv6.cu",), _bind)


def library() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    return LIBRARY.load()
