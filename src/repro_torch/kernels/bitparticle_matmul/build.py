"""The BitParticle matmul CUDA library (``csrc/bp_matmul.cu``), built and
loaded on first use by the shared helper :mod:`repro_torch.kernels.build`."""

from __future__ import annotations

import ctypes
import pathlib

from repro_torch.kernels.build import CudaLibrary

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.bp_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [
        ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    fn = lib.bp_tile_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("bp_matmul", (CSRC / "bp_matmul.cu",), _bind)


def library() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    return LIBRARY.load()
