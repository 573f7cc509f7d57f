"""The paged-attention CUDA library (``csrc/paged_attention.cu``), built and
loaded on first use by the shared helper :mod:`repro_torch.kernels.build`."""

from __future__ import annotations

import ctypes
import pathlib

from repro_torch.kernels.build import CudaLibrary

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"


def _bind(lib: ctypes.CDLL) -> None:
    # the state variant takes three outputs where the other takes one
    for fn, n_ptr in ((lib.paged_attention_launch, 6),
                      (lib.paged_attention_state_launch, 8)):
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_float] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("paged_attention", (CSRC / "paged_attention.cu",),
                      _bind)


def library() -> ctypes.CDLL:
    """The loaded library (built on first call)."""
    return LIBRARY.load()
