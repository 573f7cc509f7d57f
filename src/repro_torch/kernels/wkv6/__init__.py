"""Chunked RWKV-6 WKV recurrence: CUDA kernel (``csrc/wkv6.cu``), its
wrapper (``ops.py``) and its plain PyTorch version (``ref.py``)."""

from repro_torch.kernels.wkv6.ops import (LAUNCHES, reset_launches, wkv6,
                                          wkv6_rows)

__all__ = ["LAUNCHES", "reset_launches", "wkv6", "wkv6_rows"]
