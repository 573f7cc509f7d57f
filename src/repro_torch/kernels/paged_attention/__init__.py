"""Paged-attention decode: CUDA kernel (``csrc/paged_attention.cu``), its
wrapper (``ops.py``) and its plain PyTorch version (``ref.py``)."""

from repro_torch.kernels.paged_attention.ops import (LAUNCHES, ROUTED_PLAIN,
                                                     paged_attention,
                                                     reset_launches)

__all__ = ["LAUNCHES", "ROUTED_PLAIN", "paged_attention", "reset_launches"]
