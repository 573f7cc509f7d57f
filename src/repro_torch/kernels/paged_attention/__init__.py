"""Paged-attention decode: CUDA kernel and its state variant
(``csrc/paged_attention.cu``), their wrapper and mesh split (``ops.py``)
and their plain PyTorch versions (``ref.py``)."""

from repro_torch.kernels.paged_attention.ops import (LAUNCHES, ROUTED_PLAIN,
                                                     paged_attention,
                                                     paged_attention_state,
                                                     reset_launches)

__all__ = ["LAUNCHES", "ROUTED_PLAIN", "paged_attention",
           "paged_attention_state", "reset_launches"]
