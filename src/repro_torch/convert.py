"""Weight bridge: the reference's parameter tree (nested dicts of numpy
arrays) -> the port's parameters, so both packages compute the same
function on the same weights.

The tree keeps the reference's structure and names, including the
scan-stacked leading L axis of every layer leaf and, after
``quantize_dense_params``, the int8 ``w`` with its float32 ``w_scale`` of
shape (..., N).  int8 dense weights come out K-major (the layout the CUDA
kernel takes).  bf16 arrays arrive with the ``ml_dtypes`` bfloat16 dtype,
which ``torch.from_numpy`` refuses: they are reinterpreted through int16.
This module does not import JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.bitparticle_matmul.ops import kmajor


def tensor_from_numpy(arr, device) -> torch.Tensor:
    """One array -> tensor on ``device`` (bf16 kept bf16, bit for bit)."""
    arr = np.array(arr, copy=True)   # writable: np.asarray of a jax array is not
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree, device="cuda"):
    """Nested dicts of numpy arrays -> nested dicts of tensors."""
    dev = resolve_device(device)

    def rec(node, key=None):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        t = tensor_from_numpy(node, dev)
        if key == "w" and t.dtype == torch.int8:
            t = kmajor(t)
        return t

    return rec(tree)
