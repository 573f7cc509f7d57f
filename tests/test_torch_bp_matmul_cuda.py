"""The BitParticle matmul CUDA kernel against its plain version, on the card.

A CUDA kernel has no CPU or interpret mode, so these tests carry the
``cuda`` marker and skip where no GPU is present.  This file imports no JAX,
so that it also runs on a GPU machine without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_bp_matmul_cuda.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.bitparticle_matmul import ops

SHAPES = [(8, 128, 128), (16, 256, 384), (256, 256, 256), (5, 33, 17),
          (1, 128, 1), (300, 520, 260)]


def _rand_q(rng, shape):
    return torch.from_numpy(
        rng.integers(-127, 128, size=shape).astype(np.int8))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", SHAPES + [(4, 1536, 8960), (8, 8960, 1536)])
def test_kernel_matches_plain_on_card(cuda_device, m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = _rand_q(rng, (m, k)).to(cuda_device)
    w = ops.kmajor(_rand_q(rng, (k, n)).to(cuda_device))
    sa = torch.from_numpy(rng.uniform(0.01, 0.1, m).astype(
        np.float32)).to(cuda_device)
    sw = torch.from_numpy(rng.uniform(1e-3, 1e-2, n).astype(
        np.float32)).to(cuda_device)
    for approx in (False, True):
        ops.reset_launches()
        got_i = ops.bp_matmul(a, w, approx=approx)
        got_f = ops.bp_matmul(a, w, sa, sw, approx=approx)
        assert ops.LAUNCHES["bp_matmul"] == 2
        torch.cuda.synchronize()
        assert torch.equal(got_i, ops.bp_matmul(a, w, approx=approx,
                                                backend="plain"))
        assert torch.equal(got_f, ops.bp_matmul(a, w, sa, sw, approx=approx,
                                                backend="plain"))
