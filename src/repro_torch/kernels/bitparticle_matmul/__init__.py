"""BitParticle W8A8 matmul: CUDA kernel (``csrc/bp_matmul.cu``), its
wrapper (``ops.py``) and its plain PyTorch version (``ref.py``)."""

from repro_torch.kernels.bitparticle_matmul.ops import (LAUNCHES, bp_matmul,
                                                        kmajor,
                                                        reset_launches)

__all__ = ["LAUNCHES", "bp_matmul", "kmajor", "reset_launches"]
