"""PyTorch / CUDA port of the BitParticle reproduction.

Mirrors the layout of the JAX package ``repro`` (``configs/``, ``core/``,
``kernels/``, ``models/``, ``serving/``) so each module has an obvious
counterpart there.  The package imports ``torch``, numpy and the standard
library only.  Entry points run on the GPU (``device="cuda"``) unless the
caller asks for ``device="cpu"``; on the CPU every kernel wrapper runs its
plain PyTorch version instead of the CUDA kernel.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
