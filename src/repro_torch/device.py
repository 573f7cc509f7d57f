"""Device selection shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = "cuda"
                   ) -> torch.device:
    """The ``torch.device`` an entry point runs on.

    The default is the GPU.  Asking for CUDA on a machine without one raises
    instead of quietly running on the CPU: a caller that wants the CPU (the
    parity tests) says ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
