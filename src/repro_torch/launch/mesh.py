"""The serving mesh (port of ``repro/launch/mesh.py::make_local_mesh``).

A :class:`Mesh` is a ``(data, model)`` grid of shard devices under one
controller: a sharded kernel call launches once per shard over that shard's
slice, and the results meet on the home device, ``devices[0, 0]``.  Every
shard of a mesh lies on one device (the card, or the CPU in the tests);
shards on distinct devices would need peer copies or collectives between
cards, which are not ported, so such a mesh is refused.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

AXIS_NAMES = ("data", "model")


class Mesh:
    """A ``(data, model)`` grid of ``torch.device`` shards."""

    axis_names = AXIS_NAMES

    def __init__(self, devices):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx, dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            dev = torch.device(dev)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            grid[idx] = dev
        if grid.ndim != 2 or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty (data, model) grid of "
                             f"devices, got shape {grid.shape}")
        distinct = sorted({str(d) for d in grid.flat})
        if len(distinct) > 1:
            raise NotImplementedError(
                f"mesh shards on distinct devices {distinct}: collectives "
                f"between devices are not ported; place every shard on one "
                f"device")
        self.devices = grid

    @property
    def shape(self) -> dict:
        """{axis name: size}."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def home(self) -> torch.device:
        """The device where activations, caches and results live."""
        return self.devices[0, 0]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, home={self.home})"


def make_local_mesh(data: int = 1, model: int = 1,
                    devices: Optional[Sequence] = None) -> Mesh:
    """A ``data x model`` mesh over ``devices`` (row-major, data outer),
    by default the first ``data * model`` CUDA devices.  To put several
    shards on one card pass it that many times, e.g. ``[torch.device(
    "cuda:0")] * 4`` for a 2 x 2 mesh; the CPU tests pass ``["cpu"] * n``."""
    n = data * model
    if data < 1 or model < 1:
        raise ValueError(f"mesh axes must be positive, got ({data}, {model})")
    if devices is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < n:
            raise ValueError(
                f"a ({data}, {model}) mesh needs {n} CUDA devices, found "
                f"{found}; pass devices= to place the shards (several on "
                f"one device, or on 'cpu')")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = list(devices)
    if len(devices) != n:
        raise ValueError(f"a ({data}, {model}) mesh takes {n} devices, got "
                         f"{len(devices)}")
    grid = np.empty((data, model), dtype=object)
    for i, dev in enumerate(devices):
        grid[i // model, i % model] = dev
    return Mesh(grid)
