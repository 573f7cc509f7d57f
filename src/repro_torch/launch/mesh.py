"""Meshes of shard devices (port of ``repro/launch/mesh.py``).

A :class:`Mesh` is a grid of shard devices with one named axis per
dimension, under one controller: the serving mesh is ``("data", "model")``
(:func:`make_local_mesh`), the pipeline's ``("model",)``, the production
meshes ``("data", "model")`` 16 x 16 and ``("pod", "data", "model")`` 2 x
16 x 16 (:func:`make_production_mesh`).  A sharded call launches once per
shard over that shard's slice, and the results meet on the home device,
the shard at index 0 of every axis.  Every shard of a mesh lies on one
device (the card, the CPU in the tests, or ``meta`` in the dry run); shards
on distinct devices would need peer copies or collectives between cards,
which are not ported, so such a mesh is refused.

The roofline constants below are the H100's datasheet figures.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

AXIS_NAMES = ("data", "model")


class Mesh:
    """A grid of ``torch.device`` shards with named axes."""

    def __init__(self, devices, axis_names: Sequence[str] = AXIS_NAMES):
        grid = np.empty(np.shape(devices), dtype=object)
        for idx, dev in np.ndenumerate(np.asarray(devices, dtype=object)):
            dev = torch.device(dev)
            if dev.type == "cuda" and dev.index is None:
                dev = torch.device("cuda", torch.cuda.current_device())
            grid[idx] = dev
        axis_names = tuple(axis_names)
        if grid.ndim != len(axis_names) or grid.size == 0:
            raise ValueError(f"a mesh is a non-empty grid of devices with "
                             f"one dimension per axis {axis_names}, got "
                             f"shape {grid.shape}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"mesh axis names repeat: {axis_names}")
        distinct = sorted({str(d) for d in grid.flat})
        if len(distinct) > 1:
            raise NotImplementedError(
                f"mesh shards on distinct devices {distinct}: collectives "
                f"between devices are not ported; place every shard on one "
                f"device")
        self.axis_names = axis_names
        self.devices = grid

    @property
    def shape(self) -> dict:
        """{axis name: size}."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return self.devices.size

    @property
    def home(self) -> torch.device:
        """The device where activations, caches and results live: the
        shard at index 0 of every axis."""
        return self.devices[(0,) * self.devices.ndim]

    def require_serving(self) -> "Mesh":
        """This mesh, if it is a ``("data", "model")`` grid, as the
        serving paths take; else a ``ValueError``."""
        if self.axis_names != AXIS_NAMES:
            raise ValueError(f"the serving paths take a ('data', 'model') "
                             f"mesh, got axes {self.axis_names}")
        return self

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


def make_mesh(shape: Sequence[int], axis_names: Sequence[str],
              device="cuda") -> Mesh:
    """A mesh of ``shape`` with every shard on ``device``."""
    shape = tuple(int(d) for d in shape)
    if any(d < 1 for d in shape):
        raise ValueError(f"mesh axes must be positive, got {shape}")
    grid = np.empty(shape, dtype=object)
    dev = torch.device(device)
    for idx in np.ndindex(*shape):
        grid[idx] = dev
    return Mesh(grid, axis_names)


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The production mesh: 16 x 16 ``("data", "model")``, or 2 x 16 x 16
    ``("pod", "data", "model")``, every shard on ``device`` (the dry run
    passes ``"meta"``)."""
    if multi_pod:
        return make_mesh((2, 16, 16), ("pod", "data", "model"), device)
    return make_mesh((16, 16), AXIS_NAMES, device)


# Roofline denominators: NVIDIA H100 80GB HBM3 (SXM5), 700 W, datasheet
# figures per card (dense tensor-core rates, no sparsity)
PEAK_FLOPS_BF16 = 989.4e12      # FLOP/s
PEAK_FLOPS_INT8 = 1978.9e12     # OP/s
HBM_BW = 3.35e12                # bytes/s
NVLINK_BW = 900e9               # bytes/s, NVLink 4 (18 links), per card
HBM_PER_CHIP = 80 * 2 ** 30     # bytes (five 16 GiB HBM3 stacks)
