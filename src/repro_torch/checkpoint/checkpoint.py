"""Atomic, asynchronous checkpoints in the reference's on-disk format
(port of ``repro/checkpoint/checkpoint.py``).

Layout (one directory per step):

    <dir>/step_000000123.tmp/       (being written)
    <dir>/step_000000123/           (atomic rename = commit)
        MANIFEST.json               {step, leaves: [{path, file, shape,
                                     dtype, stored_dtype, crc}]}
        arr_00000.npy ...           one file per leaf

Leaves are taken in the reference's flattening order and named by their
``/``-joined dict keys (``repro_torch.tree``); bf16 is stored as a
``uint16`` view with the logical dtype in the manifest, and each leaf's
CRC32 is taken over its stored bytes.  A checkpoint either package writes,
the other restores, bit for bit.  Saves copy the tree to host memory
first (so training may go on mutating it) and write in a daemon thread;
``wait()`` joins before the next save or exit.  The newest ``keep``
checkpoints are kept; ``.tmp`` directories are ignored by discovery, so a
save cut short is never resumed from.  ``restore`` places the leaves on a
given device (the reference takes JAX shardings).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.tree import leaf_paths, unflatten

_STEP_RE = re.compile(r"^step_(\d{9})$")
#: the manifest's logical dtype names (numpy's, as the reference writes)
_DTYPE_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
                torch.float16: "float16", torch.float64: "float64",
                torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64",
                torch.uint8: "uint8", torch.bool: "bool"}
_TORCH_DTYPES = {name: dt for dt, name in _DTYPE_NAMES.items()}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as the array the reference would store."""
    host = t.detach().to("cpu", copy=True)
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(np.uint16)
    return host.numpy()


def _whole(leaf) -> torch.Tensor:
    """A leaf placed on a mesh (``distributed.sharding.Placed``) gathered
    whole, as the reference's host copy gathers a sharded array."""
    return leaf if isinstance(leaf, torch.Tensor) else leaf.gather()


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B"))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- discovery ---------------------------------------------------------
    def all_steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.match(name)
            if m and os.path.exists(os.path.join(self.directory, name,
                                                 "MANIFEST.json")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, tree: Any, blocking: Optional[bool] = None):
        """Copy ``tree`` (nested dicts of tensors, or of leaves placed on a
        mesh, each gathered first) to host memory, then write it, in a
        daemon thread unless ``blocking``."""
        self.wait()
        host = [(path, _DTYPE_NAMES[leaf.dtype], _to_numpy(_whole(leaf)))
                for path, leaf in leaf_paths(tree)]
        if blocking is None:
            blocking = not self.async_save
        if blocking:
            self._write(step, host)
        else:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()

    def _write(self, step: int, host):
        name = f"step_{step:09d}"
        tmp = os.path.join(self.directory, name + ".tmp")
        final = os.path.join(self.directory, name)
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": []}
        for i, (path, dtype, stored) in enumerate(host):
            fname = f"arr_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), stored)
            manifest["leaves"].append({
                "path": path, "file": fname, "shape": list(stored.shape),
                "dtype": dtype, "stored_dtype": str(stored.dtype),
                "crc": _crc(stored),
            })
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)                      # atomic commit
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:09d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- restore -----------------------------------------------------------
    def restore(self, step: int, like: Any, device=None,
                verify_crc: bool = True) -> Any:
        """Restore into the structure, shapes and dtypes of ``like``, each
        leaf on ``device`` (default: the device of ``like``'s leaf).
        Raises ``IOError`` on a CRC mismatch."""
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "MANIFEST.json")) as f:
            manifest = json.load(f)
        by_path = {e["path"]: e for e in manifest["leaves"]}
        out = []
        for key, leaf in leaf_paths(like):
            entry = by_path[key]
            arr = np.load(os.path.join(d, entry["file"]))
            if verify_crc and _crc(arr) != entry["crc"]:
                raise IOError(f"checkpoint corruption in {key}")
            if list(arr.shape) != list(leaf.shape):
                raise ValueError(f"{key}: checkpoint shape {arr.shape}, "
                                 f"expected {tuple(leaf.shape)}")
            if _TORCH_DTYPES[entry["dtype"]] == torch.bfloat16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr)
            out.append(t.to(device=leaf.device if device is None else device,
                            dtype=leaf.dtype))
        return unflatten(like, out)
